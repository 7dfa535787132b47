"""pyfft_tpu — a spectral-analysis framework for accelerators (JAX/XLA).

A from-scratch JAX/XLA re-design of the capability set of the
reference ``PYFFT`` package (Welch auto-/cross-spectral estimation, window
suite with recommended-overlap metadata, STFT/spectrograms, FIR/IIR filtering
and resampling, Hilbert and Laplace transforms, correlation tools,
Doppler/center-of-gravity analysis, PCA, heat-pulse transport analysis), with

* a batched, jit-compiled compute core (no per-segment Python loops),
* ``jnp.fft`` transforms (cuFFT on the GPU), plus real-pair matmul DFTs
  (``pyfft_tpu.ops``) on request,
* multi-chip scaling via ``jax.sharding`` + ``shard_map`` with ppermute halo
  exchange and psum averaging (``pyfft_tpu.parallel``).
"""

__version__ = "0.1.0"

from . import utils
# `windows` is a CALLABLE MODULE (see windows.py tail): calling
# `pyfft_tpu.windows('hanning', ...)` dispatches like the reference's
# bare function, while `import pyfft_tpu.windows` / attribute access
# exposes the full window library (the old function re-export shadowed
# the submodule).  `windows_mod` stays as the documented alias.
from . import windows
from . import windows as windows_mod
from .windows import get_window
from . import segmentation
from .spectral import (
    fft_pwelch,
    fftinfosc,
    Cxy_Cxy2,
    welch_cross_spectra,
    welch_filtered_cross_spectra,
    resolve_fft_backend,
    backend_supports_complex,
)
from .fftanal import fftanal, stft_segments
from . import ops
from . import spectrogram as spectrogram
from .spectrogram import stft, specgram
from . import hilbert as hilbert_mod
from .hilbert import hilbert, hilbert_1d
from . import laplace as laplace_mod
from .laplace import laplace, laplace_1d
from . import filters
from .filters import (
    butter_lowpass_filter,
    butter_bandpass,
    upsample,
    downsample,
    downsample_efficient,
)
from . import notch
from .notch import iirnotch, iirpeak
from .deriv import fft_deriv
from . import fft_analysis as fft
from . import integrate
from .integrate import (
    integratespectra,
    getNpeaks,
    varcoh,
    varphi,
    monticoh,
    montiphi,
    mean_angle,
    unwrap_tol,
)
from . import ccf as ccf_mod
from .ccf import ccf, ccf_sh, align_signals
from . import doppler
from .doppler import cog, cogspec
from . import pca
from .pca import PCA, basic_pca
from . import heatpulse
from .heatpulse import HeatPulseFFT
from . import streaming
from .streaming import StreamingWelch
from . import io
from .io import ShotLoader
from . import multitaper
from .multitaper import multitaper_psd, multitaper_csd
from . import wavelet
# the reference's optional pycwt slot (reference __init__.py:38-42)
pycwt = wavelet
from . import config
from .config import SpectralConfig, welch_psd
from . import dft as dft_mod
from . import crosscheck
from .crosscheck import coh, coh2, psd, csd, fft_pmlab
from .utils.detrend import (
    detrend_none,
    detrend_mean,
    detrend_linear,
)

__all__ = [
    "windows",
    "get_window",
    "fftanal",
    "stft_segments",
    "ops",
    "spectrogram",
    "stft",
    "specgram",
    "hilbert",
    "hilbert_1d",
    "laplace",
    "laplace_1d",
    "filters",
    "notch",
    "iirnotch",
    "iirpeak",
    "fft_deriv",
    "butter_lowpass_filter",
    "butter_bandpass",
    "upsample",
    "downsample",
    "downsample_efficient",
    "fft",
    "integrate",
    "integratespectra",
    "getNpeaks",
    "varcoh",
    "varphi",
    "monticoh",
    "montiphi",
    "mean_angle",
    "unwrap_tol",
    "ccf",
    "ccf_sh",
    "align_signals",
    "doppler",
    "cog",
    "cogspec",
    "pca",
    "PCA",
    "basic_pca",
    "heatpulse",
    "HeatPulseFFT",
    "streaming",
    "StreamingWelch",
    "io",
    "ShotLoader",
    "multitaper",
    "multitaper_psd",
    "multitaper_csd",
    "wavelet",
    "pycwt",
    "config",
    "SpectralConfig",
    "welch_psd",
    "crosscheck",
    "coh",
    "coh2",
    "psd",
    "csd",
    "fft_pmlab",
    "fft_pwelch",
    "fftinfosc",
    "Cxy_Cxy2",
    "welch_cross_spectra",
    "welch_filtered_cross_spectra",
    "detrend_none",
    "detrend_mean",
    "detrend_linear",
    "segmentation",
    "utils",
]
