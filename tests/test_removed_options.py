"""Options and names that went with the fused-kernel tier fail loudly, and
the tables that replaced machine-specific defaults refuse what they do not
know."""
import numpy as np
import pytest

import pyfft_tpu as ft
from pyfft_tpu import parallel as par
from pyfft_tpu import segmentation as seg
from pyfft_tpu.utils import profiling as prof


def _sig(n=4096):
    rng = np.random.default_rng(0)
    return np.arange(n) / 1e3, rng.standard_normal(n), rng.standard_normal((2, n))


def _plan(n=4096, nwins=256):
    return seg.plan_segments(n, nwins=nwins, windowoverlap=0.5)


def _mesh():
    return par.make_mesh(ch=1, t=2)


CALLS = {
    "fft_pwelch": lambda b: ft.fft_pwelch(*_sig(), Navr=8, plotit=False,
                                          fft_backend=b),
    "welch_cross_spectra": lambda b: ft.welch_cross_spectra(
        _sig()[1], _sig()[2], np.hanning(256), _plan(), 1e3, fft_backend=b),
    "welch_filtered_cross_spectra": lambda b:
        ft.welch_filtered_cross_spectra(_sig()[1], _sig()[2], np.ones(5),
                                        np.hanning(256), _plan(), 1e3,
                                        fft_backend=b),
    "stft_segments": lambda b: ft.stft_segments(
        _sig()[1], _sig()[0], np.hanning(256), _plan(), 1e3, fft_backend=b),
    "fftanal": lambda b: ft.fftanal(*_sig(), Navr=8, plotit=False,
                                    fft_backend=b).fftpwelch(),
    "StreamingWelch": lambda b: ft.StreamingWelch(nwins=256, fft_backend=b),
    "multitaper_psd": lambda b: ft.multitaper_psd(_sig()[1], fft_backend=b),
    "multitaper_csd": lambda b: ft.multitaper_csd(_sig()[1], _sig()[1],
                                                  fft_backend=b),
    "SpectralConfig": lambda b: ft.welch_psd(
        _sig()[0], _sig()[1], None, ft.SpectralConfig(Navr=8,
                                                      fft_backend=b)),
    "welch_psd_sharded": lambda b: par.welch_psd_sharded(
        _sig()[1], _sig()[2], np.hanning(256), _plan(), 1e3, _mesh(),
        fft_backend=b),
    "stft_sharded": lambda b: par.stft_sharded(
        _sig()[1], _sig()[0], np.hanning(256), _plan(), 1e3, _mesh(),
        fft_backend=b),
    "fir_filter_sharded": lambda b: par.fir_filter_sharded(
        _sig()[2], np.ones(5), _mesh(), fft_backend=b),
    "fft_sharded": lambda b: par.fft_sharded(_sig()[1], _mesh(), backend=b),
    "hilbert_sharded": lambda b: par.hilbert_sharded(_sig()[1], _mesh(),
                                                     backend=b),
}


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_fft_backend_pallas_raises(entry):
    with pytest.raises(ValueError, match="'pallas' was removed"):
        CALLS[entry]("pallas")


def test_resolve_fft_backend():
    assert ft.resolve_fft_backend(None) == "xla"        # complex-capable CPU
    assert ft.resolve_fft_backend("auto") == "xla"
    assert ft.resolve_fft_backend("mxu") == "mxu"
    with pytest.raises(ValueError, match="unknown fft_backend"):
        ft.resolve_fft_backend("cufft")


@pytest.mark.parametrize("module,name", [
    ("pyfft_tpu.filters", "fir_filter_tiled"),
    ("pyfft_tpu.filters", "tile_rows"),
    ("pyfft_tpu.filters", "untile_rows"),
    ("pyfft_tpu.spectral", "_welch_core_pallas"),
    ("pyfft_tpu.hilbert", "_analytic_factored_slab"),
    ("pyfft_tpu.hilbert", "analytic_flops_bytes"),
    ("pyfft_tpu.utils.profiling", "measure_pipeline_overlap"),
    ("pyfft_tpu.utils.profiling", "interconnect_peaks"),
    ("pyfft_tpu.parallel", "project_scaling"),
    ("pyfft_tpu.parallel", "project_scaling_paths"),
])
def test_removed_names_are_gone(module, name):
    import importlib
    assert not hasattr(importlib.import_module(module), name)


@pytest.mark.parametrize("module", ["pyfft_tpu.ops.pallas_welch",
                                    "pyfft_tpu.ops.pallas_welch3",
                                    "pyfft_tpu.ops.pallas_fir"])
def test_kernel_modules_are_gone(module):
    import importlib
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(module)


def test_fir_filter_has_no_backend_option():
    with pytest.raises(TypeError):
        ft.filters.fir_filter(np.zeros(64), np.ones(3), backend="pallas")


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X",
                                  "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_device_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        prof.device_peaks(kind)


def test_device_peaks_default_device_on_cpu_raises():
    """The CPU is not a device with published peaks: no silent default."""
    with pytest.raises(KeyError):
        prof.device_peaks()


def test_kernel_precision_default_is_highest():
    from pyfft_tpu.ops.precision import resolve_kernel_precision
    assert resolve_kernel_precision(None) == "highest"
    assert resolve_kernel_precision("bf16x3") == "bf16x3"
    with pytest.raises(ValueError):
        resolve_kernel_precision("tf32")


def test_envelope_phase_traces_no_kernel_call():
    """The public demodulation path is plain jnp.fft: no custom kernel call
    in its jaxpr."""
    import jax
    import jax.numpy as jnp
    from pyfft_tpu.hilbert import _envelope_phase_dev
    txt = str(jax.make_jaxpr(lambda u: _envelope_phase_dev(
        u, nfft=4096, axis=-1))(jnp.zeros(4096, jnp.float32)))
    assert "pallas_call" not in txt and "fft" in txt
