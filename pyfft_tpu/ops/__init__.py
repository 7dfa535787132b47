"""Device transform/kernels layer.

- :mod:`pyfft_tpu.ops.mxu_fft` — real-arithmetic matmul-DFT FFTs (the
  ``fft_backend='mxu'`` path; no complex dtype required).
"""
from . import mxu_fft
from .mxu_fft import fft_pair, ifft_pair, rfft_pair, irfft_pair, dft_matrices

__all__ = ["mxu_fft", "fft_pair", "ifft_pair", "rfft_pair", "irfft_pair",
           "dft_matrices"]
