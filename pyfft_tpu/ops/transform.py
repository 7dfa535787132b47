"""Unified host-convenience transforms over the dual device paths.

Small analysis modules (Laplace, correlation, Doppler, ...) need plain
"numpy-in, numpy-out" FFTs that run on whatever device is present.  These
helpers dispatch to ``jnp.fft`` on complex-capable backends and to the
real-pair matmul stack (:mod:`pyfft_tpu.ops.mxu_fft`) elsewhere, always returning
NumPy arrays on the host.  Heavy pipelines (Welch, STFT, FIR) have their own
fused jitted cores and do not go through here.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import mxu_fft


def _complex_ok():
    from ..spectral import backend_supports_complex
    return backend_supports_complex()


@partial(jax.jit, static_argnames=("n", "axis"))
def _fft_xla(x, *, n, axis):
    return jnp.fft.fft(x, n=n, axis=axis)


@partial(jax.jit, static_argnames=("n", "axis"))
def _ifft_xla(x, *, n, axis):
    return jnp.fft.ifft(x, n=n, axis=axis)


@partial(jax.jit, static_argnames=("n", "axis"))
def _rfft_xla(x, *, n, axis):
    return jnp.fft.rfft(x, n=n, axis=axis)


@partial(jax.jit, static_argnames=("n", "axis"))
def _irfft_xla(x, *, n, axis):
    return jnp.fft.irfft(x, n=n, axis=axis)


_fft_mxu = jax.jit(mxu_fft.fft_pair, static_argnames=("n", "axis", "leaf",
                                                      "precision"))
_ifft_mxu = jax.jit(mxu_fft.ifft_pair, static_argnames=("n", "axis", "leaf",
                                                        "precision"))
_rfft_mxu = jax.jit(mxu_fft.rfft_pair, static_argnames=("n", "axis", "leaf",
                                                        "precision"))
_irfft_mxu = jax.jit(mxu_fft.irfft_pair, static_argnames=("n", "axis", "leaf",
                                                          "precision"))


def _split(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return (jnp.asarray(np.ascontiguousarray(x.real)),
                jnp.asarray(np.ascontiguousarray(x.imag)))
    return jnp.asarray(x), None


def fft(x, n=None, axis=-1):
    """Forward DFT; numpy-complex out, device-dispatched."""
    if _complex_ok():
        return np.asarray(_fft_xla(jnp.asarray(x), n=n, axis=axis))
    re, im = _split(x)
    ro, io = _fft_mxu(re, im, n=n, axis=axis)
    return np.asarray(ro) + 1j * np.asarray(io)


def ifft(x, n=None, axis=-1):
    """Inverse DFT (1/N-normalized); numpy-complex out."""
    if _complex_ok():
        return np.asarray(_ifft_xla(jnp.asarray(x), n=n, axis=axis))
    re, im = _split(x)
    if im is None:
        im = jnp.zeros_like(re)
    ro, io = _ifft_mxu(re, im, n=n, axis=axis)
    return np.asarray(ro) + 1j * np.asarray(io)


def rfft(x, n=None, axis=-1):
    """Real-input DFT; numpy-complex out."""
    if _complex_ok():
        return np.asarray(_rfft_xla(jnp.asarray(x), n=n, axis=axis))
    ro, io = _rfft_mxu(jnp.asarray(x), n=n, axis=axis)
    return np.asarray(ro) + 1j * np.asarray(io)


def irfft(x, n, axis=-1):
    """Inverse real DFT; numpy-real out."""
    if _complex_ok():
        return np.asarray(_irfft_xla(jnp.asarray(x), n=n, axis=axis))
    re, im = _split(x)
    if im is None:
        im = jnp.zeros_like(re)
    return np.asarray(_irfft_mxu(re, im, n=n, axis=axis))
