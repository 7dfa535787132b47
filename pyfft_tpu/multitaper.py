"""Thomson multitaper spectral estimation (DPSS).

The reference vendors the DPSS taper generator (``windows.py:1986-2245``)
but never builds an estimator on it (SURVEY §5.7) — completing that is a
natural capability of the framework: the ``K`` tapers are a *batch axis*,
so the whole estimate is one device call (tapered segments ->
batched rFFT -> eigenvalue-weighted average).

- :func:`multitaper_psd`: auto-PSD with 'unity', 'eigen', or Thomson
  'adaptive' taper weighting (Percival & Walden eq. 368-370 iteration);
- :func:`multitaper_csd`: cross-spectrum, coherence and phase between two
  signals with eigen-weighted taper averaging.

Density normalization matches ``fft_pwelch`` (V^2/Hz: one-sided doubling of
interior bins, 1/fs scaling), verified against ``scipy.signal.periodogram``
-class oracles in ``tests/test_multitaper.py``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .windows import dpss
from .segmentation import get_nnyquist
from .spectral import _onesided_power_scale, resolve_fft_backend
from .ops import mxu_fft

__all__ = ["multitaper_psd", "multitaper_csd"]


@partial(jax.jit, static_argnames=("nnyquist", "backend"))
def _tapered_ffts(x, tapers, *, nnyquist, backend):
    """(K, nfreq) complex eigencoefficients as a real pair."""
    seg = tapers * x[None, :]                   # (K, n)
    if backend == "xla":
        X = jnp.fft.rfft(seg, axis=-1)[..., :nnyquist]
        return jnp.real(X), jnp.imag(X)
    Xr, Xi = mxu_fft.rfft_pair(seg)
    return Xr[..., :nnyquist], Xi[..., :nnyquist]


def _eigvals_tapers(n, NW, K):
    tapers, ratios = dpss(n, NW, Kmax=K, sym=False, return_ratios=True)
    return np.atleast_2d(tapers), np.atleast_1d(ratios)


def multitaper_psd(x, fs=1.0, NW=4.0, K=None, weighting="adaptive",
                   fft_backend=None, adaptive_iters=5):
    """Multitaper PSD of a real signal ``x``.

    ``K`` defaults to ``2*NW - 1`` tapers.  Returns ``(freq, Pxx)`` with
    Pxx in V^2/Hz (one-sided).  ``weighting``:

    - 'unity': plain average of the K eigenspectra;
    - 'eigen': eigenvalue-weighted average;
    - 'adaptive': Thomson's iterative weights  d_k(f) = sqrt(lam_k) S(f) /
      (lam_k S(f) + (1-lam_k) sigma^2), which suppress broadband leakage
      bin-by-bin.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if K is None:
        K = max(2, int(2 * NW - 1))
    tapers, lam = _eigvals_tapers(n, NW, K)
    backend = resolve_fft_backend(fft_backend)
    nny = get_nnyquist(n)

    Xr, Xi = _tapered_ffts(jnp.asarray(x), jnp.asarray(tapers),
                           nnyquist=nny, backend=backend)
    Sk = np.asarray(Xr) ** 2 + np.asarray(Xi) ** 2       # (K, nfreq)
    scale = _onesided_power_scale(n, nny) / fs

    if weighting == "unity":
        S = Sk.mean(axis=0)
    elif weighting == "eigen":
        S = (lam[:, None] * Sk).sum(axis=0) / lam.sum()
    elif weighting == "adaptive":
        sig2 = float(np.var(x))
        S = Sk[:2].mean(axis=0)                          # pilot estimate
        for _ in range(adaptive_iters):
            d = (np.sqrt(lam)[:, None] * S[None, :]
                 / (lam[:, None] * S[None, :]
                    + (1.0 - lam)[:, None] * sig2 + 1e-300))
            w = d ** 2
            S = (w * Sk).sum(axis=0) / w.sum(axis=0)
    else:
        raise ValueError(f"weighting {weighting!r} not in "
                         "('unity', 'eigen', 'adaptive')")

    freq = fs * np.arange(nny) / n
    return freq, S * scale


def multitaper_csd(x, y, fs=1.0, NW=4.0, K=None, fft_backend=None):
    """Multitaper cross-spectrum of two real signals.

    Returns ``(freq, Pxy, Pxx, Pyy, Cxy2, phi)`` — eigen-weighted taper
    averages; coherence here is meaningful *without* segment averaging
    because the K tapers supply independent estimates.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have equal length")
    n = x.size
    if K is None:
        K = max(2, int(2 * NW - 1))
    tapers, lam = _eigvals_tapers(n, NW, K)
    backend = resolve_fft_backend(fft_backend)
    nny = get_nnyquist(n)

    Xr, Xi = map(np.asarray, _tapered_ffts(jnp.asarray(x),
                                           jnp.asarray(tapers),
                                           nnyquist=nny, backend=backend))
    Yr, Yi = map(np.asarray, _tapered_ffts(jnp.asarray(y),
                                           jnp.asarray(tapers),
                                           nnyquist=nny, backend=backend))
    w = (lam / lam.sum())[:, None]
    Pxx = (w * (Xr ** 2 + Xi ** 2)).sum(axis=0)
    Pyy = (w * (Yr ** 2 + Yi ** 2)).sum(axis=0)
    Pxy = ((w * (Yr * Xr + Yi * Xi)).sum(axis=0)
           + 1j * (w * (Yi * Xr - Yr * Xi)).sum(axis=0))

    scale = _onesided_power_scale(n, nny) / fs
    freq = fs * np.arange(nny) / n
    with np.errstate(divide="ignore", invalid="ignore"):
        Cxy2 = np.abs(Pxy) ** 2 / (Pxx * Pyy)
    phi = np.arctan2(Pxy.imag, Pxy.real)
    return freq, Pxy * scale, Pxx * scale, Pyy * scale, Cxy2, phi
