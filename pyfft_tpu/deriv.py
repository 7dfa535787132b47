"""Spectral differentiation (fft_deriv) with modified wavenumbers.

Role of the reference's ``fft_deriv`` family (``fft_analysis.py:1419-1588``):
derivative via ``ifft(wavenumber * fft(f))`` with the Sunaina et al. (2018)
modified wavenumber ``j sin(k dx)/dx`` to suppress ringing, optional
pre-filter/downsample, optional window, and one-sided-difference endpoint
repair.  The transform runs on-device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .utils.detrend import detrend_none
from .ops import mxu_fft


__all__ = ["rescale", "unscale", "fft_deriv"]


def rescale(xx, yy, scaley=True, scalex=True):
    """Normalize (x, y) to unit-ish ranges (reference ``rescale``, :1419)."""
    slope, offset = 1.0, 0.0
    xslope, xoffset = 1.0, 0.0
    xx = np.asarray(xx, dtype=float)
    yy = np.asarray(yy, dtype=float)
    if scaley:
        slope = np.nanmax(yy) - np.nanmin(yy)
        offset = np.nanmin(yy)
        if slope == 0:
            slope = 1.0
        yy = (yy.copy() - offset) / slope
    if scalex:
        xslope = np.nanmax(xx) - np.nanmin(xx)
        xoffset = -1e-4
        if xslope == 0:
            xslope = 1.0
        xx = (xx.copy() - xoffset) / xslope
    return xx, yy, (slope, offset, xslope, xoffset)


def unscale(xx, yy, scl, dydx=None):
    """Invert :func:`rescale` (reference ``unscale``, :1440)."""
    slope, offset, xslope, xoffset = scl
    xx = np.asarray(xx) * xslope + xoffset
    yy = slope * np.asarray(yy) + offset
    if dydx is not None:
        dydx = np.asarray(dydx) * slope / xslope
        return xx, yy, dydx
    return xx, yy


@partial(jax.jit, static_argnames=("nfft",))
def _spectral_deriv_xla(sig, wv, *, nfft):
    F = jnp.fft.fft(sig, n=nfft, axis=-1)
    return jnp.real(jnp.fft.ifft((1j * wv) * F, n=nfft, axis=-1))


@partial(jax.jit, static_argnames=("nfft",))
def _spectral_deriv_mxu(sig, wv, *, nfft):
    Fr, Fi = mxu_fft.fft_pair(sig, None, n=nfft, axis=-1)
    # multiply by j*wv (purely imaginary): (j wv)(Fr + j Fi) = -wv Fi + j wv Fr
    gr = -wv * Fi
    gi = wv * Fr
    out_r, _ = mxu_fft.ifft_pair(gr, gi, n=nfft, axis=-1)
    return out_r


def fft_deriv(sig, xx=None, lowpass=True, Fs_new=None, modified=True,
              detrend=detrend_none, window=None):
    """Differentiate a sampled signal spectrally.

    Behavior-parity with reference ``fft_deriv`` (``fft_analysis.py:1453``):

    - optional low-pass + resample before the transform (``lowpass`` True
      defaults to the Nyquist frequency, which leaves the signal unchanged);
    - ``modified=True`` uses the ringing-suppressing wavenumber
      ``j sin(k dx)/dx``;
    - optional window applied before the FFT and divided back out after;
    - endpoints replaced by one-sided finite differences (``:1550-1559``).

    Returns ``(dsdx, xx)``.
    """
    from .spectral import backend_supports_complex

    sig = np.asarray(sig, dtype=float)
    if xx is None:
        xx = 1.0 * np.arange(len(sig))
    xx = np.asarray(xx, dtype=float)

    if lowpass:
        dxo = xx[1] - xx[0]
        if lowpass is True:
            lowpass = 0.5 * 1.0 / dxo
        Fs = 1.0 / dxo
        if Fs_new is None:
            Fs_new = min(5.0 * lowpass, Fs)
        if Fs_new < Fs:
            from .filters import downsample_efficient
            sig = np.asarray(downsample_efficient(
                sig, Fs=Fs, Fs_new=Fs_new, plotit=False, halforder=2,
                lowpass=lowpass)).flatten()
            xx = xx[0] + np.arange(0, len(xx) / Fs, 1.0 / Fs_new)
            Fs = Fs_new

    xx, sig, scl = rescale(xx, sig, scaley=True, scalex=True)
    sig = np.asarray(detrend(jnp.asarray(sig)))

    N = len(xx)
    nfft = N
    dx = xx[1] - xx[0]
    L = N * dx

    k = np.fft.fftfreq(nfft, d=dx / L) * 2.0 * np.pi
    if modified:
        wv = np.sin(k * dx) / dx        # Sunaina et al. 2018 Eur.J.Phys. 39
    else:
        wv = k
    wv = wv / L

    if window is None:
        win = np.ones_like(sig)
    else:
        win = np.asarray(window(nfft))
    sig = win * sig

    ds0 = (sig[1] - sig[0]) / (xx[1] - xx[0])
    ds1 = (sig[-1] - sig[-2]) / (xx[-1] - xx[-2])

    if backend_supports_complex():
        out = _spectral_deriv_xla(jnp.asarray(sig), jnp.asarray(wv), nfft=nfft)
    else:
        out = _spectral_deriv_mxu(jnp.asarray(sig, dtype=jnp.float32),
                                  jnp.asarray(wv, dtype=jnp.float32),
                                  nfft=nfft)
    sig = np.asarray(out, dtype=float)

    sig = sig / win
    sig[0] = ds0
    sig[-1] = ds1

    xx, _, sig = unscale(xx, sig.copy(), scl=scl, dydx=sig)
    return sig, xx
