"""Continuous wavelet transform (the reference's missing ``pycwt`` slot).

The reference's ``__init__`` optionally imports a ``pycwt`` wavelet
subpackage that is not shipped (reference ``__init__.py:38-42``) — the
capability its API promises but never delivers.  Batched version: the
CWT at all scales is ONE batched spectral multiply,

    W[a, n] = ifft( fft(x)[k] * conj(psi_hat(s_a * omega_k)) )[n]

so the scale axis rides the device batch dimension (a (J+1, N) element-wise
multiply + batched inverse FFT, no per-scale loop).

API follows the Torrence & Compo conventions (the pycwt lineage):

- :class:`Morlet` (``omega0`` default 6) with ``flambda``/``coi`` factors;
- :func:`cwt(x, dt, dj, s0, J, wavelet)`` ->
  ``(W, scales, freqs, coi)``;
- :func:`icwt` delta-function reconstruction;
- :func:`global_spectrum`: time-averaged |W|^2 (the wavelet analogue of
  the Welch PSD).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .spectral import backend_supports_complex
from .ops import mxu_fft

__all__ = ["Morlet", "cwt", "icwt", "global_spectrum"]


class Morlet:
    """Analytic Morlet wavelet (Torrence & Compo table 1)."""

    def __init__(self, omega0=6.0):
        self.omega0 = float(omega0)

    @property
    def flambda(self):
        """Fourier wavelength factor: lambda = flambda * scale."""
        w0 = self.omega0
        return 4.0 * np.pi / (w0 + np.sqrt(2.0 + w0 * w0))

    @property
    def coi_factor(self):
        """e-folding time factor: coi = coi_factor * scale."""
        return np.sqrt(2.0)

    # T&C reconstruction constants for omega0 = 6
    cdelta = 0.776
    psi0 = np.pi ** -0.25

    def hat(self, s_omega):
        """psi_hat(s*omega) on the positive-frequency axis (analytic)."""
        return (np.pi ** -0.25) * np.exp(
            -0.5 * (s_omega - self.omega0) ** 2) * (s_omega > 0.0)


@partial(jax.jit, static_argnames=("use_complex",))
def _cwt_core(xr, psi_hat, norm, use_complex):
    """Batched spectral multiply + inverse FFT over the scale axis."""
    if use_complex:
        X = jnp.fft.fft(xr)
        W = jnp.fft.ifft(X[None, :] * (psi_hat * norm[:, None]))
        return jnp.real(W), jnp.imag(W)
    Xr, Xi = mxu_fft.fft_pair(xr)
    Hr = psi_hat * norm[:, None]
    # (Xr + jXi) * Hr  (real filter bank: psi_hat is real for Morlet)
    Yr = Xr[None, :] * Hr
    Yi = Xi[None, :] * Hr
    return mxu_fft.ifft_pair(Yr, Yi)


def cwt(x, dt=1.0, dj=0.125, s0=None, J=None, wavelet=None):
    """Continuous wavelet transform of a real signal.

    Scales ``s_j = s0 * 2**(j*dj)``, ``j = 0..J`` (defaults: ``s0 = 2*dt``,
    ``J = log2(N*dt/s0)/dj`` — the full octave range).  Returns
    ``(W (J+1, N) complex, scales, freqs, coi)`` where ``coi[n]`` is the
    e-folding period of edge effects at time index ``n``.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    wavelet = wavelet or Morlet()
    if s0 is None:
        s0 = 2.0 * dt
    if J is None:
        J = int(np.log2(n * dt / s0) / dj)
    scales = s0 * 2.0 ** (dj * np.arange(J + 1))

    omega = 2.0 * np.pi * np.fft.fftfreq(n, dt)
    psi_hat = np.stack([wavelet.hat(s * omega) for s in scales])
    # L2 normalization: sqrt(2*pi*s/dt)
    norm = np.sqrt(2.0 * np.pi * scales / dt)

    x0 = x - x.mean()
    Wr, Wi = _cwt_core(jnp.asarray(x0), jnp.asarray(psi_hat),
                       jnp.asarray(norm),
                       use_complex=backend_supports_complex())
    W = np.asarray(Wr) + 1j * np.asarray(Wi)

    freqs = 1.0 / (wavelet.flambda * scales)
    t_edge = np.minimum(np.arange(n), np.arange(n)[::-1]) * dt
    coi = wavelet.coi_factor * t_edge / wavelet.flambda  # as frequency^-1
    return W, scales, freqs, coi


def icwt(W, scales, dt=1.0, dj=0.125, wavelet=None):
    """Delta-function reconstruction (T&C eq. 11)."""
    wavelet = wavelet or Morlet()
    fac = (dj * np.sqrt(dt)
           / (wavelet.cdelta * wavelet.psi0))
    return fac * np.sum(np.real(W) / np.sqrt(scales)[:, None], axis=0)


def global_spectrum(W, scales=None):
    """Time-averaged wavelet power |W|^2 per scale (wavelet PSD analogue)."""
    return np.mean(np.abs(np.asarray(W)) ** 2, axis=-1)
