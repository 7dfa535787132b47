"""Block-streamed, checkpoint/resumable Welch estimation.

SURVEY §5.4/§5.7: the reference persists *results* only (HDF5 dumps,
HeatPulse_Funcs.py:264-296) and its long-sequence story is the in-memory
Welch segment loop (fft_analysis.py:362-388).  This module supplies the
device run-time equivalents the survey specifies:

- **O(block) memory**: the signal arrives in arbitrary-size time blocks;
  only segment *sums* (associative psum-style accumulators) and a
  ``nwins - hop``-sample carry buffer persist between pushes, so sequence
  length is unbounded by HBM or host RAM.
- **Checkpoint / resume**: the accumulator state is a flat dict of small
  arrays; :meth:`StreamingWelch.checkpoint` writes one ``.npz``,
  :meth:`StreamingWelch.restore` reconstructs the estimator mid-stream.
  Because segment sums are associative, a restored stream produces results
  bit-identical to an uninterrupted one.
- **Exact batch equivalence**: mean detrending is applied *post hoc* from
  the running signal mean using the identity

      sum_g |X_g - m W|^2 = sum|X_g|^2 - 2 Re(conj(m W) sum X_g)
                            + G |m W|^2        (W = FFT of the window)

  so the streamed estimate equals the batch ``fft_pwelch`` (detrend-mean,
  one-sided, sub-span bounds) to floating-point reassociation, verified in
  ``tests/test_streaming.py``.

Real-valued inputs / one-sided spectra (the streaming telemetry case).
Device compute is one jitted framed-FFT-power kernel per push, dispatching
'xla' (complex ``jnp.fft``) or 'mxu' (real-pair matmul DFT) exactly like
the batch pipeline.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import segmentation as seg
from .windows import windows as _windows
from .spectral import _onesided_power_scale, resolve_fft_backend
from .ops import mxu_fft
from .utils.structure import Struct

__all__ = ["StreamingWelch"]


@partial(jax.jit, static_argnames=("navr", "nwins", "hop", "nnyquist",
                                   "backend"))
def _block_sums(x, y, win, *, navr, nwins, hop, nnyquist, backend):
    """Raw (un-detrended) segment sums for one block.

    x: (nb,) reference block; y: (nch, nb) channels.
    Returns per-frequency sums: Sxx, Syy, Sxy(re,im), Ax(re,im), Ay(re,im).
    """
    xf = seg.frame_signal(x, nwins, hop, navr) * win          # (navr, nwins)
    yf = seg.frame_signal(y, nwins, hop, navr) * win          # (nch, navr, nw)
    if backend == "xla":
        X = jnp.fft.rfft(xf, axis=-1)[..., :nnyquist]
        Y = jnp.fft.rfft(yf, axis=-1)[..., :nnyquist]
        Xr, Xi = jnp.real(X), jnp.imag(X)
        Yr, Yi = jnp.real(Y), jnp.imag(Y)
    else:
        Xr, Xi = mxu_fft.rfft_pair(xf)
        Xr, Xi = Xr[..., :nnyquist], Xi[..., :nnyquist]
        Yr, Yi = mxu_fft.rfft_pair(yf)
        Yr, Yi = Yr[..., :nnyquist], Yi[..., :nnyquist]
    Sxx = jnp.sum(Xr * Xr + Xi * Xi, axis=-2)
    Syy = jnp.sum(Yr * Yr + Yi * Yi, axis=-2)
    # Y * conj(X), summed over segments
    Sxy_re = jnp.sum(Yr * Xr + Yi * Xi, axis=-2)
    Sxy_im = jnp.sum(Yi * Xr - Yr * Xi, axis=-2)
    Ax = (jnp.sum(Xr, axis=-2), jnp.sum(Xi, axis=-2))
    Ay = (jnp.sum(Yr, axis=-2), jnp.sum(Yi, axis=-2))
    return Sxx, Syy, Sxy_re, Sxy_im, Ax[0], Ax[1], Ay[0], Ay[1]


@partial(jax.jit, static_argnames=("navr", "nwins", "hop", "backend"))
def _block_sums2(xr, xi, yr, yi, win, *, navr, nwins, hop, backend):
    """Two-sided variant on complex inputs carried as (re, im) pairs."""
    fxr = seg.frame_signal(xr, nwins, hop, navr) * win
    fxi = seg.frame_signal(xi, nwins, hop, navr) * win
    fyr = seg.frame_signal(yr, nwins, hop, navr) * win
    fyi = seg.frame_signal(yi, nwins, hop, navr) * win
    if backend == "xla":
        X = jnp.fft.fft(jax.lax.complex(fxr, fxi), axis=-1)
        Y = jnp.fft.fft(jax.lax.complex(fyr, fyi), axis=-1)
        Xr, Xi = jnp.real(X), jnp.imag(X)
        Yr, Yi = jnp.real(Y), jnp.imag(Y)
    else:
        Xr, Xi = mxu_fft.fft_pair(fxr, fxi)
        Yr, Yi = mxu_fft.fft_pair(fyr, fyi)
    Sxx = jnp.sum(Xr * Xr + Xi * Xi, axis=-2)
    Syy = jnp.sum(Yr * Yr + Yi * Yi, axis=-2)
    Sxy_re = jnp.sum(Yr * Xr + Yi * Xi, axis=-2)
    Sxy_im = jnp.sum(Yi * Xr - Yr * Xi, axis=-2)
    return (Sxx, Syy, Sxy_re, Sxy_im,
            jnp.sum(Xr, axis=-2), jnp.sum(Xi, axis=-2),
            jnp.sum(Yr, axis=-2), jnp.sum(Yi, axis=-2))


class StreamingWelch:
    """Streaming one- or two-sided Welch cross-spectral accumulator.

    >>> sw = StreamingWelch(nwins=1024, fs=1e4, nch=4)
    >>> for xb, yb in blocks:      # arbitrary block sizes
    ...     sw.push(xb, yb)
    >>> res = sw.result()          # freq, Pxx, Pyy, Pxy, Cxy2, phi, ...

    ``detrend`` in {'mean', 'none'}: 'mean' subtracts the running global
    mean exactly (see module docstring); 'linear' has no streaming form and
    raises.
    """

    def __init__(self, nwins, fs=1.0, nch=1, windowoverlap=None,
                 windowfunction="hanning", detrend="mean", fft_backend=None,
                 onesided=True):
        if detrend not in ("mean", "none"):
            raise ValueError(
                "streaming supports detrend 'mean' or 'none' (global linear "
                "detrend has no one-pass form)")
        win = _windows(windowfunction, nwins=int(nwins), verbose=False)
        if windowoverlap is None:
            windowoverlap = _windows(windowfunction, verbose=False)
        self.nwins = int(nwins)
        self.noverlap = seg.get_noverlap(self.nwins, windowoverlap)
        self.hop = self.nwins - self.noverlap
        if self.hop <= 0:
            raise ValueError(f"overlap {windowoverlap} leaves hop <= 0")
        self.fs = float(fs)
        self.nch = int(nch)
        self.detrend = detrend
        self.windowfunction = windowfunction
        self.win = np.asarray(win, dtype=np.float64)
        self.nnyquist = seg.get_nnyquist(self.nwins)
        self.backend = resolve_fft_backend(fft_backend)
        self.onesided = bool(onesided)

        nf = self.nnyquist if self.onesided else self.nwins
        nc = self.nch
        self.nfreq = nf
        self.navr = 0
        self.nseen = 0                       # total samples consumed
        dt = float if self.onesided else complex
        self.sum_x = dt(0.0)                 # running means (for detrend)
        self.sum_y = np.zeros(nc, dtype=dt)
        self.Sxx = np.zeros(nf)
        self.Syy = np.zeros((nc, nf))
        self.Sxy = np.zeros((nc, nf), dtype=complex)
        self.Ax = np.zeros(nf, dtype=complex)
        self.Ay = np.zeros((nc, nf), dtype=complex)
        self._carry_x = np.zeros(0, dtype=dt)
        self._carry_y = np.zeros((nc, 0), dtype=dt)
        # window spectrum for the post-hoc mean-detrend correction
        self._W = (np.fft.rfft(self.win)[:nf] if self.onesided
                   else np.fft.fft(self.win))

    # ------------------------------------------------------------------ #

    def push(self, x, y=None):
        """Consume the next time block (``x`` (nb,); ``y`` (nch, nb))."""
        dt = np.float64 if self.onesided else np.complex128
        if self.onesided and (np.iscomplexobj(x) or np.iscomplexobj(y)):
            raise ValueError("complex blocks require onesided=False")
        x = np.asarray(x, dtype=dt).ravel()
        if y is None:
            y = x[None, :] if self.nch == 1 else None
        y = np.atleast_2d(np.asarray(y, dtype=dt))
        if y.shape[0] != self.nch or y.shape[1] != x.size:
            raise ValueError(f"y shape {y.shape} != ({self.nch}, {x.size})")

        self.nseen += x.size
        self.sum_x += x.sum()
        self.sum_y += y.sum(axis=1)

        x = np.concatenate([self._carry_x, x])
        y = np.concatenate([self._carry_y, y], axis=1)

        nb = x.size
        navr = 0 if nb < self.nwins else 1 + (nb - self.nwins) // self.hop
        if navr > 0:
            win_j = jnp.asarray(self.win)
            if self.onesided:
                out = _block_sums(jnp.asarray(x), jnp.asarray(y), win_j,
                                  navr=navr, nwins=self.nwins, hop=self.hop,
                                  nnyquist=self.nnyquist,
                                  backend=self.backend)
            else:
                out = _block_sums2(jnp.asarray(x.real), jnp.asarray(x.imag),
                                   jnp.asarray(y.real), jnp.asarray(y.imag),
                                   win_j, navr=navr, nwins=self.nwins,
                                   hop=self.hop, backend=self.backend)
            Sxx, Syy, Sre, Sim, Axr, Axi, Ayr, Ayi = map(np.asarray, out)
            self.navr += navr
            self.Sxx += Sxx
            self.Syy += Syy
            self.Sxy += Sre + 1j * Sim
            self.Ax += Axr + 1j * Axi
            self.Ay += Ayr + 1j * Ayi
        consumed = navr * self.hop
        self._carry_x = x[consumed:]
        self._carry_y = y[:, consumed:]
        return navr

    # ------------------------------------------------------------------ #

    def _detrended_sums(self):
        """Apply the post-hoc global-mean correction to the raw sums."""
        if self.detrend == "none" or self.nseen == 0:
            return self.Sxx, self.Syy, self.Sxy
        mx = self.sum_x / self.nseen
        my = self.sum_y / self.nseen                     # (nch,)
        W = self._W
        G = self.navr
        cx = mx * W                                      # (nf,)
        cy = my[:, None] * W[None, :]                    # (nch, nf)
        Sxx = (self.Sxx - 2.0 * np.real(np.conj(cx) * self.Ax)
               + G * np.abs(cx) ** 2)
        Syy = (self.Syy - 2.0 * np.real(np.conj(cy) * self.Ay)
               + G * np.abs(cy) ** 2)
        Sxy = (self.Sxy - cy * np.conj(self.Ax)
               - np.conj(cx) * self.Ay + G * cy * np.conj(cx))
        return Sxx, Syy, Sxy

    def result(self):
        """Finalize: normalized spectra + coherence/phase (a Struct)."""
        if self.navr == 0:
            raise ValueError("no complete segment consumed yet")
        S1 = seg.get_s1(self.win)
        S2 = seg.get_s2(self.win)
        ENBW = seg.get_enbw(self.fs, S1, S2)
        if self.onesided:
            scale = _onesided_power_scale(self.nwins, self.nnyquist)
        else:
            scale = 1.0
        norm = scale / (S1 ** 2 * ENBW * self.navr)

        Sxx, Syy, Sxy = self._detrended_sums()
        out = Struct()
        if self.onesided:
            out.freq = self.fs * np.arange(self.nnyquist) / self.nwins
            out.Pxx = Sxx * norm
            out.Pyy = Syy * norm
            out.Pxy = Sxy * norm
        else:
            out.freq = np.fft.fftshift(
                np.fft.fftfreq(self.nwins, 1.0 / self.fs))
            out.Pxx = np.fft.fftshift(Sxx * norm)
            out.Pyy = np.fft.fftshift(Syy * norm, axes=-1)
            out.Pxy = np.fft.fftshift(Sxy * norm, axes=-1)
        # (nch, nf) layout: broadcast Pxx over the channel axis
        denom = np.abs(out.Pxx)[None, :] * np.abs(out.Pyy)
        with np.errstate(divide="ignore", invalid="ignore"):
            out.Cxy2 = np.real(out.Pxy * np.conj(out.Pxy)) / denom
            out.Cxy = out.Pxy / np.sqrt(denom)
        out.phi_xy = np.arctan2(out.Pxy.imag, out.Pxy.real)
        out.Navr = self.navr
        out.ENBW = ENBW
        out.S1, out.S2 = S1, S2
        out.nseen = self.nseen
        return out

    # ------------------------------------------------------------------ #

    _STATE = ("navr", "nseen", "sum_x", "sum_y", "Sxx", "Syy", "Sxy",
              "Ax", "Ay", "_carry_x", "_carry_y")
    _CONFIG = ("nwins", "fs", "nch", "noverlap", "detrend",
               "windowfunction", "onesided")

    def checkpoint(self, path):
        """Write the full resumable state to one ``.npz`` file."""
        state = {k: np.asarray(getattr(self, k)) for k in self._STATE}
        cfg = {f"cfg_{k}": np.asarray(getattr(self, k))
               for k in self._CONFIG}
        np.savez(path, **state, **cfg)
        return path

    @classmethod
    def restore(cls, path, fft_backend=None):
        """Reconstruct a mid-stream estimator from :meth:`checkpoint`."""
        with np.load(path, allow_pickle=False) as z:
            nwins = int(z["cfg_nwins"])
            noverlap = int(z["cfg_noverlap"])
            sw = cls(nwins=nwins, fs=float(z["cfg_fs"]),
                     nch=int(z["cfg_nch"]),
                     windowoverlap=noverlap / nwins,
                     windowfunction=str(z["cfg_windowfunction"]),
                     detrend=str(z["cfg_detrend"]),
                     onesided=bool(z["cfg_onesided"]),
                     fft_backend=fft_backend)
            for k in cls._STATE:
                v = z[k]
                setattr(sw, k, v.item() if v.ndim == 0 and k in
                        ("navr", "nseen", "sum_x") else v)
        sw.navr = int(sw.navr)
        sw.nseen = int(sw.nseen)
        return sw
