"""Welch-averaged auto-/cross-spectral estimation — the device core.

This module provides the role of the reference's ``fft_pwelch``
(reference ``fft_analysis.py:36-791``), redesigned for batched device
execution:

* the per-segment Python loop (reference ``fft_analysis.py:362-388``) becomes
  a single batched ``frame -> window -> FFT -> power`` pipeline under one
  ``jax.jit`` — the segment axis is a clean batch dimension;
* two device transform paths:
  - ``xla``: complex ``jnp.fft`` (cuFFT on the GPU) — the default;
  - ``mxu``: real-arithmetic matmul-DFTs (:mod:`pyfft_tpu.ops.mxu_fft`) —
    complex data travels as (re, im) pairs; only an explicit
    ``fft_backend='mxu'`` selects it;
* all shape arithmetic is resolved statically at trace time
  (:mod:`pyfft_tpu.segmentation`);
* the O(nfreq) finalization (coherence, variances, amplitude spectra,
  lag-domain correlations) runs on the host in float64 NumPy — it is
  negligible work and keeps the device graph free of complex ops;
* normalization contract is bin-for-bin identical to the reference homebrew
  path: one-sided energy doubling on interior bins (``fft_analysis.py:402-421``),
  ``1/S1^2`` RMS-power scaling then ``1/ENBW`` density scaling
  (``fft_analysis.py:432-440``), Bendat'78 coherence variance
  (``fft_analysis.py:496-514``), lag-domain correlations (``:544-597``).

The public entry point :func:`fft_pwelch` keeps the reference's exact calling
convention and output tuple ``(freq, Pxy, Pxx, Pyy, Cxy, phi_xy, info)``.
"""
from __future__ import annotations

from functools import partial, lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .utils.structure import Struct
from .utils.detrend import detrend_func
from .windows import windows
from . import segmentation as seg
from .ops import mxu_fft


__all__ = ["fft_pwelch", "fftinfosc", "Cxy_Cxy2", "welch_cross_spectra",
           "csd_oracle", "backend_supports_complex", "resolve_fft_backend"]


# --------------------------------------------------------------------------- #
# Backend capability probe
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=None)
def backend_supports_complex() -> bool:
    """True when the default JAX backend fully supports complex arrays.

    The decision is platform-based: CPU and GPU take the complex
    ``jnp.fft`` path; a backend without complex support would fall back to
    the real-pair matmul path.
    """
    return jax.default_backend() in ("cpu", "gpu", "cuda", "rocm")


def resolve_fft_backend(fft_backend=None) -> str:
    """Resolve 'auto'/None to a concrete transform path.

    'xla' = complex ``jnp.fft`` (cuFFT on the GPU, the default);
    'mxu' = real-pair matmul DFTs (:mod:`pyfft_tpu.ops.mxu_fft`).
    """
    if fft_backend in ("xla", "mxu"):
        return fft_backend
    if fft_backend == "pallas":
        raise ValueError(
            "fft_backend='pallas' was removed together with the fused-kernel "
            "tier; use the default (None/'auto'), 'xla' or 'mxu'")
    if fft_backend not in (None, "auto"):
        raise ValueError(f"unknown fft_backend {fft_backend!r}; expected "
                         "None, 'auto', 'xla' or 'mxu'")
    return "xla" if backend_supports_complex() else "mxu"


# --------------------------------------------------------------------------- #
# Output schema (reference fft_analysis.py:796-828)
# --------------------------------------------------------------------------- #

_SEGMENT_FIELDS = ("Pxx_seg", "Pyy_seg", "Pxy_seg", "Xfft_seg", "Yfft_seg",
                   "phixy_seg", "varphi_seg")


class fftinfosc(Struct):
    """Result container with the reference's output schema.

    Field list mirrors reference ``fftinfosc`` (``fft_analysis.py:796-828``):
    window norms (S1, S2, NENBW, ENBW), averaged spectra, coherence/phase with
    propagated variances, linear amplitude spectra, and per-segment arrays.

    The mesh-sharded path does not materialize the
    per-segment arrays (``Pxx_seg``/``Xfft_seg``/…, reference
    ``fft_analysis.py:391-393``) during the hot dispatch; instead the first
    attribute access transparently recomputes them with the generic batched
    backend (one extra device pass over the retained inputs), so reference
    code consuming ``fftinfo.Pxx_seg`` keeps working.
    """

    def _defer_segments(self, fill):
        """Arm lazy per-segment computation: drop the fields and install a
        one-shot ``fill(info)`` callback run on first access."""
        for f in _SEGMENT_FIELDS:
            self.__dict__.pop(f, None)
        self.__dict__["_lazy_segments"] = fill

    def __getattr__(self, name):
        # only reached when ``name`` is NOT in the instance dict
        if name in _SEGMENT_FIELDS:
            fill = self.__dict__.pop("_lazy_segments", None)
            if fill is not None:
                fill(self)
                return self.__dict__[name]
            raise AttributeError(
                f"fftinfo.{name} is not available: this result came from "
                "the mesh-sharded Welch path, which does not keep "
                "per-segment arrays, and the inputs were not retained for "
                "recomputation.  Re-run fft_pwelch without mesh= to "
                "populate them.")
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}")

    def __init__(self):
        self.S1 = None
        self.S2 = None
        self.NENBW = None
        self.ENBW = None
        self.freq = None
        self.Pxx = None
        self.Pyy = None
        self.Pxy = None
        self.Cxy = None
        self.varcoh = None
        self.phi_xy = None
        self.varphi = None
        self.Lxx = None
        self.Lyy = None
        self.Lxy = None
        self.varLxx = None
        self.varLyy = None
        self.varLxy = None
        self.Pxx_seg = None
        self.Pyy_seg = None
        self.Pxy_seg = None
        self.Xfft_seg = None
        self.Yfft_seg = None


# --------------------------------------------------------------------------- #
# Coherence (reference fft_analysis.py:1662-1688)
# --------------------------------------------------------------------------- #

def Cxy_Cxy2(Pxx, Pyy, Pxy, ibg=None):
    """Complex coherence and mean-squared coherence (host, NumPy).

    ``Cxy = Pxy / sqrt(|Pxx| |Pyy|)``; ``Cxy2 = Pxy conj(Pxy)/(|Pxx||Pyy|)``
    (reference ``fft_analysis.py:1672-1677``).  With ``ibg`` given, returns
    the imaginary coherence and background-subtracted coherence instead
    (reference ``:1683-1688``).
    """
    Pxx = np.asarray(Pxx)
    Pyy = np.asarray(Pyy)
    Pxy = np.asarray(Pxy)
    if Pxx.ndim < Pyy.ndim:
        Pxx = Pxx.reshape(Pxx.shape + (1,) * (Pyy.ndim - Pxx.ndim))
    denom = np.abs(Pxx) * np.abs(Pyy)
    # zero-power bins yield NaN coherence, exactly like the reference —
    # intentional, so don't let numpy warn about the 0/0
    with np.errstate(invalid="ignore", divide="ignore"):
        Cxy2 = Pxy * np.conj(Pxy) / denom
        Cxy = Pxy / np.sqrt(denom)
    if ibg is None:
        return Cxy, Cxy2
    iCxy = np.imag(Cxy) / (1.0 - np.real(Cxy))
    bg = np.mean(Cxy[:, ibg], axis=-1, keepdims=True)
    Cprime = np.real(Cxy - bg) / (1.0 - np.real(Cxy - bg))
    return iCxy, Cprime


# --------------------------------------------------------------------------- #
# One-sided bin-scaling vectors
# --------------------------------------------------------------------------- #

def _onesided_power_scale(nfft: int, nnyquist: int) -> np.ndarray:
    """Energy-doubling vector for one-sided *power* spectra.

    Reproduces reference ``fft_analysis.py:414-421``: interior bins doubled
    via ``[1:-1]`` on the retained array, plus the last retained bin when
    ``nfft`` is odd.
    """
    s = np.ones(nnyquist)
    s[1:-1] = 2.0
    if nfft % 2:
        s[-1] = 2.0
    return s


def _onesided_amp_scale(nfft: int, nnyquist: int) -> np.ndarray:
    """sqrt(2) doubling for one-sided *amplitude* (FFT-coefficient) spectra.

    Reproduces reference ``fft_analysis.py:2186-2189`` (``fft_win``).
    """
    s = np.ones(nnyquist)
    s[1:-1] = np.sqrt(2.0)
    if nfft % 2:
        s[-1] = np.sqrt(2.0)
    return s


# --------------------------------------------------------------------------- #
# Jitted segment pipelines (device side, fully static shapes)
# --------------------------------------------------------------------------- #

@partial(jax.jit, static_argnames=("navr", "nwins", "noverlap", "nfft",
                                   "nnyquist", "onesided", "detrend_style",
                                   "ntmodel"))
def _welch_core_xla(x, y, win, s1sq_enbw, *, navr, nwins, noverlap,
                    nfft, nnyquist, onesided, detrend_style, ntmodel):
    """Complex-dtype Welch segment spectra (the default path).

    Inputs: ``x (nt,)``, ``y (nch, nt)``, ``win (nwins,)``,
    ``s1sq_enbw = S1^2 * ENBW`` (traced so window changes do not recompile).
    """
    det = detrend_func(detrend_style)
    x = det(x, axis=-1)
    y = det(y, axis=-1)
    hop = nwins - noverlap

    if ntmodel:
        xfr = x[None, :nwins]
    else:
        xfr = seg.frame_signal(x, nwins, hop, navr)          # (navr, nwins)
    yfr = seg.frame_signal(y, nwins, hop, navr)              # (nch, navr, nwins)

    w = win.astype(xfr.real.dtype)
    X = jnp.fft.fft(xfr * w, n=nfft, axis=-1)
    Y = jnp.fft.fft(yfr * w, n=nfft, axis=-1)
    if ntmodel:
        X = jnp.broadcast_to(X, (navr, nfft))

    Pxx = X * jnp.conj(X)                                    # (navr, nfft)
    Pyy = Y * jnp.conj(Y)                                    # (nch, navr, nfft)
    Pxy = Y * jnp.conj(X)                                    # (nch, navr, nfft)

    if onesided:
        scale = jnp.asarray(_onesided_power_scale(nfft, nnyquist),
                            dtype=Pxx.real.dtype)
        Pxx = Pxx[..., :nnyquist] * scale
        Pyy = Pyy[..., :nnyquist] * scale
        Pxy = Pxy[..., :nnyquist] * scale
    else:
        Pxx = jnp.fft.fftshift(Pxx, axes=-1)
        Pyy = jnp.fft.fftshift(Pyy, axes=-1)
        Pxy = jnp.fft.fftshift(Pxy, axes=-1)

    norm = 1.0 / s1sq_enbw
    Pxx = Pxx * norm
    Pyy = Pyy * norm
    Pxy = Pxy * norm

    return dict(Pxx_seg=Pxx, Pyy_seg=Pyy, Pxy_seg=Pxy,
                Xfft_seg=X, Yfft_seg=Y,
                Pxx=jnp.mean(Pxx, axis=0),
                Pyy=jnp.mean(Pyy, axis=1).T,
                Pxy=jnp.mean(Pxy, axis=1).T)


@partial(jax.jit, static_argnames=("navr", "nwins", "noverlap", "nfft",
                                   "nnyquist", "onesided", "detrend_style",
                                   "ntmodel"))
def _welch_core_mxu(xr, xi, yr, yi, win, s1sq_enbw, *, navr, nwins, noverlap,
                    nfft, nnyquist, onesided, detrend_style, ntmodel):
    """Real-pair Welch segment spectra (no complex dtype anywhere).

    ``xi``/``yi`` are None for exactly-real inputs.  The cross-spectrum
    follows the reference's ``Y conj(X)`` convention (``fft_analysis.py:393``):
    ``Re = Yr Xr + Yi Xi``, ``Im = Yi Xr - Yr Xi``.
    """
    det = detrend_func(detrend_style)
    hop = nwins - noverlap

    def prep(re, im):
        re = det(re, axis=-1)
        im = None if im is None else det(im, axis=-1)
        return re, im

    xr, xi = prep(xr, xi)
    yr, yi = prep(yr, yi)

    def frames(re, im, model):
        if model:
            fr = re[None, :nwins]
            fi = None if im is None else im[None, :nwins]
        else:
            fr = seg.frame_signal(re, nwins, hop, navr)
            fi = None if im is None else seg.frame_signal(im, nwins, hop, navr)
        return fr, fi

    xfr, xfi = frames(xr, xi, ntmodel)
    yfr, yfi = frames(yr, yi, False)

    w = win.astype(xfr.dtype)
    Xr, Xi = mxu_fft.fft_pair(xfr * w, None if xfi is None else xfi * w,
                              n=nfft, axis=-1)
    Yr, Yi = mxu_fft.fft_pair(yfr * w, None if yfi is None else yfi * w,
                              n=nfft, axis=-1)
    if ntmodel:
        Xr = jnp.broadcast_to(Xr, (navr, nfft))
        Xi = jnp.broadcast_to(Xi, (navr, nfft))

    Pxx = Xr * Xr + Xi * Xi                                  # (navr, nfft)
    Pyy = Yr * Yr + Yi * Yi                                  # (nch, navr, nfft)
    Pxy_re = Yr * Xr + Yi * Xi
    Pxy_im = Yi * Xr - Yr * Xi

    if onesided:
        scale = jnp.asarray(_onesided_power_scale(nfft, nnyquist),
                            dtype=Pxx.dtype)
        Pxx = Pxx[..., :nnyquist] * scale
        Pyy = Pyy[..., :nnyquist] * scale
        Pxy_re = Pxy_re[..., :nnyquist] * scale
        Pxy_im = Pxy_im[..., :nnyquist] * scale
    else:
        Pxx = jnp.fft.fftshift(Pxx, axes=-1)
        Pyy = jnp.fft.fftshift(Pyy, axes=-1)
        Pxy_re = jnp.fft.fftshift(Pxy_re, axes=-1)
        Pxy_im = jnp.fft.fftshift(Pxy_im, axes=-1)

    norm = 1.0 / s1sq_enbw
    return dict(Pxx_seg=Pxx * norm, Pyy_seg=Pyy * norm,
                Pxy_seg_re=Pxy_re * norm, Pxy_seg_im=Pxy_im * norm,
                Xfft_seg_re=Xr, Xfft_seg_im=Xi,
                Yfft_seg_re=Yr, Yfft_seg_im=Yi,
                Pxx=jnp.mean(Pxx, axis=0) * norm,
                Pyy=jnp.mean(Pyy, axis=1).T * norm,
                Pxy_re=jnp.mean(Pxy_re, axis=1).T * norm,
                Pxy_im=jnp.mean(Pxy_im, axis=1).T * norm)


def _split_pair(a):
    """Host-side complex -> (re, im | None) split for the real-pair path."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return (jnp.asarray(np.ascontiguousarray(a.real)),
                jnp.asarray(np.ascontiguousarray(a.imag)))
    return jnp.asarray(a), None


def _run_welch_core(x_in, y_in, win, s1sq_enbw, *, backend, **static):
    """Dispatch to a transform path; returns numpy-complex segment results."""
    if backend == "xla":
        out = _welch_core_xla(jnp.asarray(x_in), jnp.asarray(y_in.T),
                              jnp.asarray(win), jnp.asarray(s1sq_enbw),
                              **static)
        return {k: np.asarray(v) for k, v in out.items()}
    xr, xi = _split_pair(x_in)
    yr, yi = _split_pair(y_in.T)
    out = _welch_core_mxu(xr, xi, yr, yi, jnp.asarray(win),
                          jnp.asarray(s1sq_enbw), **static)
    out = {k: np.asarray(v) for k, v in out.items()}
    res = dict(
        Pxx_seg=out["Pxx_seg"].astype(np.complex128),
        Pyy_seg=out["Pyy_seg"].astype(np.complex128),
        Pxy_seg=out["Pxy_seg_re"] + 1j * out["Pxy_seg_im"],
        Xfft_seg=out["Xfft_seg_re"] + 1j * out["Xfft_seg_im"],
        Yfft_seg=out["Yfft_seg_re"] + 1j * out["Yfft_seg_im"],
        Pxx=out["Pxx"].astype(np.complex128),
        Pyy=out["Pyy"].astype(np.complex128),
        Pxy=out["Pxy_re"] + 1j * out["Pxy_im"],
    )
    return res


def _make_segment_fill(x_in, y_in, win, s1sq_enbw, **static):
    """One-shot per-segment recompute for the mesh path (lazy fill).

    Runs the generic batched core (which always materializes the
    reference's ``P??_seg``/``?fft_seg`` arrays, ``fft_analysis.py:391-393``)
    over the retained inputs and writes the fields into ``info``.
    """
    def fill(info):
        out = _run_welch_core(x_in, y_in, win, s1sq_enbw,
                              backend=resolve_fft_backend(None), **static)
        info.Pxx_seg = out["Pxx_seg"]
        info.Pyy_seg = out["Pyy_seg"]
        info.Pxy_seg = out["Pxy_seg"]
        info.Xfft_seg = out["Xfft_seg"]
        info.Yfft_seg = out["Yfft_seg"]
        info.phixy_seg = np.angle(out["Pxy_seg"])
        info.varphi_seg = np.zeros_like(info.phixy_seg)
    return fill


def _make_segment_fill_sharded(x_in, y_in, win, s1sq_enbw, mesh, fs,
                               **static):
    """Distributed lazy fill: per-segment spectra computed where the
    samples live (the ``raw`` mode of :func:`parallel.stft.stft_sharded`,
    one pass per signal) instead of a single-device recompute — so the
    reference's ``P??_seg``/``?fft_seg`` contract
    (``fft_analysis.py:391-393``) holds even when the input only fits the
    mesh.  Scaling reproduces :func:`_welch_core_xla` exactly: ``Xfft_seg``
    raw full-nfft natural-order, power segments one-sided-doubled (or
    fftshifted) and divided by ``S1^2 * ENBW``.
    """
    def fill(info):
        from .parallel.stft import stft_sharded
        nt = len(np.asarray(x_in))
        plan = seg.SegmentPlan(
            nsig=nt, nwins=static["nwins"], noverlap=static["noverlap"],
            navr=static["navr"], nfft=static["nfft"],
            nnyquist=static["nnyquist"])
        tvec = np.arange(nt) / fs
        kw = dict(onesided=static["onesided"],
                  detrend_style=static["detrend_style"], raw=True)
        _, _, X = stft_sharded(np.asarray(x_in), tvec, win, plan, fs,
                               mesh, **kw)
        y2 = np.asarray(y_in)                       # (nt, nch)
        Ys = np.stack([stft_sharded(y2[:, c], tvec, win, plan, fs,
                                    mesh, **kw)[2]
                       for c in range(y2.shape[1])])
        Pxx = (X * np.conj(X)).real
        Pyy = (Ys * np.conj(Ys)).real
        Pxy = Ys * np.conj(X)[None]
        nfft, nnyq = static["nfft"], static["nnyquist"]
        if static["onesided"]:
            sc = _onesided_power_scale(nfft, nnyq)
            Pxx = Pxx[..., :nnyq] * sc
            Pyy = Pyy[..., :nnyq] * sc
            Pxy = Pxy[..., :nnyq] * sc
        else:
            Pxx = np.fft.fftshift(Pxx, axes=-1)
            Pyy = np.fft.fftshift(Pyy, axes=-1)
            Pxy = np.fft.fftshift(Pxy, axes=-1)
        norm = 1.0 / s1sq_enbw
        info.Pxx_seg = (Pxx * norm).astype(np.complex128)
        info.Pyy_seg = (Pyy * norm).astype(np.complex128)
        info.Pxy_seg = Pxy * norm
        info.Xfft_seg = X
        info.Yfft_seg = Ys
        info.phixy_seg = np.angle(info.Pxy_seg)
        info.varphi_seg = np.zeros_like(info.phixy_seg)
    return fill


def welch_cross_spectra(x, y, win, plan: seg.SegmentPlan, fs: float, *,
                        onesided=True, detrend_style=1, ntmodel=False,
                        fft_backend=None):
    """Functional core: averaged auto-/cross-spectral densities.

    Returns a dict with ``freq`` plus per-segment and averaged spectra
    (numpy, complex where applicable).
    """
    win = np.asarray(win)
    s1 = seg.get_s1(win)
    enbw = seg.get_enbw(fs, s1, seg.get_s2(win))
    # accept y as (nt,) or channel-first (nch, nt); the runner wants (nt, nch)
    y2 = np.asarray(y)
    y2 = y2[:, None] if y2.ndim == 1 else y2.T
    out = _run_welch_core(
        np.asarray(x), y2, win, s1 ** 2 * enbw,
        backend=resolve_fft_backend(fft_backend),
        navr=plan.navr, nwins=plan.nwins, noverlap=plan.noverlap,
        nfft=plan.nfft, nnyquist=plan.nnyquist, onesided=bool(onesided),
        detrend_style=int(detrend_style), ntmodel=bool(ntmodel))
    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    out["freq"] = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return out


def welch_filtered_cross_spectra(x, y, taps, win, plan: seg.SegmentPlan,
                                 fs: float, *, detrend_style=1,
                                 fft_backend=None):
    """One-sided Welch auto-/cross-spectral densities of FIR-prefiltered
    REAL signals — the framework's headline Welch+FIR chain (the reference
    filters and estimates in separate passes, ``filters.py:36-123`` then
    ``fft_analysis.py:362-388``).

    ``x (nt,)`` reference, ``y (nt,) | (nch, nt)`` channels, ``taps`` a
    causal FIR applied to every signal (``np.convolve(sig, taps,
    'full')[:nt]``), detrend = global mean/none/linear of the *filtered*
    span.  The signals are filtered by overlap-save (:func:`fir_filter`)
    and then estimated by :func:`welch_cross_spectra`, whose dict contract
    this returns.
    """
    from .filters import fir_filter
    taps_np = np.asarray(taps, np.float64)
    xf = np.asarray(fir_filter(np.asarray(x), taps_np))
    yf = np.asarray(fir_filter(np.atleast_2d(np.asarray(y)), taps_np))
    return welch_cross_spectra(xf, yf, win, plan, fs, onesided=True,
                               detrend_style=detrend_style,
                               fft_backend=fft_backend)


# --------------------------------------------------------------------------- #
# Independent-oracle CSD path (role of matplotlib.mlab.csd; reference :288-303)
# --------------------------------------------------------------------------- #

def csd_oracle(x, y, nfft, fs, detrend=None, window=None, noverlap=0,
               sides="onesided"):
    """NumPy cross-spectral density with matplotlib.mlab conventions.

    Role of the reference's ``useMLAB`` cross-check path
    (``fft_analysis.py:288-303``): per-segment detrend, window, FFT,
    ``conj(X) * Y`` averaged, scaled by ``1/(Fs * S2)``, with one-sided
    doubling of non-DC/non-Nyquist bins.  Kept in NumPy on purpose — it is
    the *independent* implementation used to validate the device path.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if window is None:
        window = np.hanning(nfft)
    win = np.asarray(window)
    if detrend is None:
        detrend = lambda d: d  # noqa: E731

    step = nfft - noverlap
    starts = np.arange(0, len(x) - nfft + 1, step)
    navr = len(starts)
    acc = 0.0
    for s0 in starts:
        xs = detrend(x[s0:s0 + nfft]) * win
        ys = detrend(y[s0:s0 + nfft]) * win
        X = np.fft.fft(xs, n=nfft)
        Y = np.fft.fft(ys, n=nfft)
        acc = acc + np.conj(X) * Y
    Pxy = acc / navr
    Pxy /= fs * (win ** 2).sum()

    freqs = np.fft.fftfreq(nfft, 1.0 / fs)
    if sides == "onesided":
        nret = nfft // 2 + 1
        Pxy = Pxy[:nret].copy()
        if nfft % 2:
            Pxy[1:] *= 2.0
        else:
            Pxy[1:-1] *= 2.0
        freqs = np.abs(freqs[:nret])
        if nfft % 2 == 0:
            freqs[-1] = fs / 2.0
    else:
        Pxy = np.fft.fftshift(Pxy)
        freqs = np.fft.fftshift(freqs)
    return Pxy, freqs


# --------------------------------------------------------------------------- #
# fft_pwelch — full-parity public API
# --------------------------------------------------------------------------- #

def fft_pwelch(tvec, sigx, sigy, tbounds=None, Navr=None, windowoverlap=None,
               windowfunction=None, useMLAB=None, plotit=None, verbose=None,
               detrend_style=None, onesided=None, fft_backend=None,
               mesh=None, **kwargs):
    """Welch-averaged cross-spectral analysis of two signals.

    Computes the cross- and auto-power spectral densities, coherence,
    cross-phase (with propagated uncertainties), linear amplitude spectra and
    lag-domain correlations of ``sigx`` against (possibly multi-channel)
    ``sigy``.

    Calling convention, defaulting rules and outputs are behavior-compatible
    with the reference ``fft_pwelch`` (``fft_analysis.py:36-791``):

    - ``windowfunction`` default 'Hanning'; ``windowoverlap`` defaults to the
      window's recommended overlap (``:104-111``);
    - ``minFreq``/``tper`` kwargs override the segment length
      (``nwins = int(Fs * tper)``, ``tper = 2/minFreq``; ``:180-183``);
    - ``onesided`` defaults to False for complex inputs (``:123-128``);
    - ``detrend_style``: 1 mean (default), 0 none, -1 linear;
    - full-span inputs are reflect-extended at the boundaries (``:196-205``);
    - ``useMLAB=True`` runs the independent NumPy oracle path instead of the
      device pipeline (role of ``matplotlib.mlab.csd``; ``:288-303``).

    ``fft_backend``: None/'auto' (probe the device), 'xla' (complex
    ``jnp.fft``, cuFFT on the GPU) or 'mxu' (real-pair matmul DFTs).

    ``mesh``: ``None`` (single device), a ``jax.sharding.Mesh`` with
    ``('ch', 't')`` axes, or ``'auto'`` (build one over every visible
    device) — runs the Welch averaging distributed: time axis sharded
    with ppermute halo exchange, channels data-parallel, psum averages
    (SURVEY §2.3).  The reflect-extension and ``nTmodel`` semantics are
    preserved; per-segment arrays (``fftinfo.Pxx_seg`` etc.) are computed
    lazily on first access (one extra single-device pass).  Complex
    signals run two-sided as stacked (re, im) pairs (the Doppler IQ
    configuration, reference ``fft_analysis.py:423-427``).

    Returns ``(freq, Pxy, Pxx, Pyy, Cxy, phi_xy, fftinfo)``.

    Deviation from the reference (documented): when segment arithmetic after
    reflect-extension would index past the analyzed span (a crash in the
    reference for ``minFreq`` + full-span inputs), ``Navr`` is clamped to the
    largest count that fits.
    """
    calcNavr = Navr is None
    if windowfunction is None:
        windowfunction = "Hanning"
    if windowoverlap is None:
        windowoverlap = windows(windowfunction, verbose=False)
    if useMLAB is None:
        useMLAB = False
    if plotit is None:
        plotit = True
    if verbose is None:
        verbose = False
    if detrend_style is None:
        detrend_style = 1
    tvec = np.asarray(tvec)
    if tbounds is None:
        tbounds = [tvec[0], tvec[-1]]

    sigx = np.asarray(sigx)
    if sigy is None:
        # auto-spectra shorthand, mirroring fftanal.init's ``sigy=None ->
        # sigx`` rule (reference fft_analysis.py:1714); the function-API
        # reference would die on an object array here
        sigy = sigx
    sigy = np.asarray(sigy)
    if onesided is None:
        onesided = not (np.iscomplexobj(sigx) or np.iscomplexobj(sigy))

    Fs = (len(tvec) - 1) / (tvec[-1] - tvec[0])

    i0 = int(np.floor(Fs * (tbounds[0] - tvec[0])))
    i1 = int(np.floor(1 + Fs * (tbounds[1] - tvec[0])))
    nsig = np.size(tvec[i0:i1])

    # --- shape handling: sigy -> (nt, nch) (reference :163-167)
    sigy = np.atleast_2d(sigy)
    if sigy.shape[1] == len(tvec):
        sigy = sigy.T
    nch = sigy.shape[1]

    # --- segment-length resolution (reference :170-191)
    nTmodel = np.size(sigx, axis=0) != np.size(sigy, axis=0)
    if nTmodel:
        if calcNavr:
            nwins = np.size(sigx, axis=0)
        else:
            nwins = seg.get_nwins(nsig, Navr, windowoverlap)
    else:
        if "minFreq" in kwargs:
            kwargs["tper"] = 2.0 / kwargs["minFreq"]
        if "tper" in kwargs:
            nwins = int(Fs * kwargs["tper"])
        else:
            if Navr is None:
                Navr = 8
            calcNavr = False
            nwins = seg.get_nwins(nsig, Navr, windowoverlap)

    noverlap = seg.get_noverlap(nwins, windowoverlap)

    # --- reflect-extension at full span (reference :196-205)
    reflecting = False
    if i0 == 0 and i1 == len(tvec):
        reflecting = True
        if not nTmodel:
            sigx = np.concatenate(
                (sigx[nwins - 1:0:-1, ...], sigx, sigx[-1:-nwins:-1, ...]), axis=0)
        sigy = np.concatenate(
            (sigy[nwins - 1:0:-1, ...], sigy, sigy[-1:-nwins:-1, ...]), axis=0)
        nsig = sigy.shape[0]

    if calcNavr:
        Navr = seg.get_navr(nsig, nwins, noverlap)

    if nwins >= nsig:
        Navr = 1
        nwins = nsig
    nfft = nwins
    Nnyquist = seg.get_nnyquist(nfft)

    # --- window + norms (reference :231-246)
    win, winparams = windows(windowfunction, nwins=nwins, verbose=verbose,
                             msgout=True, **({"beta": kwargs["beta"]}
                                             if "beta" in kwargs else {}))

    fftinfo = fftinfosc()
    fftinfo.win = win
    fftinfo.winparams = winparams
    fftinfo.windowoverlap = windowoverlap
    fftinfo.ibnds = [i0, i1]
    fftinfo.S1 = seg.get_s1(win)
    fftinfo.S2 = seg.get_s2(win)
    fftinfo.NENBW = seg.get_nenbw(Nnyquist, fftinfo.S1, fftinfo.S2)
    fftinfo.ENBW = seg.get_enbw(Fs, fftinfo.S1, fftinfo.S2)

    detrend = detrend_func(detrend_style)

    # --- analyzed spans (reference :282-283, :346-354)
    if nTmodel:
        x_in = sigx
        y_in = sigy[i0:i1, :]
    else:
        x_in = sigx[i0:i1]
        y_in = sigy[i0:i1, :]

    # clamp Navr so all segments fit the analyzed span (see docstring)
    max_navr = seg.get_navr(y_in.shape[0], nwins, noverlap)
    if Navr > max_navr:
        Navr = max_navr

    if useMLAB:
        sides = "onesided" if onesided else "twosided"
        if verbose:
            print("using the independent NumPy oracle path for spectra")

        def _det(d):
            return np.asarray(detrend(np.asarray(d), axis=0))

        xm = x_in
        if nTmodel:
            while xm.shape[0] < y_in.shape[0]:
                xm = np.r_[xm, xm[-1:-nwins:-1]]
            if xm.shape[0] > y_in.shape[0]:
                xm = xm[:y_in.shape[0]]
        Pxx, freq = csd_oracle(xm, xm, nfft, fs=Fs, detrend=_det, window=win,
                               noverlap=noverlap, sides=sides)
        Pyy = np.zeros((nch, len(freq)), dtype=np.float64)
        Pxy = np.zeros((nch, len(freq)), dtype=np.complex128)
        for ii in range(nch):
            pyy_ii, _ = csd_oracle(y_in[:, ii], y_in[:, ii], nfft, fs=Fs,
                                   detrend=_det, window=win,
                                   noverlap=noverlap, sides=sides)
            Pyy[ii, :] = pyy_ii.real
            Pxy[ii, :], _ = csd_oracle(xm, y_in[:, ii], nfft, fs=Fs,
                                       detrend=_det, window=win,
                                       noverlap=noverlap, sides=sides)
        if onesided:
            freq = freq[:Nnyquist]
            Pxx = Pxx[:Nnyquist]
            Pyy = Pyy[:, :Nnyquist]
            Pxy = Pxy[:, :Nnyquist]
        Pyy = Pyy.T
        Pxy = Pxy.T
    elif mesh is not None:
        # distributed path: time-sharded halo-exchange Welch over a device
        # mesh; identical normalization contract as the single-device core
        from . import parallel as par
        if mesh == "auto":
            import jax as _jax
            mesh = par.make_mesh(ch=1, t=len(_jax.devices()))
        if verbose:
            print(f"using the sharded Welch pipeline over mesh "
                  f"{dict(mesh.shape)}")
        plan = seg.SegmentPlan(nsig=int(y_in.shape[0]), nwins=int(nwins),
                               noverlap=int(noverlap), navr=int(Navr),
                               nfft=int(nfft), nnyquist=int(Nnyquist))
        freq, Pxx, Pyy_s, Pxy_s = par.welch_psd_sharded(
            np.ascontiguousarray(x_in), np.ascontiguousarray(y_in.T),
            win, plan, Fs, mesh, onesided=bool(onesided),
            detrend_style=int(detrend_style), fft_backend=fft_backend,
            ntmodel=bool(nTmodel))
        Pyy = Pyy_s.T
        Pxy = Pxy_s.T
        if nTmodel:
            # the nT-model broadcasts one reference frame — single-device
            # recompute is fine (the frame is one window long)
            fftinfo._defer_segments(_make_segment_fill(
                x_in, y_in, win, fftinfo.S1 ** 2 * fftinfo.ENBW,
                navr=int(Navr), nwins=int(nwins), noverlap=int(noverlap),
                nfft=int(nfft), nnyquist=int(Nnyquist),
                onesided=bool(onesided), detrend_style=int(detrend_style),
                ntmodel=True))
        else:
            # per-segment arrays computed where the samples live — the
            # reference contract without requiring x to fit one chip
            fftinfo._defer_segments(_make_segment_fill_sharded(
                x_in, y_in, win, fftinfo.S1 ** 2 * fftinfo.ENBW, mesh, Fs,
                navr=int(Navr), nwins=int(nwins), noverlap=int(noverlap),
                nfft=int(nfft), nnyquist=int(Nnyquist),
                onesided=bool(onesided),
                detrend_style=int(detrend_style)))
    else:
        if verbose:
            print("using the batched device Welch pipeline "
                  f"({resolve_fft_backend(fft_backend)} transform path)")
        out = _run_welch_core(
            x_in, y_in, win, fftinfo.S1 ** 2 * fftinfo.ENBW,
            backend=resolve_fft_backend(fft_backend),
            navr=int(Navr), nwins=int(nwins), noverlap=int(noverlap),
            nfft=int(nfft), nnyquist=int(Nnyquist), onesided=bool(onesided),
            detrend_style=int(detrend_style), ntmodel=bool(nTmodel))

        freq = np.fft.fftfreq(nfft, 1.0 / Fs)
        freq = freq[:Nnyquist] if onesided else np.fft.fftshift(freq)

        Pxx = out["Pxx"]
        Pyy = out["Pyy"]
        Pxy = out["Pxy"]
        fftinfo.Pxx_seg = out["Pxx_seg"]
        fftinfo.Pyy_seg = out["Pyy_seg"]
        fftinfo.Pxy_seg = out["Pxy_seg"]
        fftinfo.Xfft_seg = out["Xfft_seg"]
        fftinfo.Yfft_seg = out["Yfft_seg"]
        fftinfo.phixy_seg = np.angle(out["Pxy_seg"])
        fftinfo.varphi_seg = np.zeros_like(fftinfo.phixy_seg)

    # ---------------- shared finalization (host, reference :489-648) -------
    Pxx = np.asarray(Pxx)
    Pyy = np.asarray(Pyy)
    Pxy = np.asarray(Pxy)
    Cxy, Cxy2 = Cxy_Cxy2(Pxx, Pyy, Pxy)

    # Bendat'78-derived coherence variance (reference :496-498)
    fftinfo.varCxy = ((1.0 - Cxy * np.conj(Cxy)) / np.sqrt(2 * Navr)) ** 2.0
    fftinfo.varCxy2 = 4.0 * Cxy2 * fftinfo.varCxy

    fftinfo.varPxx = (Pxx / np.sqrt(Navr)) ** 2.0
    fftinfo.varPyy = (Pyy / np.sqrt(Navr)) ** 2.0
    fftinfo.varPxy = (Pxy / np.sqrt(Navr)) ** 2.0

    # A.E. White, Phys. Plasmas 17 056103 (2010) phase variance; reference :514
    # evaluates to sqrt(1-|C2|) / (2 Navr sqrt(|C2|)) via operator precedence
    with np.errstate(divide="ignore", invalid="ignore"):
        fftinfo.varPhxy = (np.sqrt(1.0 - np.abs(Cxy2))
                           / (2.0 * Navr * np.sqrt(np.abs(Cxy2))))

    phi_xy = np.arctan2(Pxy.imag, Pxy.real)

    # Linear amplitude spectra (reference :526-540)
    Lxx = np.sqrt(np.abs(fftinfo.ENBW * Pxx))
    Lyy = np.sqrt(np.abs(fftinfo.ENBW * Pyy))
    Lxy = np.sqrt(np.abs(fftinfo.ENBW * Pxy))
    if onesided:
        amp = _onesided_amp_scale(nfft, Nnyquist)
        Lxx = Lxx * amp
        Lyy = Lyy * amp[:, None]
        Lxy = Lxy * amp[:, None]
    fftinfo.Lxx, fftinfo.Lyy, fftinfo.Lxy = Lxx, Lyy, Lxy

    # Lag-domain correlations from the spectra (reference :544-597)
    if onesided:
        inv = 1.0 / _onesided_power_scale(nfft, Nnyquist)

        def _to_lags(P):
            sc = inv if P.ndim == 1 else inv[:, None]
            return np.fft.irfft(P * sc, n=nfft, axis=0)

        Rxx = _to_lags(Pxx)
        Ryy = _to_lags(Pyy)
        Rxy = _to_lags(Pxy)
        iCxy = np.fft.irfft(Cxy, n=nfft, axis=0)
    else:
        def _to_lags2(P):
            return np.fft.ifft(np.fft.ifftshift(P, axes=0), n=nfft, axis=0)

        Rxx = _to_lags2(Pxx)
        Ryy = _to_lags2(Pyy)
        Rxy = _to_lags2(Pxy)
        iCxy = _to_lags2(Cxy)

    rt = np.sqrt(nfft)
    Rxx = Rxx * rt
    Ryy = Ryy * rt
    Rxy = Rxy * rt
    iCxy = iCxy * rt

    Ex = Rxx[0, ...].copy()
    Ey = Ryy[0, ...].copy()
    corrcoef = Rxy / np.sqrt(Ex * Ey)

    fftinfo.Rxx = np.fft.fftshift(Rxx, axes=0)
    fftinfo.Ryy = np.fft.fftshift(Ryy, axes=0)
    fftinfo.Rxy = np.fft.fftshift(Rxy, axes=0)
    fftinfo.iCxy = np.fft.fftshift(iCxy, axes=0)
    fftinfo.corrcoef = np.fft.fftshift(corrcoef, axes=0)
    fftinfo.Ex = Ex
    fftinfo.Ey = Ey
    fftinfo.lags = (np.arange(1, nfft + 1) - Nnyquist) / Fs

    with np.errstate(divide="ignore", invalid="ignore"):
        fftinfo.varLxx = (Lxx ** 2) * (fftinfo.varPxx / np.abs(Pxx) ** 2)
        fftinfo.varLyy = (Lyy ** 2) * (fftinfo.varPyy / np.abs(Pyy) ** 2)
        fftinfo.varLxy = (Lxy ** 2) * (fftinfo.varPxy / np.abs(Pxy) ** 2)

    if nch == 1:
        Pyy = Pyy.flatten()
        Pxy = Pxy.flatten()
        Cxy = Cxy.flatten()
        Cxy2 = Cxy2.flatten()
        phi_xy = phi_xy.flatten()
        for name in ("Rxx", "Ryy", "Rxy", "corrcoef", "iCxy", "Lxx", "Lyy",
                     "Lxy", "varLxx", "varLyy", "varLxy", "varCxy", "varCxy2",
                     "varPxx", "varPyy", "varPxy", "varPhxy"):
            setattr(fftinfo, name, np.asarray(getattr(fftinfo, name)).flatten())
        fftinfo.lags = fftinfo.lags.flatten()

    fftinfo.nch = nch
    fftinfo.Fs = Fs
    fftinfo.Navr = Navr
    fftinfo.nwins = nwins
    fftinfo.nfft = nfft
    fftinfo.Nnyquist = Nnyquist
    fftinfo.noverlap = noverlap
    fftinfo.overlap = windowoverlap
    fftinfo.window = windowfunction
    fftinfo.minFreq = 2.0 * Fs / nwins
    fftinfo.freq = freq
    fftinfo.Pxx = Pxx
    fftinfo.Pyy = Pyy
    fftinfo.Pxy = Pxy
    fftinfo.Cxy = Cxy
    fftinfo.Cxy2 = Cxy2
    fftinfo.phi_xy = phi_xy

    if plotit:  # pragma: no cover - plotting side effects
        from . import plotting
        plotting.plot_pwelch_summary(tvec, sigx, sigy, tbounds, freq, Pxx,
                                     Pyy, Pxy, Cxy2, phi_xy, fftinfo,
                                     onesided=onesided, reflecting=reflecting,
                                     nwins=nwins, navr=Navr, **kwargs)

    return freq, Pxy, Pxx, Pyy, Cxy, phi_xy, fftinfo
