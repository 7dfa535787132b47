"""Object-style spectral analysis API (parity with the reference ``fftanal``).

The reference exposes two entry styles: the function ``fft_pwelch`` and the
stateful class ``fftanal`` (reference ``fft_analysis.py:1695-2887``).  The
class path scales *FFT coefficients* by ``sqrt(2)/S1/sqrt(ENBW)`` before
squaring (reference ``fft_win``, ``:2179-2202``) — equivalent PSDs but a
different intermediate convention; both are preserved here.

Device-first: this class is a thin stateful wrapper; all segment math runs in
a single jitted, batched pipeline with two transform paths ('xla' complex fft,
the default; 'mxu' real-pair matmul DFTs on request).  The per-segment Python
loop of the reference (``:2156-2176``) does not exist.  The O(nfreq)
post-processing (coherence, averaging, lag transforms) runs in host NumPy.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .utils.structure import Struct
from .utils.detrend import detrend_func
from .windows import windows
from . import segmentation as seg
from .ops import mxu_fft
from .spectral import (fft_pwelch, Cxy_Cxy2, _onesided_amp_scale,
                       _onesided_power_scale, resolve_fft_backend)


__all__ = ["fftanal", "stft_segments"]


@partial(jax.jit, static_argnames=("navr", "nwins", "noverlap", "nfft",
                                   "nnyquist", "onesided", "detrend_style",
                                   "detrendwin"))
def _stft_core_xla(x, tvec, win, s1, s2, sqrt_enbw, *, navr, nwins, noverlap,
                   nfft, nnyquist, onesided, detrend_style, detrendwin):
    """Complex-dtype batched STFT with ``fft_win`` coefficient scaling."""
    det = detrend_func(detrend_style)
    if not detrendwin:
        x = det(x, axis=-1)
    hop = nwins - noverlap
    xfr = seg.frame_signal(x, nwins, hop, navr)        # (..., navr, nwins)
    tfr = seg.frame_signal(tvec, nwins, hop, navr)     # (navr, nwins)
    if detrendwin:
        xfr = det(xfr, axis=-1)
    w = win.astype(xfr.real.dtype)
    xw = xfr * w
    tt = jnp.mean(tfr, axis=-1)
    pseg = jnp.trapezoid((xw * jnp.conj(xw)).real, x=tfr, axis=-1) / s2
    X = jnp.fft.fft(xw, n=nfft, axis=-1)
    if onesided:
        amp = jnp.asarray(_onesided_amp_scale(nfft, nnyquist), dtype=X.real.dtype)
        X = X[..., :nnyquist] * amp
    else:
        X = jnp.fft.fftshift(X, axes=-1)
    X = X / (s1 * sqrt_enbw)
    return tt, X, pseg


@partial(jax.jit, static_argnames=("navr", "nwins", "noverlap", "nfft",
                                   "nnyquist", "onesided", "detrend_style",
                                   "detrendwin"))
def _stft_core_mxu(xr, xi, tvec, win, s1, s2, sqrt_enbw, *, navr, nwins,
                   noverlap, nfft, nnyquist, onesided, detrend_style,
                   detrendwin):
    """Real-pair batched STFT (no complex dtype anywhere)."""
    det = detrend_func(detrend_style)
    if not detrendwin:
        xr = det(xr, axis=-1)
        xi = None if xi is None else det(xi, axis=-1)
    hop = nwins - noverlap
    fr = seg.frame_signal(xr, nwins, hop, navr)
    fi = None if xi is None else seg.frame_signal(xi, nwins, hop, navr)
    tfr = seg.frame_signal(tvec, nwins, hop, navr)
    if detrendwin:
        fr = det(fr, axis=-1)
        fi = None if fi is None else det(fi, axis=-1)
    w = win.astype(fr.dtype)
    fr = fr * w
    fi = None if fi is None else fi * w
    tt = jnp.mean(tfr, axis=-1)
    mag2 = fr * fr if fi is None else fr * fr + fi * fi
    pseg = jnp.trapezoid(mag2, x=tfr, axis=-1) / s2
    Xr, Xi = mxu_fft.fft_pair(fr, fi, n=nfft, axis=-1)
    if onesided:
        amp = jnp.asarray(_onesided_amp_scale(nfft, nnyquist), dtype=Xr.dtype)
        Xr = Xr[..., :nnyquist] * amp
        Xi = Xi[..., :nnyquist] * amp
    else:
        Xr = jnp.fft.fftshift(Xr, axes=-1)
        Xi = jnp.fft.fftshift(Xi, axes=-1)
    scale = 1.0 / (s1 * sqrt_enbw)
    return tt, Xr * scale, Xi * scale, pseg


def stft_segments(x, tvec, win, plan: seg.SegmentPlan, fs, *, onesided=True,
                  detrend_style=1, detrendwin=False, fft_backend=None):
    """Functional STFT entry: returns ``(tt, freq, Xfft, pseg)`` (numpy).

    Matches the reference ``fftanal.fft_win`` contract
    (``fft_analysis.py:2126-2203``) with batched execution; ``Xfft`` is
    complex on the host regardless of the device transform path.
    """
    win_np = np.asarray(win)
    s1 = seg.get_s1(win_np)
    s2 = seg.get_s2(win_np)
    enbw = seg.get_enbw(fs, s1, s2)
    static = dict(navr=plan.navr, nwins=plan.nwins, noverlap=plan.noverlap,
                  nfft=plan.nfft, nnyquist=plan.nnyquist,
                  onesided=bool(onesided), detrend_style=int(detrend_style),
                  detrendwin=bool(detrendwin))
    backend = resolve_fft_backend(fft_backend)
    x = np.asarray(x)
    if backend == "xla":
        tt, X, pseg = _stft_core_xla(
            jnp.asarray(x), jnp.asarray(tvec), jnp.asarray(win_np),
            jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(np.sqrt(enbw)),
            **static)
        X = np.asarray(X)
    else:
        if np.iscomplexobj(x):
            xr = jnp.asarray(np.ascontiguousarray(x.real))
            xi = jnp.asarray(np.ascontiguousarray(x.imag))
        else:
            xr, xi = jnp.asarray(x), None
        tt, Xr, Xi, pseg = _stft_core_mxu(
            xr, xi, jnp.asarray(tvec), jnp.asarray(win_np),
            jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(np.sqrt(enbw)),
            **static)
        X = np.asarray(Xr) + 1j * np.asarray(Xi)
    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    freq = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return np.asarray(tt), freq, X, np.asarray(pseg)


class fftanal(Struct):
    """Stateful spectral-analysis pipeline (reference-class API).

    Usage matches the reference: construct with ``(tvec, sigx[, sigy],
    **kwargs)``, then call :meth:`pwelch` / :meth:`stft` /
    :meth:`fftpwelch` / :meth:`crosscorr` / :meth:`convert2amplitudes`.
    """

    afont = {"fontsize": 14}

    def __init__(self, tvec=None, sigx=None, sigy=None, **kwargs):
        self.verbose = kwargs.get("verbose", True)
        if tvec is None or sigx is None:
            if self.verbose:
                print("Please give at least a time-vector [s]"
                      " and a signal vector [a.u.]")
            return
        self.init(tvec, sigx, sigy, **kwargs)

    # ------------------------------------------------------------------ #
    # configuration (reference fft_analysis.py:1713-1783)
    # ------------------------------------------------------------------ #

    def init(self, tvec=None, sigx=None, sigy=None, **kwargs):
        self.nosigy = sigy is None or sigy is sigx

        tvec = np.asarray(tvec)
        sigx = np.asarray(sigx)
        self.tvec = tvec
        self.sigx = sigx
        self.sigy = None if sigy is None else np.asarray(sigy)

        self.tbounds = kwargs.get("tbounds", [tvec.min(), tvec.max()])
        self.useMLAB = kwargs.get("useMLAB", False)
        self.plotit = kwargs.get("plotit", False)
        self.verbose = kwargs.get("verbose", True)
        self.Navr = kwargs.get("Navr", None)
        self.window = kwargs.get("windowfunction", "Hanning")
        if self.window is None:
            self.window = "Hanning"
        self.overlap = kwargs.get("windowoverlap",
                                  windows(self.window, verbose=False))
        self.tvecy = kwargs.get("tvecy", None)
        self.onesided = kwargs.get("onesided", None)
        self.detrendstyle = kwargs.get("detrend", 1)
        self.frange = kwargs.get("frange", None)
        self.axes = kwargs.get("axes", -1)
        self.fft_backend = kwargs.get("fft_backend", None)

        if self.onesided is None:
            self.onesided = not (np.iscomplexobj(sigx)
                                 or (self.sigy is not None
                                     and np.iscomplexobj(self.sigy)))

        if self.tvecy is not None:
            self.tvec, self.sigx, self.sigy = self.resample(
                tvec, sigx, self.tvecy, self.sigy)

        self.Fs = self.__Fs__(self.tvec)
        self.ibounds = self.__ibounds__(self.tvec, self.tbounds)
        self.nsig = np.size(self.__trimsig__(self.tvec, self.ibounds))

        calcNavr = False
        if self.Navr is None:
            calcNavr = True
            self.Navr = 8

        if "minFreq" in kwargs:
            kwargs["tper"] = 2.0 / kwargs["minFreq"]
        if "tper" in kwargs:
            self.tper = kwargs["tper"]
            self.nwins = int(self.Fs * self.tper)
        else:
            calcNavr = False
            self.nwins = self.getNwins()
        self.noverlap = self.getNoverlap()
        if calcNavr:
            self.Navr = self.getNavr()
        # clamp so all segments index inside the trimmed span
        self.Navr = min(self.Navr,
                        seg.get_navr(self.nsig, self.nwins, self.noverlap))
        self.nfft = self.nwins
        self.win, self.winparams = self.makewindowfn(self.window, self.nwins,
                                                     self.verbose)
        self.getNnyquist()
        self.getNorms()

    def update(self, d=None):
        if d is not None:
            if not isinstance(d, dict):
                d = d.dict_from_class()
            # the lazy-segment closure stays on the fftinfo container;
            # __getattr__ below delegates segment-field access to it
            d = {k: v for k, v in d.items() if k != "_lazy_segments"}
            self.__dict__.update(d)

    def __getattr__(self, name):
        # Fast-path fft_pwelch results keep the per-segment arrays lazy on
        # the fftinfo container (see spectral.fftinfosc); after
        # fftpwelch()'s update() the fields are absent HERE, so the first
        # touch delegates to fftinfo (triggering its recompute) and caches
        # every filled field on self — preserving the reference contract
        # that fftanal exposes P??_seg/?fft_seg after fftpwelch().
        from .spectral import _SEGMENT_FIELDS
        if name != "fftinfo" and name in _SEGMENT_FIELDS:
            info = self.__dict__.get("fftinfo")
            if info is not None:
                getattr(info, name)             # may trigger the lazy fill
                for f in _SEGMENT_FIELDS:
                    if f in info.__dict__:
                        self.__dict__[f] = info.__dict__[f]
                if name in self.__dict__:
                    return self.__dict__[name]
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}")

    # ------------------------------------------------------------------ #
    # pipelines
    # ------------------------------------------------------------------ #

    def fftpwelch(self):
        """Run the function-style pipeline and merge its outputs."""
        self.freq, self.Pxy, self.Pxx, self.Pyy, self.Cxy, self.phi_xy, \
            self.fftinfo = fft_pwelch(
                self.tvec, self.sigx, self.sigy, self.tbounds,
                Navr=self.Navr, windowoverlap=self.overlap,
                windowfunction=self.window, useMLAB=self.useMLAB,
                plotit=self.plotit, verbose=self.verbose,
                detrend_style=self.detrendstyle, onesided=self.onesided,
                fft_backend=self.fft_backend)
        self.update(self.fftinfo)

    def stft(self):
        """Short-time Fourier analysis (one call, batched).

        ``useMLAB=True`` selects the independent ``scipy.signal.stft``
        oracle with the reference's conventions (reference
        ``fft_analysis.py:1815-1823``: ``boundary='zeros', padded=True``,
        scipy's ``1/S1`` coefficient scaling); otherwise the batched
        device pipeline runs.
        """
        if not self.useMLAB:
            self.pwelch()
            return
        import scipy.signal as _dsp

        onesided = bool(self.onesided)
        if isinstance(self.onesided, str):
            onesided = "two" not in self.onesided
        # repo-wide detrend convention: >0 mean, <0 linear, 0 none
        # (utils/detrend.py) — keep the oracle consistent with it
        detrend = ("constant" if self.detrendstyle > 0 else
                   "linear" if self.detrendstyle < 0 else False)
        self.freq, self.tseg, Xseg = _dsp.stft(
            self.sigx, fs=self.Fs, window=self.win, nperseg=self.nwins,
            noverlap=self.noverlap, nfft=self.nfft, detrend=detrend,
            return_onesided=onesided, boundary="zeros", padded=True,
            axis=self.axes)
        # segment-major layout: the rest of the class treats axis 0 as the
        # segment axis (Pstft/averagewins/crosscorr_stft).  The reference
        # stores scipy's (nfreq, nseg) array raw, which silently makes its
        # own averagewins average over frequency — a latent defect the
        # SURVEY excludes from the behavior contract (SURVEY §4).
        self.Xseg = np.moveaxis(Xseg, -1, 0)
        if not self.nosigy:
            _, _, Yseg = _dsp.stft(
                self.sigy, fs=self.Fs, window=self.win, nperseg=self.nwins,
                noverlap=self.noverlap, nfft=self.nfft, detrend=detrend,
                return_onesided=onesided, boundary="zeros", padded=True,
                axis=self.axes)
            self.Yseg = np.moveaxis(Yseg, -1, 0)
        self.Pstft()
        self.averagewins()

    def pwelch(self):
        self.Xstft()
        if not self.nosigy:
            self.Ystft()
        self.Pstft()
        self.averagewins()

    # ---------------- segment transforms ------------------------------ #

    def _plan(self):
        return seg.SegmentPlan(nsig=self.nsig, nwins=self.nwins,
                               noverlap=self.noverlap, navr=self.Navr,
                               nfft=self.nfft, nnyquist=self.Nnyquist)

    def fft_win(self, sig, tvec=None, detrendwin=False):
        """Windowed segment FFTs with coefficient scaling (reference :2126)."""
        if tvec is None:
            tvec = np.linspace(0.0, 1.0, len(sig))
        fs = self.__Fs__(tvec)
        tt, freq, X, pseg = stft_segments(
            sig, tvec, self.win, self._plan(), fs, onesided=self.onesided,
            detrend_style=self.detrendstyle, detrendwin=detrendwin,
            fft_backend=self.fft_backend)
        self.tper = float(tvec[min(self.nwins, len(tvec) - 1)] - tvec[0])
        return tt, freq, X, pseg

    def Xstft(self):
        sig = self.__trimsig__(self.sigx, self.ibounds)
        tvec = self.__trimsig__(self.tvec, self.ibounds)
        self.tseg, self.freq, self.Xseg, self.Xpow = self.fft_win(sig, tvec)
        self.Xfft = np.mean(self.Xseg, axis=0)
        return self.freq, self.Xseg

    def Ystft(self):
        sig = self.__trimsig__(self.sigy, self.ibounds)
        tvec = self.__trimsig__(self.tvec, self.ibounds)
        self.tseg, self.freq, self.Yseg, self.Ypow = self.fft_win(sig, tvec)
        self.Yfft = np.mean(self.Yseg, axis=0)
        return self.freq, self.Yseg

    def Pstft(self):
        """Per-segment spectra from the scaled segment FFTs (reference :1944).

        Note the class-path cross-spectrum convention is
        ``Pxy = X conj(Y)`` (reference ``:1960``) — opposite phase sign to the
        function path's ``Y conj(X)`` (reference ``:393``); both preserved.
        """
        if hasattr(self, "Xseg"):
            self.Pxx_seg = self.Xseg * np.conj(self.Xseg)
            self.Lxx_seg = np.sqrt(np.abs(self.ENBW * self.Pxx_seg))
            if self.onesided:
                self.Lxx_seg = np.sqrt(2) * self.Lxx_seg
        if hasattr(self, "Yseg"):
            self.Pyy_seg = self.Yseg * np.conj(self.Yseg)
            self.Lyy_seg = np.sqrt(np.abs(self.ENBW * self.Pyy_seg))
            if self.onesided:
                self.Lyy_seg = np.sqrt(2) * self.Lyy_seg
        if hasattr(self, "Xseg") and hasattr(self, "Yseg"):
            self.Pxy_seg = self.Xseg * np.conj(self.Yseg)
            self.Lxy_seg = np.sqrt(np.abs(self.ENBW * self.Pxy_seg))
            if self.onesided:
                self.Lxy_seg = np.sqrt(2) * self.Lxy_seg
            self.phixy_seg = np.angle(self.Pxy_seg)
            self.Cxy_seg, self.Cxy2_seg = Cxy_Cxy2(self.Pxx_seg,
                                                   self.Pyy_seg, self.Pxy_seg)

    def averagewins(self):
        """Average per-segment spectra; propagate variances (reference :1975)."""
        for param in ["Pxx", "Pyy", "Pxy"]:
            if hasattr(self, param + "_seg"):
                mean = np.mean(getattr(self, param + "_seg"), axis=0)
                setattr(self, param, mean)
                setattr(self, "var" + param, (mean / np.sqrt(self.Navr)) ** 2.0)
        if hasattr(self, "Pxy"):
            self.phi_xy = np.angle(self.Pxy)
            self.Cxy, self.Cxy2 = Cxy_Cxy2(self.Pxx, self.Pyy, self.Pxy)
            with np.errstate(divide="ignore", invalid="ignore"):
                self.varPhxy = (np.sqrt(1.0 - self.Cxy2)
                                / np.sqrt(2.0 * self.Navr * self.Cxy)) ** 2.0
            self.varCxy = ((1 - self.Cxy2) / np.sqrt(2 * self.Navr)) ** 2.0
            self.varCxy2 = 4.0 * self.Cxy2 * self.varCxy

    # ---------------- lag-domain (reference :1840-1920) ---------------- #

    def crosscorr(self):
        nfft = self.nwins
        for param in ["Pxx", "Pyy", "Pxy"]:
            if hasattr(self, param):
                tmp = self._spectrum_to_lags(getattr(self, param), nfft)
                if param == "Pxx":
                    self.Ex = tmp[..., 0].copy()
                if param == "Pyy":
                    self.Ey = tmp[..., 0].copy()
                setattr(self, "R" + param[1:], np.fft.fftshift(tmp, axes=-1))
        if hasattr(self, "Rxy"):
            self.corrcoef = self.Rxy / np.sqrt(self.Ex * self.Ey)
        self.lags = (np.arange(1, nfft + 1) - self.Nnyquist) / self.Fs

    def crosscorr_stft(self):
        nfft = self.nwins
        for param in ["Pxx_seg", "Pyy_seg", "Pxy_seg"]:
            if hasattr(self, param):
                tmp = self._spectrum_to_lags(getattr(self, param), nfft)
                if param.startswith("Pxx"):
                    self.Ex_seg = tmp[..., 0].copy()
                if param.startswith("Pyy"):
                    self.Ey_seg = tmp[..., 0].copy()
                setattr(self, "R" + param[1:], np.fft.fftshift(tmp, axes=-1))
        if hasattr(self, "Rxy_seg"):
            self.corrcoef_seg = self.Rxy_seg / np.sqrt(
                self.Ex_seg * self.Ey_seg)[..., None]
        self.lags = (np.arange(1, nfft + 1) - self.Nnyquist) / self.Fs

    def _spectrum_to_lags(self, P, nfft):
        """One/two-sided spectrum -> sqrt(nfft)-scaled lag correlations
        (reference :1846-1860)."""
        P = np.asarray(P)
        if self.onesided:
            inv = 1.0 / _onesided_power_scale(nfft, self.Nnyquist)
            return np.sqrt(nfft) * np.fft.irfft(P * inv, n=nfft, axis=-1)
        tmp = np.fft.ifftshift(P, axes=-1)
        return np.sqrt(nfft) * np.fft.ifft(tmp, n=nfft, axis=-1)

    # ---------------- conversions (reference :2022-2086) --------------- #

    def convert2amplitudes(self):
        """PSD -> linear amplitude spectra (reference :2022-2048)."""
        amp = _onesided_amp_scale(self.nfft, self.Nnyquist)
        for param in ["Pxx", "Pyy", "Pxy"]:
            if hasattr(self, param):
                tmp = np.sqrt(np.abs(self.ENBW * np.asarray(getattr(self, param))))
                if self.onesided:
                    tmp = tmp * amp
                setattr(self, "L" + param[1:], tmp)
                with np.errstate(divide="ignore", invalid="ignore"):
                    setattr(self, "varL" + param[1:],
                            (tmp ** 2) * (np.asarray(getattr(self, "var" + param))
                                          / np.abs(np.asarray(getattr(self, param))) ** 2))

    def integrate_spectra(self):
        from .integrate import integratespectra
        self.integrated = Struct()
        (self.integrated.Pxy, self.integrated.Pxx, self.integrated.Pyy,
         self.integrated.Cxy, self.integrated.ph, self.integrated.info) = \
            integratespectra(self.freq, self.Pxy, self.Pxx, self.Pyy,
                             self.frange, self.varPxy, self.varPxx,
                             self.varPyy)

    # ---------------- small helpers (reference :2092-2124) ------------- #

    def detrend(self, sig):
        return np.asarray(detrend_func(self.detrendstyle)(np.asarray(sig),
                                                          axis=-1))

    def fft(self, sig, nfft=None, axes=None):
        if axes is None:
            axes = self.axes
        if nfft is None:
            nfft = self.nfft
        return np.fft.fft(np.asarray(sig), n=nfft, axis=axes)

    def ifft(self, sig, nfft=None, axes=None):
        if axes is None:
            axes = self.axes
        if nfft is None:
            nfft = self.nfft
        return np.fft.ifft(np.asarray(sig), n=nfft, axis=axes)

    def fftshift(self, sig, axes=None):
        if axes is None:
            axes = self.axes
        return np.fft.fftshift(np.asarray(sig), axes=axes)

    def ifftshift(self, sig, axes=None):
        if axes is None:
            axes = self.axes
        return np.fft.ifftshift(np.asarray(sig), axes=axes)

    # ---------------- statics (reference :2363-2510) ------------------- #

    @staticmethod
    def resample(tvx, sigx, tvy, sigy):
        from .filters import upsample
        Fsx = fftanal.__Fs__(tvx)
        Fsy = fftanal.__Fs__(tvy)
        if len(sigx) > len(sigy):
            sigy = upsample(sigy, Fsy, Fsx)
            tvec = tvx
        elif len(sigy) > len(sigx):
            sigx = upsample(sigx, Fsx, Fsy)
            tvec = tvy
        else:
            tvec = tvx
        return tvec, sigx, sigy

    @staticmethod
    def __Fs__(tvec):
        return (len(tvec) - 1) / (tvec[-1] - tvec[0])

    @staticmethod
    def __ibounds__(tvec, tbounds):
        fs = fftanal.__Fs__(tvec)
        ib1 = int(np.floor((tbounds[0] - tvec[0]) * fs))
        ib2 = int(np.floor(1 + (tbounds[1] - tvec[0]) * fs))
        return [ib1, ib2]

    @staticmethod
    def __trimsig__(sigt, ibounds):
        return sigt[ibounds[0]:ibounds[1]]

    @staticmethod
    def makewindowfn(windowfunction, nwins, verbose=True):
        return windows(windowfunction, nwins=nwins, verbose=verbose,
                       msgout=True)

    _getNwins = staticmethod(seg.get_nwins)
    _getNoverlap = staticmethod(seg.get_noverlap)
    _getNavr = staticmethod(seg.get_navr)
    _getMINoverlap = staticmethod(seg.get_min_overlap)
    _getMAXoverlap = staticmethod(seg.get_max_overlap)
    _checkCOLA = staticmethod(seg.check_cola)
    _getNnyquist = staticmethod(seg.get_nnyquist)
    _getS1 = staticmethod(seg.get_s1)
    _getS2 = staticmethod(seg.get_s2)
    _getNENBW = staticmethod(seg.get_nenbw)
    _getENBW = staticmethod(seg.get_enbw)
    _getNorms = staticmethod(seg.get_norms)
    _detrend_func = staticmethod(detrend_func)

    def getNavr(self):
        self.Navr = seg.get_navr(self.nsig, self.nwins, self.noverlap)
        return self.Navr

    def getNwins(self):
        self.nwins = seg.get_nwins(self.nsig, self.Navr, self.overlap)
        return self.nwins

    def getNoverlap(self):
        self.noverlap = seg.get_noverlap(self.nwins, self.overlap)
        return self.noverlap

    def getNnyquist(self):
        self.Nnyquist = seg.get_nnyquist(self.nwins)
        return self.Nnyquist

    def getNorms(self):
        self.S1, self.S2, self.NENBW, self.ENBW = seg.get_norms(
            self.win, self.Nnyquist, self.Fs)

    @staticmethod
    def _fft_win(sig, **kwargs):
        """Instance-free windowed segment FFT (reference :2554-2640): the
        same contract as :meth:`fft_win`, with the segmentation plan and
        window supplied as keywords instead of instance state.

        Required: ``win``, ``nwins``, ``Navr``, ``noverlap``, ``Nnyquist``.
        Optional: ``tvec``, ``Fs``, ``onesided``, ``detrend_style``,
        ``detrendwin``, ``fft_backend``.  Returns ``(tt, freq, Xfft, pseg)``.
        """
        sig = np.asarray(sig)
        tvec = kwargs.get("tvec", None)
        if tvec is None:
            tvec = np.linspace(0.0, 1.0, len(sig))
        fs = kwargs.get("Fs", fftanal.__Fs__(tvec))
        nwins = int(kwargs["nwins"])
        plan = seg.SegmentPlan(
            nsig=len(sig), nwins=nwins, noverlap=int(kwargs["noverlap"]),
            navr=int(kwargs["Navr"]), nfft=nwins,
            nnyquist=int(kwargs["Nnyquist"]))
        return stft_segments(
            sig, tvec, kwargs["win"], plan, fs,
            onesided=kwargs.get("onesided", False),
            detrend_style=kwargs.get("detrend_style", 1),
            detrendwin=kwargs.get("detrendwin", False),
            fft_backend=kwargs.get("fft_backend", None))

    @staticmethod
    def intspectra(freq, sigft, ifreq=None, ispan=None, ENBW=None):
        """Integrate a spectrum around its peak (reference :2514-2536)."""
        freq = np.asarray(freq)
        sigft = np.asarray(sigft)
        if ifreq is None:
            ifreq = int(np.argmax(np.abs(sigft), axis=0))
            if ENBW is not None:
                ispan = 2 * int(np.where(freq >= ENBW)[0][0])
            elif ispan is None:
                ispan = 6
            ilow = ifreq - ispan // 2
            ihigh = ifreq + ispan // 2
        else:
            ilow = 0
            ihigh = len(sigft)
        Isig = np.trapezoid(sigft[ilow:ihigh], freq[ilow:ihigh], axis=0)
        Ivar = np.zeros_like(Isig)
        return Isig, Ivar

    # ---------------- plotting adapters -------------------------------- #

    def __calcAmp__(self, tvec, sigx, sigy, tbounds, nn=8, ol=0.5,
                    ww="hanning"):
        """Amplitude via several Hann windows (reference
        ``fft_analysis.py:2310-2318``); stores ``frqA``/``Axx``/``Ayy``/
        ``Axy``/``aCxy`` and draws the log-amplitude panel."""
        (self.frqA, self.Axy, self.Axx, self.Ayy, self.aCxy, _,
         _) = fft_pwelch(tvec, sigx, sigy, tbounds, Navr=nn,
                         windowoverlap=ol, windowfunction=ww,
                         useMLAB=self.useMLAB, plotit=False,
                         verbose=self.verbose,
                         detrend_style=self.detrendstyle,
                         onesided=self.onesided)
        self.__plotAmp__()

    def __calcPh1__(self, tvec, sigx, sigy, tbounds, nn=1, ol=0.0,
                    ww="box"):
        """Phase via one long boxcar window (reference
        ``fft_analysis.py:2321-2329``); stores ``frqP``/``ph``."""
        (self.frqP, _, _, _, _, self.ph, _) = fft_pwelch(
            tvec, sigx, sigy, tbounds, Navr=nn, windowoverlap=ol,
            windowfunction=ww, useMLAB=self.useMLAB, plotit=False,
            verbose=self.verbose, detrend_style=self.detrendstyle,
            onesided=self.onesided)
        self.__plotPh1__()

    def __plotAmp__(self, _ax=None):  # pragma: no cover - plotting
        fftanal._plotlogAmp(self.frqA, self.Axx, self.Ayy, self.Axy,
                            afont=self.afont, _ax=_ax, scl=1e-3)

    def __plotPh1__(self, _ax=None):  # pragma: no cover - plotting
        fftanal._plotPhase(self.frqP, self.ph, afont=self.afont, _ax=_ax,
                           scl=1e-3)

    def __preallocateFFT__(self):
        """Empty-result preallocation (reference
        ``fft_analysis.py:2340-2358``)."""
        self.tvec = np.array([], dtype=np.float64)
        self.freq = np.array([], dtype=np.float64)
        for name in ("Pxy", "Pxx", "Pyy", "varPxy", "varPxx", "varPyy"):
            setattr(self, name, np.array([], dtype=np.complex128))
        for name in ("Coh", "varCoh", "phi", "varphi"):
            setattr(self, name, np.array([], dtype=np.float64))

    def plotall(self):  # pragma: no cover
        import matplotlib.pyplot as plt
        self.fig = plt.figure(figsize=(15, 15))
        self.ax1 = plt.subplot(2, 3, 1)
        self.ax2 = plt.subplot(2, 3, 2)
        self.ax3 = plt.subplot(2, 3, 3)
        self.ax4 = plt.subplot(2, 3, 4, sharex=self.ax2)
        self.ax5 = plt.subplot(2, 3, 5, sharex=self.ax3)
        self.ax6 = plt.subplot(2, 3, 6, sharex=self.ax3)
        self.plottime(_ax=self.ax1)
        self.plotCorr(_ax=self.ax2)
        self.plotPxy(_ax=self.ax3)
        self.plotspec(param="Pxy", logscale=True, _ax=self.ax4)
        self.plotCxy(_ax=self.ax5)
        self.plotphxy(_ax=self.ax6)
        plt.tight_layout()
        plt.draw()

    def plotspec(self, param="Pxy", logscale=False, _ax=None, vbnds=None,
                 cmap=None):  # pragma: no cover
        from . import plotting
        fbounds = [max(2.0 * self.Fs / self.nwins, float(np.min(np.asarray(self.freq)))),
                   min(self.Fs / 2.0, float(np.max(np.asarray(self.freq))))]
        return plotting.plot_spectrogram(
            np.asarray(self.tseg), np.asarray(self.freq),
            np.asarray(getattr(self, param + "_seg")), logscale=logscale,
            ax=_ax, vbnds=vbnds, cmap=cmap, titl=param,
            tbounds=self.tbounds, fbounds=fbounds)

    def plottime(self, _ax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        _ax.plot(self.tvec, np.asarray(self.sigx).real, "b-")
        if self.sigy is not None:
            _ax.plot(self.tvec, np.asarray(self.sigy).real, "r-")
        _ax.set_title("Input Signals", **self.afont)
        return _ax

    def plotCorr(self, _ax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        _ax.plot(1e6 * np.asarray(self.lags), np.asarray(self.corrcoef).real, "k-")
        _ax.set_ylabel(r"$\rho_{xy}$", **self.afont)
        return _ax

    @staticmethod
    def _plotCorr(lags, corr, _ax=None, scl=1e6, afont=None, titl=None,
                  xlbl="lags [us]", ylbl=None, fmt="k-"):  # pragma: no cover
        """Single lag-domain trace (reference :2721)."""
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        afont = afont or {}
        _ax.plot(scl * np.asarray(lags), np.asarray(corr).real, fmt)
        if titl:
            _ax.set_title(titl, **afont)
        if xlbl:
            _ax.set_xlabel(xlbl, **afont)
        if ylbl:
            _ax.set_ylabel(ylbl, **afont)
        return _ax

    @staticmethod
    def _plot_quantity(freq, quant, _ax=None, scl=1e-3, afont=None, titl="",
                       ylbl="", xlbl=None, fmt="k-",
                       plothandle=None):  # pragma: no cover
        """Generic frequency-axis trace (reference fft_analysis.py:2790)."""
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.subplot(1, 1, 1)
        if afont is None:
            afont = {"fontsize": 14}
        if plothandle is None:
            plothandle = _ax.plot
        if xlbl is None:
            xlbl = {1e-6: "f [MHz]", 1e-3: "f [KHz]"}.get(scl, "f [Hz]")
        freq = np.asarray(freq)
        plothandle(scl * freq, np.asarray(quant), fmt)
        if ylbl is not None:
            _ax.set_ylabel(ylbl, **afont)
        if len(xlbl) > 0:
            _ax.set_xlabel(xlbl, **afont)
        if titl is not None:
            _ax.set_title(titl, **afont)
        if _ax.get_xlim()[0] == 0 or _ax.get_xscale() == "log":
            # a log x-axis cannot hold the negative half-axis; only pin
            # the right limit there instead of letting matplotlib warn
            _ax.set_xlim(right=1.01 * scl * freq[-1])
        else:
            _ax.set_xlim(-1.01 * scl * freq[-1], 1.01 * scl * freq[-1])
        plt.draw()
        return _ax

    @staticmethod
    def _plotspec(tseg, freq, Pxy_seg, logscale=False, _ax=None, vbnds=None,
                  cmap=None, tbounds=None, titl=r"P$_{xy}$",
                  ylbl="freq [KHz]", xlbl="time [s]",
                  fbounds=None):  # pragma: no cover
        """Spectrogram heat-map panel (reference fft_analysis.py:2643)."""
        from . import plotting
        return plotting.plot_spectrogram(
            tseg, freq, Pxy_seg, logscale=logscale, ax=_ax, vbnds=vbnds,
            cmap=cmap, tbounds=tbounds, titl=titl, ylbl=ylbl, xlbl=xlbl,
            fbounds=fbounds)

    @staticmethod
    def _plotSignal(tvec, sig, _ax=None, scl=1.0, afont=None,
                    titl="Input Signal", ylbl="Signal", fmt="k-",
                    tbounds=None):  # pragma: no cover
        """Time-domain trace(s); a 2-list plots x in blue / y in red with
        dashed imaginary parts (reference fft_analysis.py:2677)."""
        pq = fftanal._plot_quantity
        xlbl = {1e6: "t [us]", 1e3: "t [ms]"}.get(scl, "t [s]")
        kw = dict(scl=scl, afont=afont, titl=titl, ylbl=ylbl, xlbl=xlbl)
        if isinstance(sig, (list, tuple)) and len(sig) == 2:
            for tv, s, c in zip(tvec, sig, ("b", "r")):
                s = np.asarray(s)
                if np.iscomplexobj(s):
                    _ax = pq(tv, s.real, _ax=_ax, fmt=c + "-", **kw)
                    _ax = pq(tv, s.imag, _ax=_ax, fmt=c + "--", **kw)
                else:
                    _ax = pq(tv, s, _ax=_ax, fmt=c + fmt[1], **kw)
        else:
            sig = np.asarray(sig)
            if np.iscomplexobj(sig):
                _ax = pq(tvec, sig.real, _ax=_ax, fmt=fmt[0] + "-", **kw)
                _ax = pq(tvec, sig.imag, _ax=_ax, fmt=fmt[0] + "--", **kw)
            else:
                _ax = pq(tvec, sig, _ax=_ax, fmt=fmt, **kw)
        if tbounds is not None:
            _ax.axvline(x=tbounds[0], color=fmt[0])
            _ax.axvline(x=tbounds[1], color=fmt[0])
        return _ax

    @staticmethod
    def _plotCoherence(freq, Cxy, _ax=None, scl=1e-3, afont=None,
                       titl="Complex Coherence", ylbl=r"|$\gamma_{xy}$|",
                       Navr=None):  # pragma: no cover
        """|gamma| with the 1/sqrt(Navr) bias floor (reference :2731)."""
        _ax = fftanal._plot_quantity(freq, np.abs(np.asarray(Cxy)), _ax=_ax,
                                     scl=scl, afont=afont, titl=titl,
                                     ylbl=ylbl, xlbl=None, fmt="k-")
        if Navr is not None:
            _ax.axhline(y=1.0 / np.sqrt(Navr), color="k")
        return _ax

    @staticmethod
    def _plotRMSCoherence(freq, Cxy2, _ax=None, scl=1e-3, afont=None,
                          titl="RMS Coherence", ylbl=r"$\gamma_{xy}$",
                          Navr=None):  # pragma: no cover
        _ax = fftanal._plot_quantity(freq, np.sqrt(np.abs(np.asarray(Cxy2))),
                                     _ax=_ax, scl=scl, afont=afont, titl=titl,
                                     ylbl=ylbl, xlbl=None, fmt="k-")
        if Navr is not None:
            _ax.axhline(y=1.0 / np.sqrt(Navr), color="k")
        return _ax

    @staticmethod
    def _plotMeanSquaredCoherence(freq, Cxy2, _ax=None, scl=1e-3, afont=None,
                                  titl="Mean Squared-Coherence",
                                  ylbl=r"$\gamma_{xy}^2$",
                                  Navr=None):  # pragma: no cover
        _ax = fftanal._plot_quantity(freq, np.abs(np.asarray(Cxy2)), _ax=_ax,
                                     scl=scl, afont=afont, titl=titl,
                                     ylbl=ylbl, xlbl=None, fmt="k-")
        if Navr is not None:
            _ax.axhline(y=1.0 / Navr, color="k")
        return _ax

    @staticmethod
    def _plotAmp(freq, Axx, Ayy, Axy, _ax=None, scl=1e-3, afont=None,
                 titl="Power Spectra",
                 ylbl=r"P$_{ij}$ [I.U./Hz]",
                 _tf=np.abs, _ph=None):  # pragma: no cover
        """Pxx/Pyy/Pxy triple in blue/red/black (reference :2779)."""
        pq = fftanal._plot_quantity
        kw = dict(scl=scl, afont=afont, titl=titl, ylbl=ylbl, xlbl=None)
        for A, c in ((Axx, "b-"), (Ayy, "r-"), (Axy, "k-")):
            _ax = pq(freq, _tf(np.abs(np.asarray(A))), _ax=_ax, fmt=c,
                     plothandle=_ph(_ax) if (_ph and _ax) else None, **kw)
        return _ax

    @staticmethod
    def _plotlogAmp(freq, Axx, Ayy, Axy, _ax=None, scl=1e-3, afont=None,
                    titl="Power Spectra",
                    ylbl=r"P$_{ij}$ [dB/Hz]"):  # pragma: no cover
        """dB-scaled spectra triple (reference :2770)."""
        return fftanal._plotAmp(freq, Axx, Ayy, Axy, _ax=_ax, scl=scl,
                                afont=afont, titl=titl, ylbl=ylbl,
                                _tf=lambda a: 10 * np.log10(a))

    @staticmethod
    def _plotsemilogAmp(freq, Axx, Ayy, Axy, _ax=None, scl=1e-3, afont=None,
                        titl="Power Spectra",
                        ylbl=r"P$_{ij}$ [dB/Hz]"):  # pragma: no cover
        """dB spectra on a log frequency axis (reference :2758)."""
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.subplot(1, 1, 1)
        return fftanal._plotAmp(freq, Axx, Ayy, Axy, _ax=_ax, scl=scl,
                                afont=afont, titl=titl, ylbl=ylbl,
                                _tf=lambda a: 10 * np.log10(a),
                                _ph=lambda ax: ax.semilogx)

    @staticmethod
    def _plotPhase(freq, phase, _ax=None, scl=1e-3, afont=None,
                   titl="Cross-Phase", ylbl=r"$\phi_{xy}$",
                   fmt="k-"):  # pragma: no cover
        """Cross-phase trace (reference :2786)."""
        return fftanal._plot_quantity(freq, phase, _ax=_ax, scl=scl,
                                      afont=afont, titl=titl, ylbl=ylbl,
                                      xlbl=None, fmt=fmt)

    def plotCorrelations(self, axs=None):  # pragma: no cover
        """Lag-domain correlation panel(s) (reference :2245-2280): the number
        of axes selects which of rho_xy / Rxx / Ryy / Rxy are drawn."""
        import matplotlib.pyplot as plt
        pc = fftanal._plotCorr
        if axs is None:
            plt.figure()
            ax1 = plt.subplot(4, 1, 1)
            axs = [ax1,
                   plt.subplot(4, 1, 2, sharex=ax1, sharey=ax1),
                   plt.subplot(4, 1, 3, sharex=ax1, sharey=ax1),
                   plt.subplot(4, 1, 4, sharex=ax1)]
        axs = list(np.atleast_1d(axs))
        af = self.afont
        if len(axs) == 1:
            return pc(self.lags, self.corrcoef, _ax=axs[0], afont=af,
                      ylbl=r"$\rho_{xy}$")
        if len(axs) == 2:
            pc(self.lags, self.Rxx, _ax=axs[0], afont=af,
               titl="Correlations", xlbl=None, ylbl=r"$R_{xx}$", fmt="b-")
            pc(self.lags, self.Ryy, _ax=axs[0], afont=af, xlbl=None, fmt="r-")
            pc(self.lags, self.Rxy, _ax=axs[0], afont=af, xlbl=None, fmt="k-")
            pc(self.lags, self.corrcoef, _ax=axs[1], afont=af,
               titl="Cross-Correlation", ylbl=r"$\rho_{xy}$")
            return axs[0], axs[1]
        if len(axs) == 3:
            pc(self.lags, self.Rxx, _ax=axs[0], afont=af,
               titl="Auto-Correlation", xlbl=None, ylbl=r"$R_{xx}$", fmt="b-")
            pc(self.lags, self.Ryy, _ax=axs[1], afont=af,
               titl="Auto-Correlation", xlbl=None, ylbl=r"$R_{yy}$", fmt="r-")
            pc(self.lags, self.Rxy, _ax=axs[2], afont=af,
               titl="Cross-Correlation", xlbl=None, ylbl=r"$R_{xy}$")
            return axs[0], axs[1], axs[2]
        pc(self.lags, self.Rxx, _ax=axs[0], afont=af,
           titl="Cross-Correlation", xlbl="", ylbl=r"$R_{xx}$", fmt="b-")
        pc(self.lags, self.Ryy, _ax=axs[1], afont=af, xlbl="",
           ylbl=r"$R_{yy}$", fmt="r-")
        pc(self.lags, self.Rxy, _ax=axs[2], afont=af, xlbl="",
           ylbl=r"$R_{xy}$")
        pc(self.lags, self.corrcoef, _ax=axs[3], afont=af,
           ylbl=r"$\rho_{xy}$")
        return axs[0], axs[1], axs[2], axs[3]

    def plotPxy(self, _ax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        f = 1e-3 * np.asarray(self.freq)
        _ax.plot(f, 10 * np.log10(np.abs(np.asarray(self.Pxx))), "b-")
        _ax.plot(f, 10 * np.log10(np.abs(np.asarray(self.Pyy))), "r-")
        _ax.plot(f, 10 * np.log10(np.abs(np.asarray(self.Pxy))), "k-")
        return _ax

    def plotCxy(self, _ax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        _ax.plot(1e-3 * np.asarray(self.freq), np.abs(np.asarray(self.Cxy2)), "k-")
        _ax.axhline(y=1.0 / self.Navr, color="k")
        return _ax

    def plotphxy(self, _ax=None):  # pragma: no cover
        import matplotlib.pyplot as plt
        if _ax is None:
            plt.figure()
            _ax = plt.gca()
        _ax.plot(1e-3 * np.asarray(self.freq), np.asarray(self.phi_xy), "k-")
        return _ax

    def __testFFTanal__(self):
        """Dual-implementation cross-validation (reference ``:2817-2881``):
        run the device pipeline and the independent NumPy/mlab oracle on the
        reference's test signals; returns the two result tuples."""
        from .examples import testFFTanal
        return testFFTanal(plotit=bool(getattr(self, "plotit", False)))
