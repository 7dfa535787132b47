"""Typed configuration for the spectral pipelines (SURVEY §5.6).

The reference configures everything through kwargs with ``None``-defaulting
blocks scattered across ``fft_pwelch`` (fft_analysis.py:102-128) and
``fftanal.init`` (:1726-1745).  This module centralizes those rules in one
frozen dataclass so every entry point defaults identically:

- ``windowfunction`` default 'hanning'; ``windowoverlap=None`` resolves to
  the window's recommended overlap (ROV registry; reference :104-111);
- ``minFreq`` implies ``tper = 2/minFreq``; ``tper`` implies
  ``nwins = int(Fs * tper)`` (reference :180-183); otherwise ``Navr``
  (default 8) fixes the segment count;
- ``onesided=None`` resolves to False iff the input is complex
  (reference :123-128);
- ``detrend`` accepts the reference's {1: mean, 0: none, -1: linear} codes
  and the string names.

``resolve()`` turns the config plus signal facts (length, sample rate,
complexness) into a concrete :class:`ResolvedSpectral` (segment plan +
window + norms), and :func:`welch_psd` is the functional front door:
``welch_psd(tvec, x, y, cfg) -> (freq, Pxy, Pxx, Pyy, Cxy, phi, info)``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace, asdict

import numpy as np

from . import segmentation as seg
from .windows import windows as _windows

__all__ = ["SpectralConfig", "ResolvedSpectral", "welch_psd"]


_DETREND_CODES = {1: 1, 0: 0, -1: -1,
                  "mean": 1, "none": 0, "linear": -1}


@dataclass(frozen=True)
class SpectralConfig:
    """Welch/STFT estimation settings with reference-identical defaulting."""

    windowfunction: str = "hanning"
    windowoverlap: float | None = None      # None -> window's ROV
    Navr: int | None = None                 # segment count (default 8)
    nwins: int | None = None                # explicit segment length
    tper: float | None = None               # segment duration [s]
    minFreq: float | None = None            # -> tper = 2/minFreq
    onesided: bool | None = None            # None -> not complex input
    detrend: int | str = 1                  # 1 mean / 0 none / -1 linear
    fft_backend: str | None = None          # None/'auto'|'xla'|'mxu'

    def __post_init__(self):
        if self.detrend not in _DETREND_CODES:
            raise ValueError(
                f"detrend {self.detrend!r} not in {list(_DETREND_CODES)}")

    @property
    def detrend_style(self) -> int:
        return _DETREND_CODES[self.detrend]

    def with_(self, **kw) -> "SpectralConfig":
        return replace(self, **kw)

    def to_dict(self):
        return asdict(self)

    # -- resolution ---------------------------------------------------------

    def resolve(self, nsig: int, Fs: float,
                iscomplex: bool = False) -> "ResolvedSpectral":
        """Apply the defaulting rules to concrete signal facts."""
        overlap = self.windowoverlap
        if overlap is None:
            overlap = _windows(self.windowfunction, verbose=False)

        nwins = self.nwins
        if nwins is None:
            if self.minFreq is not None:
                nwins = int(Fs * (2.0 / self.minFreq))
            elif self.tper is not None:
                nwins = int(Fs * self.tper)
        if nwins is not None:
            plan = seg.plan_segments(nsig, windowoverlap=overlap,
                                     nwins=int(nwins))
        else:
            plan = seg.plan_segments(nsig, navr=self.Navr or 8,
                                     windowoverlap=overlap)

        onesided = self.onesided
        if onesided is None:
            onesided = not iscomplex

        win = np.asarray(_windows(self.windowfunction, nwins=plan.nwins,
                                  verbose=False), dtype=np.float64)
        S1 = seg.get_s1(win)
        S2 = seg.get_s2(win)
        return ResolvedSpectral(
            cfg=self, plan=plan, overlap=overlap, onesided=bool(onesided),
            win=win, S1=S1, S2=S2,
            NENBW=seg.get_nenbw(plan.nwins, S1, S2),
            ENBW=seg.get_enbw(Fs, S1, S2), Fs=float(Fs))


@dataclass(frozen=True)
class ResolvedSpectral:
    """Concrete segmentation + window + norms for one signal."""

    cfg: SpectralConfig
    plan: seg.SegmentPlan
    overlap: float
    onesided: bool
    win: np.ndarray
    S1: float
    S2: float
    NENBW: float
    ENBW: float
    Fs: float

    @property
    def freq(self):
        if self.onesided:
            return self.Fs * np.arange(self.plan.nnyquist) / self.plan.nfft
        return (np.fft.fftshift(np.fft.fftfreq(self.plan.nfft))
                * self.Fs)


def welch_psd(tvec, sigx, sigy=None, cfg: SpectralConfig | None = None,
              tbounds=None, **overrides):
    """Functional Welch front door: config-object variant of ``fft_pwelch``.

    ``cfg`` (plus keyword ``overrides``) supplies every setting;
    ``sigy=None`` computes the auto-spectrum of ``sigx``.
    Returns the ``fft_pwelch`` tuple.
    """
    from .spectral import fft_pwelch

    cfg = (cfg or SpectralConfig())
    if overrides:
        cfg = cfg.with_(**overrides)
    if sigy is None:
        sigy = sigx
    kwargs = {}
    for name in ("tper", "minFreq"):
        v = getattr(cfg, name)
        if v is not None:
            kwargs[name] = v
    return fft_pwelch(tvec, sigx, sigy, tbounds=tbounds, Navr=cfg.Navr,
                      windowoverlap=cfg.windowoverlap,
                      windowfunction=cfg.windowfunction,
                      detrend_style=cfg.detrend_style,
                      onesided=cfg.onesided, fft_backend=cfg.fft_backend,
                      plotit=False, verbose=False, **kwargs)
