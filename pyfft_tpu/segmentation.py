"""Welch segmentation arithmetic, COLA checks, window norms, and framing.

This module holds the *static* (trace-time) integer arithmetic that shapes the
jit-compiled spectral kernels, plus the batched framing primitive that replaces
the reference's per-segment Python loop (reference ``fft_analysis.py:362-388``)
with a single XLA gather.

Parity map (reference ``fft_analysis.py``):

- :func:`get_nwins`      <- ``fftanal._getNwins``      (:2412)
- :func:`get_noverlap`   <- ``fftanal._getNoverlap``   (:2421)
- :func:`get_navr`       <- ``fftanal._getNavr``       (:2425)
- :func:`check_cola`, :func:`get_min_overlap`, :func:`get_max_overlap`
                         <- (:2451-2468)
- :func:`get_nnyquist`   <- ``fftanal._getNnyquist``   (:2471)
- :func:`get_s1`/``s2``/``nenbw``/``enbw``/:func:`get_norms`
                         <- (:2487-2510)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp


# --------------------------------------------------------------------------- #
# Segment-count arithmetic (host-side, static)
# --------------------------------------------------------------------------- #

def get_nwins(nsig: int, navr: int, windowoverlap: float) -> int:
    """Segment length from signal length, segment count and fractional overlap."""
    nwins = int(math.floor(nsig * 1.0 / (navr - navr * windowoverlap + windowoverlap)))
    if nwins >= nsig:
        nwins = nsig
    if nwins < 1:
        raise ValueError(
            f"Navr={navr} with overlap={windowoverlap} leaves no samples per "
            f"segment for a signal of {nsig} samples; reduce Navr.")
    return nwins


def get_noverlap(nwins: int, windowoverlap: float) -> int:
    """Number of overlapped samples (``ceil`` convention, as the reference)."""
    return int(math.ceil(windowoverlap * nwins))


def get_navr(nsig: int, nwins: int, noverlap: int) -> int:
    """Number of averaging segments that fit in the signal."""
    if nwins >= nsig:
        return 1
    return (nsig - noverlap) // (nwins - noverlap)


def check_cola(nsig: int, nwins: int, noverlap: int) -> bool:
    """True when the hop tiles the signal exactly (constant-overlap-add)."""
    return (nsig - nwins) % (nwins - noverlap) == 0


def get_min_overlap(nsig: int, nwins: int, navr: int) -> int:
    noverlap = 1
    while not check_cola(nsig, nwins, noverlap) and noverlap < 1e4:
        noverlap += 1
    return noverlap


def get_max_overlap(nsig: int, nwins: int, navr: int) -> int:
    noverlap = nwins - 1
    while not check_cola(nsig, nwins, noverlap) and noverlap > 0:
        noverlap -= 1
    return noverlap


def get_nnyquist(nfft: int) -> int:
    """Number of retained one-sided bins: ``nfft//2`` even, ``(nfft+1)//2`` odd.

    Note this is the reference's convention (``fft_analysis.py:2471-2484``):
    for even ``nfft`` the Nyquist bin itself is *dropped* from the one-sided
    spectra.
    """
    if nfft % 2:
        return (nfft + 1) // 2
    return nfft // 2


# --------------------------------------------------------------------------- #
# Window norms
# --------------------------------------------------------------------------- #

def get_s1(win) -> float:
    return float(np.sum(np.asarray(win)))


def get_s2(win) -> float:
    return float(np.sum(np.asarray(win) ** 2.0))


def get_nenbw(nnyquist: int, s1: float, s2: float) -> float:
    """Normalized equivalent noise bandwidth (reference uses Nnyquist here)."""
    return nnyquist * 1.0 * s2 / (s1 ** 2)


def get_enbw(fs: float, s1: float, s2: float) -> float:
    """Effective noise bandwidth in Hz."""
    return fs * s2 / (s1 ** 2)


def get_norms(win, nnyquist: int, fs: float):
    s1 = get_s1(win)
    s2 = get_s2(win)
    return s1, s2, get_nenbw(nnyquist, s1, s2), get_enbw(fs, s1, s2)


# --------------------------------------------------------------------------- #
# Segmentation plan
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class SegmentPlan:
    """Static description of a Welch segmentation.

    All fields are Python ints/floats resolved at trace time so the jitted
    kernels see fully static shapes.
    """
    nsig: int
    nwins: int
    noverlap: int
    navr: int
    nfft: int
    nnyquist: int

    @property
    def hop(self) -> int:
        return self.nwins - self.noverlap

    def starts(self) -> np.ndarray:
        return np.arange(self.navr) * self.hop

    @property
    def cola(self) -> bool:
        return check_cola(self.nsig, self.nwins, self.noverlap)


def plan_segments(nsig: int, navr: int | None = None,
                  windowoverlap: float = 0.5, nwins: int | None = None) -> SegmentPlan:
    """Build a :class:`SegmentPlan` the way the reference resolves its inputs.

    Either ``navr`` (segment count) or ``nwins`` (segment length) may be
    given; the other is derived.  Mirrors the resolution order of reference
    ``fft_pwelch`` (``fft_analysis.py:170-221``).
    """
    if nwins is None:
        if navr is None:
            navr = 8
        nwins = get_nwins(nsig, navr, windowoverlap)
        derived_navr = False
    else:
        derived_navr = True
    noverlap = get_noverlap(nwins, windowoverlap)
    if derived_navr or navr is None:
        navr = get_navr(nsig, nwins, noverlap)
    if nwins >= nsig:
        navr = 1
        nwins = nsig
        noverlap = get_noverlap(nwins, windowoverlap)
    nfft = nwins
    return SegmentPlan(nsig=nsig, nwins=nwins, noverlap=noverlap, navr=navr,
                       nfft=nfft, nnyquist=get_nnyquist(nfft))


# --------------------------------------------------------------------------- #
# Batched framing (the batched replacement of the segment loop)
# --------------------------------------------------------------------------- #

def frame_signal(x, nwins: int, hop: int, navr: int):
    """Gather Welch segments as a batched array.

    ``x`` has time on its *last* axis: ``(..., nt) -> (..., navr, nwins)``.

    This replaces the reference's hot Python loop over segments
    (``fft_analysis.py:362-388``) with a batched gather; every downstream op
    (window multiply, FFT, power) is then fully batched over the segment
    axis.

    An element-level gather of ``navr * nwins`` indices is slow.  When ``hop``
    and ``nwins`` share a reasonably large common block ``b`` (always true
    for the standard overlap ratios: 50% -> b = hop), the signal is
    reshaped to ``(nt/b, b)`` rows and segments become a *row-level* gather
    of ``navr * nwins/b`` indices — orders of magnitude fewer, lowered by
    XLA to wide contiguous loads.
    """
    b = math.gcd(hop, nwins)
    need = (navr - 1) * hop + nwins
    if b >= 16 and x.shape[-1] >= need:
        nrows = need // b
        xb = x[..., :nrows * b].reshape(x.shape[:-1] + (nrows, b))
        row_idx = (jnp.arange(navr) * (hop // b))[:, None] \
            + jnp.arange(nwins // b)[None, :]
        fr = jnp.take(xb, row_idx, axis=-2)
        return fr.reshape(x.shape[:-1] + (navr, nwins))
    starts = jnp.arange(navr) * hop
    idx = starts[:, None] + jnp.arange(nwins)[None, :]
    return jnp.take(x, idx, axis=-1)


def reflect_extend(x, nwins: int, axis: int = -1):
    """Reflect-pad by ``nwins - 1`` samples at both ends.

    Matches reference ``fft_analysis.py:202-203``:
    ``concat(x[nwins-1:0:-1], x, x[-1:-nwins:-1])`` (no edge duplication).
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim

    def sl(a, b, step=1):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(a, b, step)
        return x[tuple(idx)]

    left = sl(nwins - 1, 0, -1)
    right = sl(-1, -nwins, -1)
    return jnp.concatenate([left, x, right], axis=axis)
