"""Geometry grids of the public spectral paths against float64 NumPy oracles.

Segment lengths even, odd and not powers of two; overlaps from none to
75 %; 1 to 16 channels; FIR lengths from 1 to 1025 taps; detrend none,
mean and linear; complex two-sided input; the STFT.  Both transform paths
(``'xla'``, the default, and ``'mxu'``) run the Welch grid.
"""
import numpy as np
import pytest

import pyfft_tpu as ft
from pyfft_tpu import segmentation as seg
from pyfft_tpu.spectral import welch_cross_spectra, welch_filtered_cross_spectra


def _plan(nt, nwins, hop):
    nov = nwins - hop
    return seg.SegmentPlan(nsig=nt, nwins=nwins, noverlap=nov,
                           navr=(nt - nov) // hop, nfft=nwins,
                           nnyquist=seg.get_nnyquist(nwins))


def _detrend(v, style):
    """Global detrend of the whole span: 0 none, 1 mean, -1 linear."""
    if style == 0:
        return v
    if style > 0:
        return v - v.mean(axis=-1, keepdims=True)
    t = np.arange(v.shape[-1], dtype=float)
    t -= t.mean()
    vm = v - v.mean(axis=-1, keepdims=True)
    slope = (vm * t).sum(axis=-1, keepdims=True) / (t * t).sum()
    return vm - slope * t


def _onesided_scale(nfft, nny):
    s = np.ones(nny)
    s[1:-1] = 2.0
    if nfft % 2:
        s[-1] = 2.0
    return s


def _welch_oracle(x, y, win, plan, fs, detrend, onesided=True):
    """Segment loop in float64: averaged Pxx, Pyy (nf, nch), Pxy (nf, nch)
    under the reference's normalization (fft_analysis.py:402-440)."""
    x = _detrend(np.asarray(x), detrend)
    y = _detrend(np.atleast_2d(np.asarray(y)), detrend)
    hop = plan.nwins - plan.noverlap
    Sxx = 0.0
    Syy = 0.0
    Sxy = 0.0
    for g in range(plan.navr):
        sl = slice(g * hop, g * hop + plan.nwins)
        X = np.fft.fft(win * x[sl])
        Y = np.fft.fft(win * y[:, sl], axis=-1)
        Sxx = Sxx + np.abs(X) ** 2
        Syy = Syy + np.abs(Y) ** 2
        Sxy = Sxy + Y * np.conj(X)
    s1 = win.sum()
    norm = 1.0 / (plan.navr * s1 ** 2 * fs * (win ** 2).sum() / s1 ** 2)
    if onesided:
        sc = _onesided_scale(plan.nfft, plan.nnyquist) * norm
        k = plan.nnyquist
        return Sxx[:k] * sc, (Syy[:, :k] * sc).T, (Sxy[:, :k] * sc).T
    sh = np.fft.fftshift
    return (sh(Sxx) * norm, sh(Syy, axes=-1).T * norm,
            sh(Sxy, axes=-1).T * norm)


def _close(got, want, rel=1e-9):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


WELCH_GRID = [
    # nch, nt, nwins, hop, detrend
    (3, 1 << 15, 2048, 1024, 1),      # 50 % overlap, power of two
    (2, 1 << 14, 1024, 512, 0),       # no detrend
    (1, 1 << 14, 2048, 2048, 1),      # no overlap
    (2, 1 << 14, 512, 128, 1),        # 75 % overlap
    (3, 40000, 2048, 1024, 1),        # length not a multiple of the hop
    (2, 128 * 998, 512, 256, -1),     # linear detrend
    (2, 20000, 511, 256, 1),          # odd segment length
    (4, 30000, 1000, 500, -1),        # not a power of two
    (16, 8192, 256, 128, 1),          # sixteen channels
    (1, 8192, 250, 125, 0),           # even, not a power of two
    (5, 9000, 333, 111, 1),           # odd, 2/3 overlap
]


@pytest.mark.parametrize("backend", ["xla", "mxu"])
@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", WELCH_GRID)
def test_welch_cross_spectra_geometry(nch, nt, nwins, hop, detrend, backend):
    rng = np.random.default_rng(nch * nt % 7919 + nwins)
    fs = 1e3
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nch, nt)) + 0.5 * x
    plan = _plan(nt, nwins, hop)
    win = np.hanning(nwins + 1)[:-1]
    out = welch_cross_spectra(x, y, win, plan, fs, detrend_style=detrend,
                              fft_backend=backend)
    Pxx, Pyy, Pxy = _welch_oracle(x, y, win, plan, fs, detrend)
    _close(np.real(out["Pxx"]), Pxx)
    _close(np.real(out["Pyy"]), Pyy)
    _close(out["Pxy"], Pxy)
    assert len(out["freq"]) == plan.nnyquist


@pytest.mark.parametrize("nwins,hop,detrend", [
    (512, 256, 1), (511, 256, 0), (600, 150, -1)])
def test_welch_complex_twosided_geometry(nwins, hop, detrend):
    rng = np.random.default_rng(nwins)
    nt, fs = 12000, 2e3
    t = np.arange(nt) / fs
    z = (np.exp(2j * np.pi * 97.0 * t)
         + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    y = (0.5 * z[None] * np.exp(-1j * np.arange(1, 4))[:, None]
         + 0.1 * (rng.standard_normal((3, nt))
                  + 1j * rng.standard_normal((3, nt))))
    plan = _plan(nt, nwins, hop)
    win = np.hanning(nwins + 1)[:-1]
    out = welch_cross_spectra(z, y, win, plan, fs, onesided=False,
                              detrend_style=detrend)
    Pxx, Pyy, Pxy = _welch_oracle(z, y, win, plan, fs, detrend,
                                  onesided=False)
    _close(np.real(out["Pxx"]), Pxx)
    _close(np.real(out["Pyy"]), Pyy)
    _close(out["Pxy"], Pxy)
    np.testing.assert_allclose(out["freq"],
                               np.fft.fftshift(np.fft.fftfreq(nwins, 1 / fs)))


@pytest.mark.parametrize("ntaps,nch,nwins,hop,detrend", [
    (1, 2, 512, 256, 1),
    (2, 1, 512, 256, 0),
    (33, 3, 1024, 512, 1),
    (129, 2, 2048, 1024, 1),
    (129, 8, 500, 250, -1),
    (1025, 2, 2048, 1024, 1),
])
def test_welch_filtered_chain_geometry(ntaps, nch, nwins, hop, detrend):
    rng = np.random.default_rng(ntaps + nch)
    nt, fs = 1 << 14, 1e4
    x = rng.standard_normal(nt)
    y = rng.standard_normal((nch, nt))
    taps = rng.standard_normal(ntaps)
    plan = _plan(nt, nwins, hop)
    win = np.hanning(nwins + 1)[:-1]
    out = welch_filtered_cross_spectra(x, y, taps, win, plan, fs,
                                       detrend_style=detrend)
    xf = np.convolve(x, taps)[:nt]
    yf = np.stack([np.convolve(c, taps)[:nt] for c in y])
    Pxx, Pyy, Pxy = _welch_oracle(xf, yf, win, plan, fs, detrend)
    _close(np.real(out["Pxx"]), Pxx)
    _close(np.real(out["Pyy"]), Pyy)
    _close(out["Pxy"], Pxy)


@pytest.mark.parametrize("nwins,overlap,cplx", [
    (512, 0.5, False), (511, 0.5, False), (1000, 0.75, False),
    (256, 0.0, False), (512, 0.5, True), (300, 0.5, True)])
def test_stft_segments_geometry(nwins, overlap, cplx):
    """stft_segments: fft_win coefficients of every segment (reference
    fft_analysis.py:2126-2203) against a float64 segment loop."""
    rng = np.random.default_rng(nwins)
    nt, fs = 9000, 1e3
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 60 * t) + 0.1 * rng.standard_normal(nt) + 0.4
    if cplx:
        x = x + 1j * np.cos(2 * np.pi * 60 * t)
    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=overlap)
    win = np.hanning(nwins + 1)[:-1]
    tt, freq, X, _ = ft.stft_segments(x, t, win, plan, fs,
                                      onesided=not cplx)
    xd = x - x.mean()
    hop = plan.nwins - plan.noverlap
    fr = np.stack([xd[g * hop:g * hop + nwins] for g in range(plan.navr)])
    F = np.fft.fft(fr * win, axis=-1)
    s1 = win.sum()
    scale = 1.0 / (s1 * np.sqrt(fs * (win ** 2).sum() / s1 ** 2))
    if cplx:
        want = np.fft.fftshift(F, axes=-1) * scale
    else:
        amp = np.ones(plan.nnyquist)
        amp[1:-1] = np.sqrt(2.0)
        if nwins % 2:
            amp[-1] = np.sqrt(2.0)
        want = F[:, :plan.nnyquist] * amp * scale
    _close(X, want)
    tw = np.stack([t[g * hop:g * hop + nwins] for g in range(plan.navr)])
    np.testing.assert_allclose(tt, tw.mean(axis=-1), rtol=1e-12)


@pytest.mark.parametrize("ntaps", [1, 7, 33, 129, 257, 1025])
@pytest.mark.parametrize("nch,nt", [(1, 5000), (3, 4096), (9, 2048 * 3 + 17)])
def test_fir_filter_matches_numpy_convolve(ntaps, nch, nt):
    rng = np.random.default_rng(ntaps + nch)
    x = rng.standard_normal((nch, nt))
    taps = rng.standard_normal(ntaps)
    got = np.asarray(ft.filters.fir_filter(x, taps))
    want = np.stack([np.convolve(x[c], taps)[:nt] for c in range(nch)])
    _close(got, want, rel=1e-10)


def test_fir_filter_axis_and_1d():
    """1-D input keeps its shape; ``axis`` selects the time axis."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 2))
    taps = ft.filters.firwin(65, [0.1, 0.4], pass_zero=False)
    got = np.asarray(ft.filters.fir_filter(x, taps, axis=0))
    assert got.shape == x.shape
    want = np.stack([np.convolve(x[:, c], taps)[:3000] for c in range(2)],
                    axis=1)
    _close(got, want, rel=1e-10)
    one = np.asarray(ft.filters.fir_filter(x[:, 0], taps))
    assert one.shape == (3000,)
    _close(one, want[:, 0], rel=1e-10)
