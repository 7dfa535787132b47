"""fft_pwelch golden-parity tests against the genuine reference implementation
(executed via the shim), plus scipy.signal.csd as an independent oracle."""
import numpy as np
import pytest
import scipy.signal as dsp

import pyfft_tpu as ft


def _sigs(N=2 ** 12, df=5.0, nch=1, seed=0, complexsig=False):
    tvec = (1.0 / df) * np.arange(0.0, 1.0, 1.0 / N)
    rng = np.random.default_rng(seed)
    sigx = 0.1 * dsp.square(2.0 * np.pi * (df * 30.0) * tvec) + 7.0
    sigy = np.zeros((len(tvec), nch))
    for ii in range(nch):
        sigy[:, ii] = (np.sin(2.0 * np.pi * ((ii + 1) * df * 30.0) * tvec
                              - np.pi / 4.0 - ii * np.pi / 16) / (ii + 1) + ii)
    sigy = 0.007 * sigy + 2.5
    sigy += 0.001 * rng.standard_normal(sigy.shape)
    if nch == 1:
        sigy = sigy[:, 0]
    if complexsig:
        sigy = sigy + 1j * np.roll(sigy, 3)
    return tvec, sigx, sigy


FIELDS = ["freq", "Pxx", "Pyy", "Pxy", "Cxy", "Cxy2", "phi_xy", "Lxx", "Lyy",
          "Lxy", "varPxx", "varPyy", "varPxy", "varCxy", "varCxy2", "varPhxy",
          "varLxx", "varLyy", "varLxy", "Rxx", "Ryy", "Rxy", "corrcoef",
          "lags", "Ex", "Ey"]


def _compare(info_ours, info_ref, fields=FIELDS, rtol=1e-9, atol=1e-13):
    for f in fields:
        ours = np.asarray(getattr(info_ours, f))
        ref = np.asarray(getattr(info_ref, f))
        assert ours.shape == ref.shape, f"{f}: {ours.shape} vs {ref.shape}"
        scale = max(1.0, np.max(np.abs(ref)))
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol * scale,
                                   err_msg=f"field {f}")


@pytest.mark.parametrize("window", ["hamming", "hanning", "SFT3F"])
@pytest.mark.parametrize("detrend", [0, 1, -1])
def test_golden_parity_basic(ref_fft, window, detrend):
    """Config #1: single-channel Welch PSD, homebrew path, full span."""
    tvec, sigx, sigy = _sigs()
    args = dict(tbounds=[tvec[0], tvec[-1]], Navr=8, windowfunction=window,
                detrend_style=detrend, useMLAB=False, plotit=False,
                verbose=False)
    fo, Pxyo, Pxxo, Pyyo, Cxyo, phio, io = ft.fft_pwelch(tvec, sigx, sigy, **args)
    fr, Pxyr, Pxxr, Pyyr, Cxyr, phir, ir = ref_fft.fft_pwelch(tvec, sigx, sigy, **args)
    np.testing.assert_allclose(np.asarray(fo), fr, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Pxyo), Pxyr, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(np.asarray(Pxxo), Pxxr, rtol=1e-9, atol=1e-15)
    _compare(io, ir)


def test_golden_parity_tbounds(ref_fft):
    """Sub-span analysis (no reflect-extension)."""
    tvec, sigx, sigy = _sigs()
    args = dict(tbounds=[tvec[100], tvec[-200]], Navr=6,
                windowfunction="hanning", detrend_style=1, useMLAB=False,
                plotit=False, verbose=False)
    *_, io = ft.fft_pwelch(tvec, sigx, sigy, **args)
    *_, ir = ref_fft.fft_pwelch(tvec, sigx, sigy, **args)
    _compare(io, ir)


def test_golden_parity_multichannel(ref_fft):
    tvec, sigx, sigy = _sigs(nch=3)
    args = dict(tbounds=[tvec[0], tvec[-1]], Navr=8, windowfunction="hamming",
                detrend_style=1, useMLAB=False, plotit=False, verbose=False)
    *_, io = ft.fft_pwelch(tvec, sigx, sigy, **args)
    *_, ir = ref_fft.fft_pwelch(tvec, sigx, sigy, **args)
    _compare(io, ir)


def test_golden_parity_twosided_complex(ref_fft):
    """Complex input -> onesided=False (reference :123-128)."""
    tvec, sigx, sigy = _sigs(complexsig=True)
    args = dict(tbounds=[tvec[0], tvec[-1]], Navr=8, windowfunction="hanning",
                detrend_style=1, useMLAB=False, plotit=False, verbose=False)
    *_, io = ft.fft_pwelch(tvec, sigx, sigy, **args)
    *_, ir = ref_fft.fft_pwelch(tvec, sigx, sigy, **args)
    assert io.nch == ir.nch
    _compare(io, ir, fields=["freq", "Pxx", "Pyy", "Pxy", "Cxy", "Cxy2",
                             "phi_xy", "varPxx", "lags"])


def test_golden_parity_odd_nfft(ref_fft):
    """Odd segment length exercises the odd-bin doubling branches."""
    tvec, sigx, sigy = _sigs(N=3000)
    args = dict(tbounds=[tvec[3], tvec[-4]], Navr=7, windowfunction="hanning",
                detrend_style=1, useMLAB=False, plotit=False, verbose=False)
    *_, io = ft.fft_pwelch(tvec, sigx, sigy, **args)
    *_, ir = ref_fft.fft_pwelch(tvec, sigx, sigy, **args)
    assert io.nwins % 2 == ir.nwins % 2
    _compare(io, ir)


def test_minfreq_path_defined():
    """minFreq + full span: crashes in the reference; defined (clamped) here."""
    tvec, sigx, sigy = _sigs()
    f, Pxy, Pxx, Pyy, Cxy, phi, info = ft.fft_pwelch(
        tvec, sigx, sigy, minFreq=15 * 5.0, detrend_style=1, useMLAB=False,
        plotit=False, verbose=False)
    assert np.all(np.isfinite(np.asarray(Pxx)))
    assert info.Navr >= 1
    # resolution bound: nwins = int(Fs * 2 / minFreq)
    Fs = (len(tvec) - 1) / (tvec[-1] - tvec[0])
    assert info.nwins == int(Fs * 2.0 / 75.0)


def test_ntmodel_path(ref_fft):
    """sigx shorter than sigy -> single-window model cross-phase mode."""
    tvec, sigx, sigy = _sigs()
    nwins = 512
    xmod = sigx[:nwins]
    args = dict(tbounds=[tvec[10], tvec[-10]], windowfunction="hanning",
                detrend_style=1, useMLAB=False, plotit=False, verbose=False)
    *_, io = ft.fft_pwelch(tvec, xmod, sigy, **args)
    *_, ir = ref_fft.fft_pwelch(tvec, xmod, sigy, **args)
    _compare(io, ir, fields=["freq", "Pxx", "Pyy", "Pxy", "Cxy2", "phi_xy"])


def test_scipy_csd_oracle_psd():
    """Independent oracle: our PSD must match scipy.signal.welch with the
    same framing/window (detrend handled globally rather than per-segment, so
    use detrend_style=0 on a zero-mean signal)."""
    rng = np.random.default_rng(7)
    N = 2 ** 13
    fs = 1e3
    tvec = np.arange(N) / fs
    x = np.sin(2 * np.pi * 97.0 * tvec) + 0.1 * rng.standard_normal(N)
    x -= x.mean()
    # sub-span to avoid reflect-extension, boxcar for identical conventions
    nwins = 1024
    *_, info = ft.fft_pwelch(tvec, x, x, tbounds=[tvec[1], tvec[-2]],
                             windowoverlap=0.5, windowfunction="hanning",
                             detrend_style=0, plotit=False, verbose=False,
                             tper=nwins / fs)
    i0, i1 = info.ibnds
    f_sp, P_sp = dsp.welch(x[i0:i1], fs=info.Fs, window=np.asarray(info.win),
                           nperseg=info.nwins, noverlap=info.noverlap,
                           nfft=info.nfft, detrend=False,
                           return_onesided=True, scaling="density")
    # scipy keeps the Nyquist bin and does not double the last pre-Nyquist
    # bin; compare on the common, identically-scaled interior bins.
    nny = info.Nnyquist
    ours = np.asarray(info.Pxx).real
    np.testing.assert_allclose(np.asarray(info.freq)[1:nny - 1],
                               f_sp[1:nny - 1], atol=1e-9)
    np.testing.assert_allclose(ours[1:nny - 1], P_sp[1:nny - 1],
                               rtol=1e-8, atol=1e-12)


def test_usemlab_oracle_matches_homebrew_shape():
    """The independent oracle path returns the same shapes/frequencies and
    closely matching PSD levels (different detrend granularity)."""
    tvec, sigx, sigy = _sigs()
    args = dict(tbounds=[tvec[0], tvec[-1]], Navr=8, windowfunction="hanning",
                detrend_style=0, plotit=False, verbose=False)
    f1, Pxy1, Pxx1, *_ = ft.fft_pwelch(tvec, sigx, sigy, useMLAB=False, **args)
    f2, Pxy2, Pxx2, *_ = ft.fft_pwelch(tvec, sigx, sigy, useMLAB=True, **args)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=1e-9)
    assert np.asarray(Pxx1).shape == np.asarray(Pxx2).shape
    # away from DC the two estimates agree well
    a, b = np.abs(np.asarray(Pxx1))[2:], np.abs(np.asarray(Pxx2))[2:]
    assert np.median(np.abs(a - b) / (np.abs(b) + 1e-30)) < 0.05


def test_usemlab_against_real_mlab(ref_fft):
    """Our NumPy csd oracle vs matplotlib.mlab.csd itself."""
    import matplotlib.mlab as mlab
    from pyfft_tpu.spectral import csd_oracle
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096)
    y = rng.standard_normal(4096)
    win = np.hanning(512)
    P1, f1 = csd_oracle(x, y, 512, fs=1e3, detrend=mlab.detrend_none,
                        window=win, noverlap=256, sides="onesided")
    P2, f2 = mlab.csd(x, y, NFFT=512, Fs=1e3, detrend=mlab.detrend_none,
                      window=win, noverlap=256, sides="onesided",
                      scale_by_freq=True)
    np.testing.assert_allclose(f1, f2, atol=1e-9)
    np.testing.assert_allclose(P1, P2, rtol=1e-9, atol=1e-15)


def test_kaiser_beta_through_fft_pwelch():
    """kaiser + beta threaded end-to-end (the REFERENCE cannot run this:
    its fft_pwelch never forwards beta into windows(), so the upstream
    dispatcher raises KeyError at windows.py:236 — a latent defect we fix
    rather than reproduce).  Validate against a hand-rolled Welch with the
    same periodic np.kaiser window instead."""
    tvec, sigx, sigy = _sigs()
    *_, io = ft.fft_pwelch(
        tvec, sigx, sigy, tbounds=[tvec[2], tvec[-3]], Navr=8,
        windowfunction="kaiser", beta=8.6, detrend_style=1,
        useMLAB=False, plotit=False, verbose=False)
    win = np.kaiser(io.nwins + 1, 8.6)[:-1]
    np.testing.assert_allclose(np.asarray(io.win), win, atol=1e-12)
    # hand-rolled oracle with identical framing/normalization
    i0, i1 = io.ibnds
    x = sigx[i0:i1] - sigx[i0:i1].mean()
    hop = io.nwins - io.noverlap
    acc = 0.0
    for g in range(io.Navr):
        X = np.fft.fft(win * x[g * hop:g * hop + io.nwins], n=io.nfft)
        acc = acc + np.abs(X) ** 2
    Pxx = acc / io.Navr
    nny = io.Nnyquist
    Pxx = Pxx[:nny]
    if io.nfft % 2:      # odd nfft: no Nyquist bin, last bin doubles too
        Pxx[1:] *= 2.0   # (reference fold, fft_analysis.py:414-421)
    else:
        Pxx[1:nny - 1] *= 2.0
    Pxx /= io.S1 ** 2 * io.ENBW
    np.testing.assert_allclose(np.abs(np.asarray(io.Pxx)), Pxx,
                               rtol=1e-9, atol=1e-12 * Pxx.max())


def test_fft_pwelch_usemlab_matches_matplotlib_end_to_end():
    """fft_pwelch(useMLAB=True) vs hand-rolled matplotlib.mlab.csd with the
    same framing (VERDICT: golden against mlab itself, not just scipy
    conventions)."""
    import matplotlib.mlab as mlab
    tvec, sigx, sigy = _sigs()
    Fs = (len(tvec) - 1) / (tvec[-1] - tvec[0])
    f, Pxy, Pxx, Pyy, Cxy, phi, info = ft.fft_pwelch(
        tvec, sigx, sigy, tbounds=[tvec[1], tvec[-2]], Navr=8,
        windowfunction="hanning", detrend_style=0, useMLAB=True,
        plotit=False, verbose=False)
    i0, i1 = info.ibnds
    win = np.asarray(info.win)
    Pxx_m, f_m = mlab.psd(sigx[i0:i1], NFFT=info.nfft, Fs=Fs,
                          detrend=mlab.detrend_none, window=win,
                          noverlap=info.noverlap, sides="onesided",
                          scale_by_freq=True)
    # mlab normalizes by Fs*S2 == our 1/(S1^2 ENBW); the one-sided bin
    # doubling conventions coincide for even nfft
    np.testing.assert_allclose(np.asarray(f)[:len(f_m)], f_m, atol=1e-9)
    n = min(len(f_m), info.Nnyquist)
    np.testing.assert_allclose(np.abs(np.asarray(Pxx))[1:n - 1],
                               Pxx_m[1:n - 1], rtol=1e-9, atol=1e-14)


def test_welch_filtered_cross_spectra_paths_agree():
    """Public FIR+Welch chain: the real-pair matmul path must match the
    default cuFFT/XLA path."""
    from pyfft_tpu import welch_filtered_cross_spectra
    from pyfft_tpu import segmentation as sgm
    from pyfft_tpu.filters import firwin
    rng = np.random.default_rng(21)
    fs, nt = 1e4, 1 << 14
    x = rng.standard_normal(nt)
    y = rng.standard_normal((2, nt))
    taps = np.asarray(firwin(129, [0.1, 0.4], pass_zero=False))
    plan = sgm.plan_segments(nt, nwins=1024, windowoverlap=0.5)
    win = np.hanning(1025)[:-1]
    a = welch_filtered_cross_spectra(x, y, taps, win, plan, fs,
                                     fft_backend="mxu")
    b = welch_filtered_cross_spectra(x, y, taps, win, plan, fs,
                                     fft_backend="xla")
    s = np.max(np.abs(np.asarray(b["Pxx"])))
    np.testing.assert_allclose(np.asarray(a["Pxx"]), np.asarray(b["Pxx"]),
                               rtol=2e-4, atol=2e-5 * s)
    np.testing.assert_allclose(np.asarray(a["Pyy"]), np.asarray(b["Pyy"]),
                               rtol=2e-4, atol=2e-5 * s)
    np.testing.assert_allclose(np.asarray(a["Pxy"]), np.asarray(b["Pxy"]),
                               rtol=2e-4, atol=2e-5 * s)
    assert a["freq"][0] == 0.0 and a["Pxx"].shape == b["Pxx"].shape


def test_fftinfosc_segment_contract():
    """Standalone container keeps the reference's None defaults; a deferred
    container without a retained recompute raises an actionable error."""
    from pyfft_tpu.spectral import fftinfosc
    info = fftinfosc()
    assert info.Pxx_seg is None                   # reference parity
    info2 = fftinfosc()
    info2._defer_segments(None)
    with pytest.raises(AttributeError, match="without mesh="):
        _ = info2.Pxy_seg
    with pytest.raises(AttributeError):
        _ = info2.not_a_field


def test_sigy_none_is_auto_spectra():
    """fft_pwelch(sigy=None) follows fftanal.init's sigy->sigx rule
    (reference fft_analysis.py:1714) instead of dying on an object array."""
    fs, N = 1e3, 4096
    t = np.arange(N) / fs
    x = np.sin(2 * np.pi * 50.0 * t) + 0.01 * np.random.default_rng(3).standard_normal(N)
    out_none = ft.fft_pwelch(t, x, None, Navr=4, plotit=False, verbose=False)
    out_same = ft.fft_pwelch(t, x, x, Navr=4, plotit=False, verbose=False)
    np.testing.assert_allclose(np.asarray(out_none[2]), np.asarray(out_same[2]))
    np.testing.assert_allclose(np.asarray(out_none[3]), np.asarray(out_same[3]))
