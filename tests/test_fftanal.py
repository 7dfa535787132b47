"""fftanal class API: golden parity vs the genuine reference class, and
MXU-backend (real-pair) equivalence with the XLA complex path."""
import numpy as np
import pytest

import pyfft_tpu as ft


def _sigs(N=2 ** 12, df=5.0, seed=0):
    tvec = (1.0 / df) * np.arange(0.0, 1.0, 1.0 / N)
    rng = np.random.default_rng(seed)
    sigx = 0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec) + 7.0
    sigx = sigx + 0.02 * rng.standard_normal(tvec.shape)
    sigy = 0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec - np.pi / 4.0) + 2.5
    sigy = sigy + 0.02 * rng.standard_normal(tvec.shape)
    return tvec, sigx, sigy


def _ref_class(ref_fft, tvec, sigx, sigy, **kw):
    # NOTE: the reference's own `pwelch()` crashes for 1-D signals inside
    # `averagewins` -> `Cxy_Cxy2` (`np.size(Pyy, axis=1)` IndexError on 1-D,
    # fft_analysis.py:1669) — a latent upstream defect.  Drive the working
    # stages and average manually to produce the golden values.
    obj = ref_fft.fftanal(tvec, sigx, sigy, tbounds=[tvec[10], tvec[-10]],
                          Navr=8, windowfunction="hamming", useMLAB=False,
                          plotit=False, verbose=False, detrend=1,
                          onesided=True, **kw)
    obj.Xstft()
    obj.Ystft()
    obj.Pstft()
    import numpy as _np
    for param in ["Pxx", "Pyy", "Pxy"]:
        setattr(obj, param, _np.mean(getattr(obj, param + "_seg"), axis=0))
        setattr(obj, "var" + param,
                (getattr(obj, param) / _np.sqrt(obj.Navr)) ** 2.0)
    obj.phi_xy = _np.angle(obj.Pxy)
    # more latent upstream defects: the reference class never sets nch/nfft,
    # which its own crosscorr/convert2amplitudes read — fill them in
    obj.nch = 1
    obj.nfft = obj.nwins
    return obj


def _our_class(tvec, sigx, sigy, **kw):
    obj = ft.fftanal(tvec, sigx, sigy, tbounds=[tvec[10], tvec[-10]],
                     Navr=8, windowfunction="hamming", useMLAB=False,
                     plotit=False, verbose=False, detrend=1, onesided=True,
                     **kw)
    obj.pwelch()
    return obj


def test_class_pwelch_golden_parity(ref_fft):
    tvec, sigx, sigy = _sigs()
    ours = _our_class(tvec, sigx, sigy)
    ref = _ref_class(ref_fft, tvec, sigx, sigy)
    for f in ["freq", "Xseg", "Yseg", "Pxx_seg", "Pxy_seg", "Pxx", "Pyy",
              "Pxy", "phi_xy", "varPxx", "Xpow"]:
        o = np.asarray(getattr(ours, f))
        r = np.asarray(getattr(ref, f))
        assert o.shape == r.shape, f
        scale = max(1.0, np.max(np.abs(r)))
        np.testing.assert_allclose(o, r, rtol=1e-8, atol=1e-12 * scale,
                                   err_msg=f)


def test_class_crosscorr_golden_parity(ref_fft):
    tvec, sigx, sigy = _sigs()
    ours = _our_class(tvec, sigx, sigy)
    ref = _ref_class(ref_fft, tvec, sigx, sigy)
    ours.crosscorr()
    ref.crosscorr()
    for f in ["Rxx", "Ryy", "Rxy", "corrcoef", "lags", "Ex", "Ey"]:
        o = np.ravel(np.asarray(getattr(ours, f)))
        r = np.ravel(np.asarray(getattr(ref, f)))
        scale = max(1.0, np.max(np.abs(r)))
        np.testing.assert_allclose(o, r, rtol=1e-8, atol=1e-12 * scale,
                                   err_msg=f)


def test_class_amplitudes_golden_parity(ref_fft):
    tvec, sigx, sigy = _sigs()
    ours = _our_class(tvec, sigx, sigy)
    ref = _ref_class(ref_fft, tvec, sigx, sigy)
    ours.convert2amplitudes()
    ref.convert2amplitudes()
    for f in ["Lxx", "Lyy", "Lxy", "varLxx", "varLyy"]:
        o = np.asarray(getattr(ours, f))
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(o, r, rtol=1e-8, atol=1e-12, err_msg=f)


def test_class_nosigy():
    tvec, sigx, _ = _sigs()
    obj = ft.fftanal(tvec, sigx, plotit=False, verbose=False)
    obj.pwelch()
    assert hasattr(obj, "Pxx")
    assert not hasattr(obj, "Pyy")


@pytest.mark.parametrize("complexsig", [False, True])
def test_mxu_backend_matches_xla(complexsig):
    """The real-pair transform path must reproduce the complex path."""
    tvec, sigx, sigy = _sigs()
    if complexsig:
        sigx = sigx + 1j * np.roll(sigx, 5)
        sigy = sigy + 1j * np.roll(sigy, 7)
    a = _our_class(tvec, sigx, sigy, fft_backend="xla")
    b = _our_class(tvec, sigx, sigy, fft_backend="mxu")
    for f in ["Xseg", "Pxx", "Pyy", "Pxy", "Cxy2", "phi_xy"]:
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)),
                                   rtol=1e-7, atol=1e-10, err_msg=f)


def test_mxu_backend_fft_pwelch_matches_xla():
    tvec, sigx, sigy = _sigs()
    args = dict(tbounds=[tvec[0], tvec[-1]], Navr=8,
                windowfunction="hanning", detrend_style=1, plotit=False,
                verbose=False)
    f1, Pxy1, Pxx1, Pyy1, Cxy1, phi1, i1 = ft.fft_pwelch(
        tvec, sigx, sigy, fft_backend="xla", **args)
    f2, Pxy2, Pxx2, Pyy2, Cxy2_, phi2, i2 = ft.fft_pwelch(
        tvec, sigx, sigy, fft_backend="mxu", **args)
    np.testing.assert_allclose(Pxx1, Pxx2, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(Pxy1, Pxy2, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(phi1, phi2, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(i1.Rxy), np.asarray(i2.Rxy),
                               rtol=1e-6, atol=1e-10)


def test_static_fft_win_matches_instance():
    """fftanal._fft_win (reference :2554) == instance fft_win."""
    tvec, sigx, _ = _sigs()
    obj = _our_class(tvec, sigx, sigx)
    sig = obj.__trimsig__(sigx, obj.ibounds)
    tv = obj.__trimsig__(tvec, obj.ibounds)
    tt, freq, X, pseg = ft.fftanal._fft_win(
        sig, tvec=tv, win=obj.win, nwins=obj.nwins, Navr=obj.Navr,
        noverlap=obj.noverlap, Nnyquist=obj.Nnyquist,
        onesided=obj.onesided, detrend_style=obj.detrendstyle)
    np.testing.assert_allclose(np.asarray(X), np.asarray(obj.Xseg),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(freq), np.asarray(obj.freq))
    np.testing.assert_allclose(np.asarray(pseg), np.asarray(obj.Xpow))


def test_plot_correlations_headless():
    """plotCorrelations renders on Agg for every axs-count branch."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    tvec, sigx, sigy = _sigs()
    obj = _our_class(tvec, sigx, sigy)
    obj.crosscorr()
    assert obj.plotCorrelations() is not None        # default 4-panel
    for n in (1, 2, 3):
        fig, axs = plt.subplots(n, 1, squeeze=False)
        out = obj.plotCorrelations(axs=list(axs.ravel()))
        assert out is not None
    plt.close("all")


def test_stft_useMLAB_scipy_oracle_branch():
    """fftanal.stft(useMLAB=True) must route through the independent
    scipy.signal.stft oracle with the reference's boundary conventions
    (reference fft_analysis.py:1815-1823) — pinned bit-for-bit against a
    direct scipy call — and still produce the averaged-spectra schema."""
    import scipy.signal as dsp
    from pyfft_tpu.fftanal import fftanal

    rng = np.random.default_rng(3)
    fs, nt = 1e3, 1 << 12
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 60 * t) + 0.1 * rng.standard_normal(nt)
    y = np.sin(2 * np.pi * 60 * t + 0.7) + 0.1 * rng.standard_normal(nt)

    ft = fftanal(t, x, y, Navr=8, useMLAB=True, plotit=False, verbose=False)
    ft.stft()

    f2, t2, Z = dsp.stft(x, fs=ft.Fs, window=ft.win, nperseg=ft.nwins,
                         noverlap=ft.noverlap, nfft=ft.nfft,
                         detrend="constant", return_onesided=True,
                         boundary="zeros", padded=True)
    np.testing.assert_allclose(np.asarray(ft.freq), f2, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ft.tseg), t2, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ft.Xseg), Z.T)
    # schema: averaged spectra over the SEGMENT axis, coherence in [0, 1]
    assert ft.Xseg.shape == (len(t2), len(f2))
    np.testing.assert_allclose(np.asarray(ft.Pxx),
                               np.mean(np.abs(Z.T) ** 2, axis=0), rtol=1e-12)
    assert np.all(np.real(ft.Cxy2) <= 1.0 + 1e-9)
    # the flag actually selects a different implementation than pwelch()
    ft2 = fftanal(t, x, y, Navr=8, useMLAB=False, plotit=False,
                  verbose=False)
    ft2.stft()
    assert ft2.Xseg.shape[0] != ft.Xseg.shape[0]  # zeros-boundary segments


def test_calcAmp_calcPh1_preallocate():
    """Reference convenience methods __calcAmp__/__calcPh1__/
    __preallocateFFT__ (fft_analysis.py:2310-2358)."""
    import matplotlib
    matplotlib.use("Agg")
    from pyfft_tpu.fftanal import fftanal
    rng = np.random.default_rng(0)
    nt = 1 << 12
    t = np.arange(nt) / 1e3
    x = np.sin(2 * np.pi * 97 * t) + 0.1 * rng.standard_normal(nt)
    y = np.sin(2 * np.pi * 97 * t - 0.4) + 0.1 * rng.standard_normal(nt)
    fa = fftanal(t, x, y, Navr=8, plotit=False, verbose=False)
    fa.__calcAmp__(t, x, y, [t[1], t[-2]])
    ipk = int(np.argmax(np.abs(np.asarray(fa.Axy))))
    assert abs(fa.frqA[ipk] - 97.0) < 2.0
    fa.__calcPh1__(t, x, y, [t[1], t[-2]])
    ipk2 = int(np.argmin(np.abs(np.asarray(fa.frqP) - 97.0)))
    # y lags x by 0.4 rad; phi = angle(Y conj X) = -0.4 (reference :520)
    assert abs(np.asarray(fa.ph)[ipk2] + 0.4) < 0.15
    fa.__preallocateFFT__()
    assert fa.Pxy.dtype == np.complex128 and fa.Pxy.size == 0
