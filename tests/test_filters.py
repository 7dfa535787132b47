"""Filter design/application vs scipy oracles, plus transform-path
equivalences."""
import numpy as np
import pytest
import scipy.signal as dsp

from pyfft_tpu import filters as flt
from pyfft_tpu import notch


@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("Wn,btype", [
    (0.2, "low"), (0.3, "high"), ([0.2, 0.5], "band"), ([0.2, 0.5], "stop"),
])
def test_butter_matches_scipy(order, Wn, btype):
    b1, a1 = flt.butter(order, Wn, btype=btype)
    b2, a2 = dsp.butter(order, Wn, btype=btype)
    np.testing.assert_allclose(a1, a2, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(b1, b2, rtol=1e-8, atol=1e-10)


def test_lfilter_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(500)
    b, a = dsp.butter(3, 0.2)
    np.testing.assert_allclose(np.asarray(flt.lfilter(b, a, x)),
                               dsp.lfilter(b, a, x), rtol=1e-9, atol=1e-12)


def test_lfilter_zi_matches_scipy():
    b, a = dsp.butter(4, 0.3)
    np.testing.assert_allclose(flt.lfilter_zi(b, a), dsp.lfilter_zi(b, a),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("order", [2, 4])
def test_filtfilt_matches_scipy(order):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(800)
    b, a = dsp.butter(order, 0.17)
    np.testing.assert_allclose(np.asarray(flt.filtfilt(b, a, x)),
                               dsp.filtfilt(b, a, x), rtol=1e-8, atol=1e-10)


def test_filtfilt_2d_axis0():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((700, 3))
    b, a = dsp.butter(2, 0.25)
    np.testing.assert_allclose(np.asarray(flt.filtfilt(b, a, x, axis=0)),
                               dsp.filtfilt(b, a, x, axis=0),
                               rtol=1e-8, atol=1e-10)


def test_downsample_antialiases():
    fs, fs_new = 1e4, 1e3
    t = np.arange(10000) / fs
    # in-band tone + out-of-band tone
    x = np.sin(2 * np.pi * 100 * t) + np.sin(2 * np.pi * 3000 * t)
    y = flt.downsample(x, fs, fs_new).ravel()
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    f = np.fft.rfftfreq(len(y), 1 / fs_new)
    pk = f[np.argmax(spec)]
    assert abs(pk - 100) < 5
    # out-of-band tone suppressed (would alias to 3000-2*1000=... if present)
    assert spec[np.argmin(np.abs(f - 400))] < 0.02 * spec.max()


def test_downsample_efficient_matches_downsample():
    fs, fs_new = 1e4, 1e3
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000)
    y1 = flt.downsample(x, fs, fs_new).ravel()
    y2 = np.asarray(flt.downsample_efficient(x, fs, fs_new)).ravel()
    assert y1.shape == y2.shape
    np.testing.assert_allclose(y1, y2, rtol=1e-7, atol=1e-9)


def test_upsample_linear():
    x = np.sin(np.linspace(0, 4 * np.pi, 100))
    y = np.asarray(flt.upsample(x, 100.0, 400.0))
    assert len(y) >= 4 * (len(x) - 1)
    np.testing.assert_allclose(y[::4][:99], x[:99], atol=1e-2)


def test_smooth_moving_average():
    x = np.ones(100)
    # reference slice arithmetic: even window -> same length, odd -> n+1
    y = np.asarray(flt.smooth(x, 10, "flat"))
    assert y.shape == x.shape
    np.testing.assert_allclose(y, 1.0, atol=1e-12)
    y11 = np.asarray(flt.smooth(x, 11, "flat"))
    assert y11.shape == (101,)
    np.testing.assert_allclose(y11, 1.0, atol=1e-12)


def test_firwin_matches_scipy():
    for args in [dict(numtaps=65, cutoff=0.3),
                 dict(numtaps=64, cutoff=0.3),
                 dict(numtaps=65, cutoff=[0.2, 0.5], pass_zero=False),
                 dict(numtaps=65, cutoff=[0.2, 0.5], pass_zero=True)]:
        h1 = flt.firwin(**args)
        h2 = dsp.firwin(**args)
        np.testing.assert_allclose(h1, h2, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("nx,ntaps", [(1000, 31), (5000, 101), (300, 130)])
def test_oaconvolve_matches_numpy(nx, ntaps):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(nx)
    h = rng.standard_normal(ntaps)
    for mode in ["full", "same", "valid"]:
        np.testing.assert_allclose(flt.oaconvolve(x, h, mode=mode),
                                   np.convolve(x, h, mode=mode),
                                   rtol=1e-8, atol=1e-9)


def test_oaconvolve_batched():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 2000))
    h = dsp.firwin(51, 0.2)
    out = flt.oaconvolve(x, h, mode="same")
    for c in range(4):
        np.testing.assert_allclose(out[c], np.convolve(x[c], h, mode="same"),
                                   rtol=1e-8, atol=1e-10)


def test_fir_filtfilt_zero_phase():
    fs = 1e3
    t = np.arange(4000) / fs
    x = np.sin(2 * np.pi * 30 * t) + np.sin(2 * np.pi * 300 * t)
    h = dsp.firwin(201, 100 / (fs / 2))
    y = flt.fir_filtfilt(x, h)
    # the 30 Hz component survives with zero phase shift
    ref = np.sin(2 * np.pi * 30 * t)
    core = slice(500, -500)
    np.testing.assert_allclose(y[core], ref[core], atol=5e-2)


def test_iir_to_fir_equivalence():
    b, a = dsp.butter(4, 0.2)
    h = flt.iir_to_fir(b, a)
    w, H_iir = dsp.freqz(b, a, worN=256)
    _, H_fir = dsp.freqz(h, 1.0, worN=256)
    np.testing.assert_allclose(np.abs(H_fir), np.abs(H_iir),
                               rtol=1e-5, atol=1e-7)


def test_freqz_matches_scipy():
    b, a = dsp.butter(3, 0.25)
    w1, h1 = flt.freqz(b, a, worN=128)
    w2, h2 = dsp.freqz(b, a, worN=128)
    np.testing.assert_allclose(h1, h2, rtol=1e-9, atol=1e-12)


def test_iirnotch_matches_scipy():
    b1, a1 = notch.iirnotch(0.3, 30.0)
    b2, a2 = dsp.iirnotch(0.3, 30.0, fs=2.0)
    np.testing.assert_allclose(b1, b2, rtol=1e-10)
    np.testing.assert_allclose(a1, a2, rtol=1e-10)


def test_iirpeak_matches_scipy():
    b1, a1 = notch.iirpeak(0.25, 20.0)
    b2, a2 = dsp.iirpeak(0.25, 20.0, fs=2.0)
    np.testing.assert_allclose(b1, b2, rtol=1e-10)
    np.testing.assert_allclose(a1, a2, rtol=1e-10)


def test_notch_removes_tone():
    fs = 1e3
    t = np.arange(4096) / fs
    x = np.sin(2 * np.pi * 60 * t) + 0.5 * np.sin(2 * np.pi * 123 * t)
    y = notch.notch_filter(x, 60 / (fs / 2), Q=30)
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    f = np.fft.rfftfreq(len(y), 1 / fs)
    i60 = np.argmin(np.abs(f - 60))
    i123 = np.argmin(np.abs(f - 123))
    assert spec[i60] < 0.05 * spec[i123]


def test_butter_lowpass_filter_reference_api():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(1000)
    y = np.asarray(flt.butter_lowpass_filter(x, cutoff=0.1, fs=1.0, order=3))
    ref = dsp.filtfilt(*dsp.butter(3, 0.1), x)
    np.testing.assert_allclose(y, ref, rtol=1e-8, atol=1e-10)


def test_complex_filtfilt():
    rng = np.random.default_rng(9)
    z = rng.standard_normal(600) + 1j * rng.standard_normal(600)
    b, a = dsp.butter(2, 0.3)
    ours = flt.complex_filtfilt(b, a, z)
    ref = dsp.filtfilt(b, a, z.real) + 1j * dsp.filtfilt(b, a, z.imag)
    np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-10)


def test_resample_poly_matches_scipy():
    from scipy import signal as sps

    rng = np.random.default_rng(0)
    for up, down in [(2, 1), (1, 3), (3, 2), (7, 5), (5, 7), (4, 4)]:
        x = rng.standard_normal(1000)
        a = np.asarray(flt.resample_poly(x, up, down))
        b = sps.resample_poly(x, up, down)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    x2 = rng.standard_normal((3, 500))
    np.testing.assert_allclose(
        np.asarray(flt.resample_poly(x2, 3, 2, axis=-1)),
        sps.resample_poly(x2, 3, 2, axis=-1), rtol=1e-10, atol=1e-12)
    # custom taps path + error
    taps = flt.firwin(31, 0.4)
    y = flt.resample_poly(x2, 2, 1, taps=taps)
    assert y.shape == (3, 1000)
    import pytest
    with pytest.raises(ValueError):
        flt.resample_poly(x2, 0, 1)


def test_downsample_upsample_golden_vs_genuine_reference():
    """down/upsample vs the GENUINE reference filters module (butter(2)
    filtfilt + interp chain, reference filters.py:20-123)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "refshim"))
    import FFT.filters as reff
    rng = np.random.default_rng(8)
    fs, nt = 4e4, 1 << 12
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 800.0 * t) + 0.05 * rng.standard_normal(nt)
    ours = np.asarray(flt.downsample(x, fs, 1e4))
    ref = np.asarray(reff.downsample(x, fs, 1e4, plotit=False))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(ref)))
    up_ours = np.asarray(flt.upsample(ours, 1e4, 2e4))
    up_ref = np.asarray(reff.upsample(ours, 1e4, 2e4, plotit=False))
    assert up_ours.shape == up_ref.shape
    np.testing.assert_allclose(up_ours, up_ref, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(up_ref)))
