"""Reference-parity goldens for the five BASELINE benchmark configs.

SURVEY §4(b): run the reference's homebrew path on the BASELINE configs on
CPU and assert the framework's implementation matches within the stated
SNR/tolerance bound.  Sizes are scaled down (the bench runs the full sizes
on hardware); the *configurations* — window, overlap, filters, demod chain —
are the BASELINE ones (BASELINE.json / BASELINE.md).
"""
import numpy as np
import pytest

import pyfft_tpu as ft


FS = 1e5
NT = 1 << 15


@pytest.fixture(scope="module")
def tone():
    rng = np.random.default_rng(0)
    t = np.arange(NT) / FS
    x = np.sin(2 * np.pi * 9.7e3 * t) + 0.3 * rng.standard_normal(NT)
    return t, x.astype(np.float64)


def test_config1_welch_psd_golden(ref_fft, tone):
    """Config 1: single-channel Welch PSD, sine+noise, Hann, 50% overlap."""
    t, x = tone
    kw = dict(tbounds=[t[1], t[-2]], windowfunction="hanning",
              windowoverlap=0.5, Navr=15, plotit=False, verbose=False)
    f1, _, Pxx1, *_ = ft.fft_pwelch(t, x, x, **kw)
    f2, _, Pxx2, *_ = ref_fft.fft_pwelch(t, x, x, **kw)
    np.testing.assert_allclose(f1, f2, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Pxx1), Pxx2, rtol=1e-9,
                               atol=1e-12 * np.max(np.abs(Pxx2)))


def test_config2_stft_chirp_golden(ref_fft):
    """Config 2: COLA-constrained STFT spectrogram of a chirp (fftanal
    class path, reference fft_win hot loop)."""
    rng = np.random.default_rng(1)
    t = np.arange(NT) / FS
    f_inst = 1e3 + (2e4 - 1e3) * np.arange(NT) / NT
    chirp = (np.sin(2 * np.pi * np.cumsum(f_inst) / FS)
             + 0.01 * rng.standard_normal(NT))
    ours = ft.fftanal(t, chirp, chirp, tper=2048 / FS, plotit=False,
                      verbose=False)
    ours.pwelch()
    ref = ref_fft.fftanal(t, chirp, chirp, tper=2048 / FS, plotit=False,
                          verbose=False)
    ref.pwelch()
    np.testing.assert_allclose(np.asarray(ours.freq), ref.freq, atol=1e-9)
    s = np.max(np.abs(ref.Xfft))
    np.testing.assert_allclose(np.asarray(ours.Xfft), ref.Xfft,
                               rtol=1e-7, atol=1e-9 * s)
    np.testing.assert_allclose(np.asarray(ours.Pxx), ref.Pxx, rtol=1e-8,
                               atol=1e-12 * np.max(np.abs(ref.Pxx)))


def test_config3_fir_notch_chain(tone):
    """Config 3: FIR band-pass + notch chain.  The FIR convolution must be
    exact vs numpy; the notch must bite at its design frequency (the
    reference's IIR filtfilt has no streaming parallel form — the documented
    equivalence is linear-phase FIR, PARITY.md)."""
    t, x = tone
    bp = np.asarray(ft.filters.firwin(129, [0.05, 0.45], pass_zero=False))
    b, a = ft.iirnotch(2 * 9.7e3 / FS, 30.0)
    notch = np.asarray(ft.filters.iir_to_fir(b, a, ntaps=257))
    taps = np.convolve(bp, notch)
    y = np.asarray(ft.filters.fir_filter(x.astype(np.float32), taps))
    want = np.convolve(x, taps, mode="full")[:NT]
    np.testing.assert_allclose(y, want, rtol=5e-5,
                               atol=5e-5 * np.max(np.abs(want)))
    # the 9.7 kHz line must be strongly attenuated by the notch
    f, _, Pin, *_ = ft.fft_pwelch(t, x, x, Navr=15, plotit=False,
                                  verbose=False)
    fo, _, Pout, *_ = ft.fft_pwelch(t, y.astype(np.float64),
                                    y.astype(np.float64), Navr=15,
                                    plotit=False, verbose=False)
    ipk = int(np.argmin(np.abs(np.asarray(f) - 9.7e3)))
    assert np.abs(np.asarray(Pout)[ipk]) < 0.05 * np.abs(np.asarray(Pin)[ipk])


def test_config4_hilbert_demod_golden(ref_hilbert):
    """Config 4: Hilbert analytic-signal envelope/phase demodulation."""
    t = np.arange(NT) / FS
    am = (1 + 0.5 * np.sin(2 * np.pi * 50.0 * t)) * np.sin(
        2 * np.pi * 5e3 * t)
    z_ref = ref_hilbert.hilbert(am)
    z = np.asarray(ft.hilbert(am))
    np.testing.assert_allclose(z.real, np.real(z_ref), atol=1e-9)
    np.testing.assert_allclose(z.imag, np.imag(z_ref), atol=1e-9)
    from pyfft_tpu.hilbert import envelope_phase
    env, ph = envelope_phase(am)
    # float32 device path vs float64 reference envelope
    np.testing.assert_allclose(env, np.abs(z_ref), atol=2e-4)


def test_config5_cross_coherence_cog_golden(ref_fft, ref_doppler):
    """Config 5: multi-channel cross-coherence + Doppler COG on complex IQ
    (two-sided spectra, reference fft_analysis.py:423-427, Doppler.cog)."""
    rng = np.random.default_rng(5)
    t = np.arange(NT) / FS
    z = (np.exp(1j * 2 * np.pi * 4.0e3 * t)
         + 0.1 * (rng.standard_normal(NT) + 1j * rng.standard_normal(NT)))
    w = 0.5 * z * np.exp(-1j * 0.7) + 0.05 * (
        rng.standard_normal(NT) + 1j * rng.standard_normal(NT))
    kw = dict(tbounds=[t[1], t[-2]], Navr=15, windowfunction="hanning",
              plotit=False, verbose=False)
    f1, Pxy1, Pxx1, Pyy1, Cxy1, phi1, _ = ft.fft_pwelch(t, z, w, **kw)
    f2, Pxy2, Pxx2, Pyy2, Cxy2, phi2, _ = ref_fft.fft_pwelch(t, z, w, **kw)
    assert np.asarray(f1).min() < 0  # two-sided (complex input)
    np.testing.assert_allclose(f1, f2, atol=1e-9)
    s = np.max(np.abs(Pxx2))
    np.testing.assert_allclose(np.asarray(Pxx1), Pxx2, rtol=1e-9,
                               atol=1e-12 * s)
    np.testing.assert_allclose(np.asarray(Pxy1), Pxy2, rtol=1e-9,
                               atol=1e-12 * s)
    # Doppler line at +4 kHz with the injected -0.7 cross-phase
    ipk = int(np.argmax(np.abs(np.asarray(Pxy1))))
    assert abs(np.asarray(f1)[ipk] - 4.0e3) < FS / 512
    assert abs(np.asarray(phi1)[ipk] + 0.7) < 0.05
    # COG of the IQ spectrum vs the genuine reference Doppler.cog
    ours = ft.cog(np.asarray(z), fs=FS)
    ref = ref_doppler.cog(z, fs=FS)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-6)
