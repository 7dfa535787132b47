"""Doppler reflectometry analysis: center-of-gravity spectra and the
synthetic IQ-demodulation chain.

Role of the reference ``Doppler.py``: ``cog`` (PSD-weighted mean frequency,
:43-59), ``cogspec`` (sliding-window COG followed by a PSD of the COG
series, :62-126), and the synthetic reflectometer test chain
``test_DopplerSignal`` (:164-281) — carrier/LO mixing, sideband filtering by
downsampling, I/Q demodulation, and a two-sided Welch analysis of the
complex video signal.

Batched: ``cog`` over sliding windows is evaluated as ONE batched
windowed-FFT (windows are a batch axis feeding the device transform);
the reference's per-window Python loop does not exist.
"""
from __future__ import annotations

import numpy as np

from .utils.interp import sliding_window_1d
from .ops import transform
from .filters import downsample, downsample_efficient  # noqa: F401 (API parity)
from .fftanal import fftanal


__all__ = ["cog", "cogspec", "doppler_iq_chain", "test_DopplerSignal"]


def cog(x, fs, fmin=None, fmax=None):
    """Center of gravity (PSD-weighted mean frequency) of a signal.

    Reference ``cog`` (``Doppler.py:43-59``): two-sided spectrum scaled by
    ``1/sqrt(n/2)``, optional band masking on ``|freq|``, weighted mean.
    (The reference masks ``spec`` with indices computed from the *already
    masked* freq array — a latent defect; the mask is applied consistently
    here.)
    """
    x = np.asarray(x)
    if fmax is None:
        fmax = fs
    n = len(x)
    freq = np.fft.fftshift(np.fft.fftfreq(n, 1 / fs))
    spec = np.fft.fftshift(transform.fft(x)) / np.sqrt(n / 2)
    if fmin is not None:
        keep = (np.abs(freq) >= fmin) & (np.abs(freq) <= fmax)
        freq = freq[keep]
        spec = spec[keep]
    if len(freq) > 0:
        p = np.abs(spec) ** 2
        return np.sum(p * freq) / np.sum(p)
    return 0.0


def _cog_batched(xw, fs, fmin=None, fmax=None):
    """COG of each row of ``xw`` (nwin, wl) in one batched transform."""
    xw = np.asarray(xw)
    n = xw.shape[-1]
    freq = np.fft.fftshift(np.fft.fftfreq(n, 1 / fs))
    spec = np.fft.fftshift(transform.fft(xw, axis=-1), axes=-1) / np.sqrt(n / 2)
    p = np.abs(spec) ** 2
    if fmin is not None:
        if fmax is None:
            fmax = fs
        keep = (np.abs(freq) >= fmin) & (np.abs(freq) <= fmax)
        freq = freq[keep]
        p = p[..., keep]
    return np.sum(p * freq, axis=-1) / np.sum(p, axis=-1)


def _psd_rows(xw, fs, nfft, fmax=None):
    """One-segment Hann periodogram of each row, as ONE batched transform.

    mlab density conventions (matches ``crosscheck.psd`` for rows whose
    length equals ``nfft``): Hann window, ``|X|^2 / (fs * S2)``, one-sided
    bin doubling.  Replaces the per-window ``psd`` loop of the reference
    ``cogspec`` (``Doppler.py:96-98`` analogue) with a device batch.
    """
    xw = np.asarray(xw)[..., :nfft]
    win = np.hanning(nfft)
    X = np.asarray(transform.fft(xw * win[None, :], axis=-1))
    P = np.abs(X) ** 2 / (fs * (win ** 2).sum())
    nret = nfft // 2 + 1
    P = P[..., :nret].copy()
    if nfft % 2:
        P[..., 1:] *= 2.0
    else:
        P[..., 1:-1] *= 2.0
    F = np.abs(np.fft.fftfreq(nfft, 1.0 / fs)[:nret])
    if nfft % 2 == 0:
        F[-1] = fs / 2.0
    if fmax is not None:
        keep = F <= fmax
        F = F[keep]
        P = P[..., keep]
    return P, F


def cogspec(t, x, fs, fmin=100, fmax=500e3, n=256, win=512, ov=0.5, plotit=0):
    """Spectrum of the center-of-gravity time series.

    Reference ``cogspec`` (``Doppler.py:62-126``): sliding-window COG (hop
    ``(1-ov) win``), then a PSD of the COG series over ``win``-sample
    windows.  Returns the reference's result dict (``cog``, ``tcog``,
    ``cogfs``, ``cogspec``, ``cogspecf``, ``cogspectime``...).
    """
    t = np.asarray(t)
    x = np.asarray(x)
    hop = int(np.floor((1.0 - ov) * win))
    ind = np.asarray(sliding_window_1d(t, x, win, hop, ind_only=True))
    N = ind.shape[0]

    tw, xw, tc = sliding_window_1d(t, x, win, hop)
    coge = _cog_batched(np.asarray(xw), fs)
    tcog = np.asarray(tc)

    winstep = int(np.floor(win * ov))
    tw2, cogw, tcogw = sliding_window_1d(tcog, coge, win, winstep)
    cogw = np.asarray(cogw)
    cogfs = 1 / (tcog[1] - tcog[0]) * 1000  # kHz convention of the reference

    PS, F = _psd_rows(cogw, cogfs, nfft=win, fmax=fmax)

    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(12, 6), facecolor="w")  # noqa: F841
        PSn = PS / np.max(PS)
        h = plt.subplot(3, 1, 1)
        plt.pcolormesh(np.asarray(tcogw), F / 1e3,
                       10 * np.log10(np.transpose(PSn)), cmap="bwr")
        plt.xlabel("time [ms]")
        plt.ylabel("freq [kHz]")
        plt.subplot(3, 1, 2)
        plt.plot(F / 1e3, 10 * np.log10(np.sum(PSn, axis=0)))
        plt.subplot(3, 1, 3, sharex=h)
        plt.plot(tcog, coge)

    return {"cogfs": cogfs, "cog": coge, "tcog": tcog, "cogtime": tcog,
            "cogspectime": np.asarray(tcogw), "cogspec": PS, "cogspecf": F,
            "ind": ind, "N": N}


def doppler_iq_chain(fs=50e3, fsig=10e3, psig=0.25 * np.pi, LO=6e6, IF=0.3e6,
                     N=2 ** 21, amp=1.0, ampModulation=None):
    """Synthetic reflectometer chain -> complex video signal.

    The signal-generation half of the reference ``test_DopplerSignal``
    (``Doppler.py:164-225``): single-sideband plasma return (or AM/FM
    variants), LO mixing, downsampling to 3*IF, I/Q demodulation, and
    downsampling to the video bandwidth.  Returns ``(time, sigz)`` with
    ``sigz = I + jQ``.
    """
    fmult = 2 * LO + IF
    time = np.arange(N) / (3 * fmult)

    mod = amp * np.sin(2 * np.pi * fsig * time)
    carrier = np.sin(2 * np.pi * fmult * time)

    if ampModulation is None:
        sigz = amp * np.sin(2 * np.pi * (fmult - fsig) * time - psig)
    elif ampModulation:
        sigz = 2 * carrier * mod
    else:
        sigz = np.sin(2.0 * np.pi * (fmult * time + mod))

    locosc = np.sin(2 * np.pi * (fmult - IF) * time)
    sigz = 2 * locosc * sigz

    sigz = np.asarray(downsample(sigz, 3 * fmult, 3 * IF)).flatten()
    time = np.arange(time[0], time[-1], 1.0 / (3 * IF))

    Isig = 2 * sigz * np.sin(2.0 * np.pi * IF * time)
    Qsig = -2 * sigz * np.cos(2.0 * np.pi * IF * time)

    Isig = np.asarray(downsample(Isig, 3 * IF, fs)).flatten()
    Qsig = np.asarray(downsample(Qsig, 3 * IF, fs)).flatten()
    time = np.arange(time[0], time[-1], 1.0 / fs)

    n = min(len(time), len(Isig), len(Qsig))
    return time[:n], (Isig + 1j * Qsig)[:n]


def test_DopplerSignal(ampModulation=None, N=2 ** 21, plotit=False):
    """Full synthetic Doppler analysis (reference ``test_DopplerSignal``,
    ``Doppler.py:164-281``): generate the IQ chain, run a two-sided Welch
    analysis of the complex video signal, convert to amplitudes.

    Returns the :class:`fftanal` instance; for the single-sideband case the
    demodulated video signal is ``z = -j exp(j(2 pi fsig t + psig))``, so
    the Doppler line appears at ``+fsig`` with the injected phase.
    """
    fs = 50e3
    fsig = 10e3
    time, sigz = doppler_iq_chain(fs=fs, fsig=fsig, N=N,
                                  ampModulation=ampModulation)

    ft = fftanal(tvec=time, sigx=sigz, minFreq=0.3 * fsig, plotit=False,
                 verbose=False)
    ft.pwelch()
    ft.convert2amplitudes()

    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        phi = np.angle(np.asarray(ft.Xfft))
        plt.figure()
        ax1 = plt.subplot(2, 1, 1)
        plt.plot(ft.freq, np.abs(np.asarray(ft.Lxx)), "b-")
        plt.subplot(2, 1, 2, sharex=ax1)
        plt.plot(ft.freq, phi, "r-")
    return ft
