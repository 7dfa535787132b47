"""Spectrograms and the STFT convenience wrapper.

Role of the reference ``spectrogram.py``: the simple hop-loop spectrogram
``specgram`` (reference ``spectrogram.py:49-134``, with its sqrt(8/3)
Hanning power correction at ``:109``) and the ``stft`` wrapper that drives an
``fftanal`` instance (``:140-168``), plus the ``test_case`` signal generator
(``:172-202``).

Batched: the per-window loop becomes one frame->window->|FFT|^2 device
pipeline; windows are a batch axis.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import segmentation as seg
from .ops import mxu_fft
from .fftanal import fftanal


__all__ = ["specgram", "stft", "test_case", "STFT"]


@partial(jax.jit, static_argnames=("wl", "hop", "nwin"))
def _power_frames_xla(s, win, *, wl, hop, nwin):
    fr = seg.frame_signal(s, wl, hop, nwin)            # (nwin, wl)
    X = jnp.fft.fft(fr * win, axis=-1)
    return (X * jnp.conj(X)).real


@partial(jax.jit, static_argnames=("wl", "hop", "nwin"))
def _power_frames_mxu(s, win, *, wl, hop, nwin):
    fr = seg.frame_signal(s, wl, hop, nwin)
    Xr, Xi = mxu_fft.fft_pair(fr * win, None, n=wl, axis=-1)
    return Xr * Xr + Xi * Xi


def _power_frames(s, win, wl, hop, nwin):
    from .spectral import backend_supports_complex
    s = jnp.asarray(np.asarray(s))
    win = jnp.asarray(np.asarray(win), dtype=s.dtype)
    if backend_supports_complex():
        out = _power_frames_xla(s, win, wl=wl, hop=hop, nwin=nwin)
    else:
        out = _power_frames_mxu(s, win, wl=wl, hop=hop, nwin=nwin)
    return np.asarray(out)


def specgram(t, s, wl=512, hanning=True, overlap=True, windowAverage=None):
    """Simple spectrogram: returns ``(time, fAxis, spectrogram[wl, nW])``.

    Behavior-parity with reference ``specgram`` (``spectrogram.py:49-134``):
    hop of ``wl/2`` (overlap) or ``wl``; per-window two-sided power
    ``|FFT(hanning * seg)|^2 / wl`` with the sqrt(8/3) Hanning correction;
    optional non-overlapped window averaging; reference time-axis formulas.
    """
    s = np.asarray(s).flatten()
    t = np.asarray(t)
    n = len(s)
    dt = np.abs(t[1] - t[0])
    wl = int(wl)

    if windowAverage is not None:
        overlap = False

    if overlap:
        nW = 2 * (n - (n % wl)) // wl - 1
        hop = wl // 2
    else:
        nW = (n - (n % wl)) // wl - 1
        hop = wl
    if nW < 1:
        raise ValueError(f"window length {wl} too long for {n} samples")

    win = np.hanning(wl) if hanning else np.ones(wl)
    power = _power_frames(s, win, wl, hop, nW) / wl      # (nW, wl)
    if hanning:
        power = np.sqrt(8.0 / 3.0) * power
    spectrogram_arr = power.T                             # (wl, nW)

    fAxis = np.fft.fftfreq(wl, dt)
    if windowAverage is not None:
        windowAverage = int(windowAverage)
        nA = nW // windowAverage
        avg = spectrogram_arr[:, :nA * windowAverage]
        avg = avg.reshape(wl, nA, windowAverage).mean(axis=-1)
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nA)
        return time, fAxis, avg
    if not overlap:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nW)
    else:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW / 2 - 1) + 1 / 2), num=nW)
    return time, fAxis, spectrogram_arr


def stft(tt, y_in, tper=None, returnclass=True, **kwargs):
    """Short-time Fourier transform via the :class:`fftanal` pipeline.

    API parity with reference ``stft`` (``spectrogram.py:140-168``):
    ``tper`` defaults to a twentieth of the span; returns the class or
    ``(twin, freq, Xseg)``.
    """
    tt = np.asarray(tt)
    if tper is None:
        tper = (tt[-1] - tt[0]) / 20
        if tper < tt[2] - tt[1]:
            print("check your stft window size")

    Ystft = fftanal(verbose=kwargs.get("verbose", False))
    kwargs.setdefault("plotit", False)
    Ystft.init(tt, np.asarray(y_in), tper=tper, **kwargs)
    Ystft.stft()

    if returnclass:
        return Ystft
    twin = np.linspace(tt[0], tt[-1], num=Ystft.Navr, endpoint=True)
    return twin, Ystft.freq, Ystft.Xseg


def test_case(case=3, npts=2e3):
    """Reference test-signal generator (``spectrogram.py:172-202``):
    1 = pure sine, 2 = frequency step, 3 = chirp via cumulative phase."""
    npts = int(npts)
    if case == 1:
        tt = np.linspace(0, 1.0, num=npts, endpoint=True)
        dt = tt[2] - tt[1]
        f0 = 0.1 / dt
        y_in = np.sin(2 * np.pi * f0 * tt - 0.0)
    elif case == 2:
        _t0 = np.linspace(0, 1.0, num=npts, endpoint=True)
        _t1 = np.linspace(_t0[-1] + _t0[1] - _t0[0], 2.0 * _t0[-1], num=npts,
                          endpoint=True)
        tt = np.concatenate([_t0, _t1])
        dt = tt[2] - tt[1]
        f0 = 0.05 / dt
        f1 = 0.08 / dt
        y_in = np.concatenate([np.sin(2 * np.pi * f0 * _t0),
                               np.sin(2 * np.pi * f1 * _t1)])
    else:
        tt = np.linspace(0, 1.0, num=npts, endpoint=True)
        Fs = 1.0 / (tt[1] - tt[0])
        f_in = np.linspace(100, 200, num=len(tt), endpoint=True)
        phase_in = np.cumsum(f_in / Fs)
        y_in = np.sin(2.0 * np.pi * phase_in)
    return tt, y_in


class STFT:
    """Hop-based STFT helper (role of the reference's standalone ``STFT``
    class, ``spectrogram.py:295-352``), batched instead of looped."""

    def __init__(self, data, fs, win_size, fft_size, overlap_fac=0.5):
        self.data = np.asarray(data, dtype=np.float32)
        self.fs = int(fs)
        self.win_size = int(win_size)
        self.fft_size = int(fft_size)
        self.overlap_fac = float(1 - overlap_fac)
        self.hop_size = int(np.floor(self.win_size * self.overlap_fac))
        self.pad_end_size = self.fft_size
        self.total_segments = int(np.ceil(len(self.data) / float(self.hop_size)))
        self.t_max = len(self.data) / float(self.fs)

    def stft(self, scale="log", ref=1.0, clip=None):
        from .ops import transform
        window = np.hanning(self.win_size) * self.overlap_fac * 2
        proc = np.concatenate([self.data, np.zeros(self.pad_end_size)])
        nseg = self.total_segments
        idx = (np.arange(nseg)[:, None] * self.hop_size
               + np.arange(self.win_size)[None, :])
        idx = np.minimum(idx, len(proc) - 1)
        frames = proc[idx] * window
        padded = np.pad(frames,
                        ((0, 0), (0, 2 * self.fft_size - self.win_size)))
        spectrum = transform.fft(padded, axis=-1) / self.fft_size
        autopower = np.abs(spectrum * np.conj(spectrum))[:, :self.fft_size]
        result = autopower.astype(np.float32)
        if scale == "log":
            result = self.dB(result, ref)
        if clip is not None:
            result = np.clip(result, clip[0], clip[1])
        return result

    def dB(self, data, ref=1.0):
        with np.errstate(divide="ignore"):
            return 20 * np.log10(data / ref)

    def freq_axis(self):
        return np.arange(self.fft_size) / np.float32(self.fft_size * 2) * self.fs

    def time_axis(self):
        return np.arange(self.total_segments) / np.float32(self.total_segments) \
            * self.t_max


def test_stft(windowfunction=None, npts=2e3, Nper=21, plotit=False):
    """Chirp STFT demo (reference ``test_stft``, spectrogram.py:250-283).

    Returns the ``fftanal`` instance holding the spectrogram."""
    tt, y_in = test_case(case=3, npts=npts)
    if windowfunction is None:
        windowfunction = "None"            # reference default: no window
    tper = (tt[-1] - tt[0]) / Nper
    out = stft(tt, y_in, tper=tper, windowfunction=windowfunction,
               plotit=plotit, verbose=False)
    return out


def test_specgram(windowfunction="hanning", npts=2e3, Nper=21, plotit=False):
    """Chirp spectrogram demo (reference ``test_specgram``, :205-247)."""
    tt, y_in = test_case(case=3, npts=npts)
    wl = int(len(y_in) // Nper)
    res = specgram(tt, y_in, wl)
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        tspec, fAxis, S = res
        plt.figure("test_specgram")
        plt.pcolormesh(tspec, fAxis, np.abs(np.asarray(S)), shading="auto")
    return res
