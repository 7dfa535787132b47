"""Correlation toolbox on the device.

Role of the reference ``ccf.py``: normalized cross-correlation with time
lags, sliding-window averaged CCF, optimal-delay alignment, and the
pedagogical convolution/correlation identities.

The production correlation path runs through the framework's overlap-save
convolution (:func:`pyfft_tpu.filters.oaconvolve`) — batched block FFTs on
the device instead of ``numpy.correlate``'s O(N^2) loop.
"""
from __future__ import annotations

import numpy as np

from .utils.interp import sliding_window_1d
from .filters import oaconvolve


__all__ = ["ccf", "ccf_sh", "align_signals", "conv", "corr", "fftconv",
           "fftcorr", "convolve_fft", "cross_correlation_fft"]


def _correlate_full(a, b):
    """``numpy.correlate(a, b, 'full')`` via overlap-save convolution."""
    a = np.asarray(a)
    b = np.asarray(b)
    return oaconvolve(a, np.conj(b)[::-1], mode="full")


def ccf(x1, x2, fs):
    """Normalized cross-covariance and time lags (reference ``ccf``, :66-77).

    Returns ``(tau, co)`` with ``tau = -lags/fs`` (the reference's sign
    convention) and ``co`` the cross-covariance normalized by
    ``npts * std(x1) * std(x2)``.
    """
    x1 = np.asarray(x1, dtype=np.float64)
    x2 = np.asarray(x2, dtype=np.float64)
    npts = len(x1)
    lags = np.arange(-npts + 1, npts)
    tau = -lags / float(fs)
    ccov = _correlate_full(x1 - x1.mean(), x2 - x2.mean())
    co = ccov / (npts * x1.std() * x2.std())
    return tau, co


def ccf_sh(x1, x2, fs, nav):
    """Sliding-window averaged CCF (reference ``ccf_sh``, :80-104).

    Splits both series into ``nav``-sample windows, cross-correlates the
    i-th sample track of each window, and averages — reproducing the
    reference's (decimated-track) averaging semantics.
    """
    _, xs1, _ = sliding_window_1d(x1, x1, nav, ss=None)
    _, xs2, _ = sliding_window_1d(x1, x2, nav, ss=None)
    xs1 = np.asarray(xs1)
    xs2 = np.asarray(xs2)

    co = np.zeros((2 * len(xs1) - 1, nav))
    tau = None
    for ii in range(nav):
        tau, co[:, ii] = ccf(xs1[:, ii], xs2[:, ii], fs)
    csh = np.mean(co, 1)
    return tau, csh


def _preconvolve_fft(a, b):
    """Zero-pad ``b`` for centered FFT correlation (reference :255-265;
    the reference's float ``n/2`` index is fixed with integer division)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim > 1 or b.ndim > 1:
        raise ValueError("Can only vectorize vectors")
    if len(b) > len(a):
        a, b = b, a
    n = len(a)
    return np.hstack([np.zeros(n // 2), b,
                      np.zeros(n // 2 + len(a) - len(b) + 1)])


def convolve_fft(a, b, mode="valid"):
    """Centered FFT convolution (reference ``convolve_fft``, :267-283)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if len(b) > len(a):
        a, b = b, a
    c = _preconvolve_fft(a, b)
    return oaconvolve(c, a, mode=mode)


def cross_correlation_fft(a, b, mode="valid"):
    """Centered FFT cross-correlation (reference :285-303)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if len(b) > len(a):
        a, b = b, a
    c = _preconvolve_fft(a, b)
    return oaconvolve(c, a[::-1], mode=mode)


def align_signals(a, b):
    """Optimal integer delay aligning ``b`` to ``a``
    (reference ``align_signals``, :28-59): maximizes the cross-correlation.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim > 1 or b.ndim > 1:
        raise ValueError("Can only vectorize vectors")
    sign = 1
    if len(b) > len(a):
        sign = -1
        a, b = b, a
    r = cross_correlation_fft(a, b)
    shift = int(np.argmax(r)) - len(a) + len(a) // 2
    if len(a) % 2 and len(b) % 2:
        shift += 1
    if len(a) > len(b) and len(a) % 2 and not (len(b) % 2):
        shift += 1
    return sign * shift


# --------------------------------------------------------------------------- #
# Pedagogical identities (reference ccf.py:180-248)
# --------------------------------------------------------------------------- #

def conv(x, y):
    """Discrete causal convolution (reference ``conv``, :180-193)."""
    return list(np.convolve(np.asarray(x), np.asarray(y)))


def corr(x, y):
    """Causal correlation with the reference's non-shifted index layout
    (reference ``corr``, :197-224): ``[t=0..Q-1]`` then ``[t=-(P-1)..-1]``.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    P, Q = len(x), len(y)
    full = np.correlate(y, x, mode="full")  # R[t] = sum x[i] y[i+t]
    # full index k corresponds to t = k - (P - 1), t in [-(P-1), Q-1]
    z1 = [full[t + P - 1] for t in range(Q)]
    z2 = [full[t + P - 1] for t in range(-(P - 1), 0)]
    return z1 + z2


def fftconv(x, y):
    """Elementwise-product convolution of pre-padded sequences
    (reference ``fftconv``, :227-236)."""
    from .ops import transform
    X = transform.fft(np.asarray(x, dtype=complex))
    Y = transform.fft(np.asarray(y, dtype=complex))
    return list(transform.ifft(X * Y))


def fftcorr(x, y):
    """Elementwise-product correlation of pre-padded sequences
    (reference ``fftcorr``, :239-248; the reference's broken tuple-unpack is
    completed to the documented ``Rxy <==> X' Y`` relation)."""
    from .ops import transform
    X = transform.fft(np.asarray(x, dtype=complex))
    Y = transform.fft(np.asarray(y, dtype=complex))
    return list(transform.ifft(np.conj(X) * Y))


def ccf_test(plotit=False, seed=0):
    """Known 50-degree phase lag (reference ``ccf_test``, ccf.py:139-156):
    the cross-covariance peak must sit at t = -phi/(2 pi f).  Returns
    ``(tau, co, expected_lag_s)``."""
    rng = np.random.default_rng(seed)
    fs, N, f = 1e5, 2048, 1e3
    phi = 50 * np.pi / 180
    t = np.arange(0, N) / fs
    x1 = np.sin(2 * np.pi * f * t) + rng.normal(0, 1, N)
    x2 = np.sin(2 * np.pi * f * t + phi) + rng.normal(0, 1, N)
    tau, co = ccf(x1, x2, fs)
    expected = -phi / (2 * np.pi * f)
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("ccf_test")
        plt.plot(np.asarray(tau) * 1e6, co)
        plt.axvline(expected * 1e6, color="k")
    return tau, co, expected


def ccf_sh_test(plotit=False, seed=0):
    """Sliding-window averaged variant (reference ``ccf_sh_test``,
    ccf.py:158-175)."""
    rng = np.random.default_rng(seed)
    fs, N, f = 1e5, 2048, 1e3
    phi = 50 * np.pi / 180
    t = np.arange(0, N) / fs
    x1 = np.sin(2 * np.pi * f * t) + rng.normal(0, 1, N)
    x2 = np.sin(2 * np.pi * f * t + phi) + rng.normal(0, 1, N)
    tau, co = ccf_sh(x1, x2, fs, nav=64)
    expected = -phi / (2 * np.pi * f)
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("ccf_sh_test")
        plt.plot(np.asarray(tau) * 1e6, co)
    return tau, co, expected
