"""Numerical Laplace transform on a sigma grid.

Role of the reference ``laplace.py``: a brute-force bilateral Laplace
transform evaluated as a family of exponentially-weighted Fourier transforms
over a grid of real parts ``sigma`` (reference ``laplace_1d``,
``laplace.py:85-113``).

Batched redesign: the reference's Python loop over the sigma grid becomes
one batched weighted-rfft: build the normalized weight matrix
``W[s, m] = exp(sigma_s (N-1-m)) / sum_n exp(sigma_s n)`` on the host, then a
single ``(nsigma, N)`` batched rfft on the device — the sigma axis is a pure
batch dimension.
"""
from __future__ import annotations

import numpy as np

from .ops import transform


__all__ = ["laplace", "laplace_1d"]


def laplace(uin=None, **kwargs):
    """2-D Laplace transform — reserved (the reference's ``laplace`` is an
    empty stub, ``laplace.py:81``).  Delegates to :func:`laplace_1d`."""
    if uin is None:
        return None
    return laplace_1d(uin, **kwargs)


def laplace_1d(uin, real_sigma_interval=None, nfft=None, sigma_block=None):
    """Bilateral Laplace transform over a grid of real parts.

    Returns a complex array of shape ``(nsigma, nfft//2 + 1)``: rows are the
    sigma grid, columns the rfft frequency bins — matching the reference's
    output layout (``laplace.py:104-113``).

    The reference normalizes each exponential weight by its own sum and
    applies it to the time-reversed signal; both conventions are preserved
    (weights ``exp(sigma (N-1-m)) / sum exp(sigma n)`` after unwinding the
    double reversal at ``laplace.py:101`` and ``:109``).

    The sigma rows are independent, so the weight matrix is synthesized
    and transformed in sigma blocks of ``sigma_block`` rows (default:
    sized to keep the ``(block, N)`` float64 intermediate under ~256 MB).
    The reference's default 2001-point grid on a 2^21-sample signal would
    otherwise materialize a ~34 GB weight matrix before the first
    transform; chunked, peak memory is O(block * N) plus the output.
    The exponent arithmetic stays float64 per block (its dynamic range is
    ``|sigma| * N`` — float32 exponents lose whole units of log-weight at
    production sizes); only the bounded exp'd weights are cast down.
    """
    uin = np.atleast_1d(np.asarray(uin))
    if real_sigma_interval is None:
        real_sigma_interval = np.arange(-1, 1 + 0.001, 0.001)
    sig = np.asarray(real_sigma_interval, dtype=np.float64)
    N = len(uin) if nfft is None else int(nfft)
    x = uin[:N] if len(uin) >= N else np.pad(uin, (0, N - len(uin)))
    dt = (np.float64 if x.dtype == np.float64
          else np.result_type(x, np.float32))

    nsigma = sig.size
    if sigma_block is None:
        sigma_block = int(max(1, min(nsigma, (1 << 25) // max(N, 1))))
    n = np.arange(N, dtype=np.float64)
    outs = []
    for i in range(0, nsigma, int(sigma_block)):
        sb = sig[i:i + int(sigma_block)]
        # log-space normalization keeps large |sigma * N| finite
        expo = sb[:, None] * (N - 1 - n)[None, :]
        logz = np.logaddexp.reduce(sb[:, None] * n[None, :], axis=1)
        W = np.exp(expo - logz[:, None])
        outs.append(np.asarray(transform.rfft((W * x[None, :]).astype(dt),
                                              axis=-1)))
    return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)


def test_laplace(plotit=False):
    """s-plane scan demo (reference ``test_laplace``, laplace.py:116-201):
    a damped sine scanned over a grid of real parts; the pole row shows the
    sharpest spectral line.  Returns ``(sigma, freq_bins, LP)``."""
    fs, n = 1000.0, 1024
    t = np.arange(n) / fs
    d, f0 = 60.0, 120.0
    x = np.exp(-d * t) * np.sin(2 * np.pi * f0 * t)
    sigma = np.arange(-0.2, 0.2, 0.005)
    LP = laplace_1d(x, real_sigma_interval=sigma)
    freq = fs * np.arange(LP.shape[1]) / n
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("test_laplace")
        plt.pcolormesh(freq, sigma, np.log10(np.abs(LP) + 1e-12),
                       shading="auto")
        plt.xlabel("freq [Hz]")
        plt.ylabel("sigma")
    return sigma, freq, LP
