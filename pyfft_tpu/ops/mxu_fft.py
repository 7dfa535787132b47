"""Real-arithmetic FFTs built on dense DFT matmuls (``fft_backend='mxu'``).

Why this exists
---------------
The framework was first built for a backend with no complex dtype, so this
transform layer is a *real-valued* Cooley-Tukey decomposition where every
butterfly stage is a dense DFT matmul.  On complex-capable backends the
default path is ``jnp.fft``; this one is reached only on request:

- complex data travels as a ``(re, im)`` pair of real arrays (``im=None``
  encodes an exactly-real array, so the first stage of an rfft does half the
  work for free);
- a length-``N`` transform is recursively factored ``N = N1 * N2`` (four-step
  / Bailey decomposition): columns-DFT (matmul), twiddle (elementwise, fused
  by XLA), rows-DFT (matmul), index transpose;
- leaves (``N <= leaf``) are direct DFT matmuls against constant cos/sin
  matrices — dense ``(batch, N) @ (N, N)`` contractions.

This replaces the role of ``numpy.fft`` as the reference's L1 transform
backend (reference ``fft_analysis.py:386``, ``dft.py:191`` pedagogical
butterfly) with a matmul design.  Accuracy: matmul stages run with
``precision='highest'`` by default (float32 carries ~1e-6 relative error up
to N ~ 1e6, log-depth error growth like an FFT).

FLOP shape: cost per level is ``4 * B * N * (N1 + N2)`` matmul MACs instead
of the scalar butterfly's ``5 N log2 N`` flops — far more arithmetic, run
at matrix-unit rates with no data-dependent shuffles.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


__all__ = ["fft_pair", "ifft_pair", "rfft_pair", "irfft_pair", "dft_matrices",
           "good_leaf_factorization", "balanced3_factorization", "fftfreq"]

_DEF_LEAF = 128


# --------------------------------------------------------------------------- #
# Constant DFT / twiddle tables (host-side, cached, closed over by jit)
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=None)
def dft_matrices(M: int, dtype=np.float32):
    """Cos/sin DFT matrices: ``W^{nk} = C[n,k] + j S[n,k]`` (forward sign)."""
    n = np.arange(M)
    ang = (2.0 * np.pi / M) * np.outer(n, n)
    C = np.cos(ang).astype(dtype)
    S = (-np.sin(ang)).astype(dtype)
    return C, S


@lru_cache(maxsize=None)
def _twiddle(N: int, n1: int, n2: int, dtype=np.float32):
    """Twiddle table ``T[n2, k1] = exp(-2 pi j n2 k1 / N)`` as (cos, sin)."""
    k1 = np.arange(n1)
    m2 = np.arange(n2)
    ang = (2.0 * np.pi / N) * np.outer(m2, k1)
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@lru_cache(maxsize=None)
def good_leaf_factorization(N: int, leaf: int = _DEF_LEAF):
    """Balanced factorization ``N = n1 * n2`` with ``n1 <= n2``.

    Prefers the factor pair closest to ``sqrt(N)``.  Returns ``None`` when
    ``N`` is prime (caller falls back to a direct DFT matmul or Bluestein).
    """
    best = None
    d = int(np.sqrt(N))
    while d >= 2:
        if N % d == 0:
            best = (d, N // d)
            break
        d -= 1
    return best


@lru_cache(maxsize=None)
def balanced3_factorization(N: int, maxf: int = 512):
    """Three factors ``n1 <= n2 <= n3 <= maxf`` with ``n1*n2*n3 == N``,
    minimizing ``n1+n2+n3`` (the matmul cost of a depth-3 contraction
    chain).  Returns ``None`` when no such split exists.

    Per ``n1``, the optimal ordered pair is the *largest* divisor
    ``n2 <= sqrt(N/n1)`` with ``n2 >= n1``: for a fixed product, the sum
    ``n2 + n3`` shrinks and the max factor ``n3`` shrinks as ``n2`` grows,
    so that pair simultaneously minimizes the cost and is the most likely
    to satisfy ``n3 <= maxf`` (if it violates ``maxf``, every ordered pair
    for this ``n1`` does).
    """
    from math import isqrt
    best = None
    n1 = 2
    while n1 * n1 * n1 <= N and n1 <= maxf:
        if N % n1 == 0:
            M = N // n1
            d = isqrt(M)
            while d >= n1 and M % d:
                d -= 1
            if d >= n1 and M // d <= maxf:
                cost = n1 + d + M // d
                if best is None or cost < best[0]:
                    best = (cost, (n1, d, M // d))
        n1 += 1
    return best[1] if best else None


# Above this size, a prime factor is handled with Bluestein's chirp-z
# (two power-of-two FFTs) instead of a direct O(p^2) DFT matmul.
_BLUESTEIN_THRESHOLD = 512

# rfft even/odd packing is a stride-2 de-interleave — cheap for the
# batched segment sizes of the Welch/overlap-save paths but a costly
# relayout for long 1-D transforms.  The packed path is therefore gated on
# the transform length.
_RFFT_PACK_MAX = 1 << 15


@lru_cache(maxsize=None)
def _max_prime_factor(N: int) -> int:
    m = N
    p = 1
    d = 2
    while d * d <= m:
        while m % d == 0:
            p = max(p, d)
            m //= d
        d += 1
    return max(p, m) if m > 1 else p


@lru_cache(maxsize=None)
def _bluestein_tables(N: int, dtype=np.float32):
    """Host-precomputed chirp tables for Bluestein's algorithm.

    ``a[n] = exp(-j pi n^2 / N)`` (applied to input and output) and the
    power-of-two-length FFT of the extended chirp ``v[n] = exp(+j pi n^2/N)``.
    Angles are reduced ``n^2 mod 2N`` in exact integer arithmetic so phase
    accuracy holds for large N; the chirp FFT is computed in float64 on the
    host and stored as constants.
    """
    M = 1 << int(np.ceil(np.log2(2 * N - 1)))
    sq = (np.arange(N, dtype=np.int64) ** 2) % (2 * N)
    ang = np.pi * sq.astype(np.float64) / N
    a_re = np.cos(ang)
    a_im = -np.sin(ang)
    v = np.exp(1j * ang)
    v_ext = np.zeros(M, dtype=np.complex128)
    v_ext[:N] = v
    if N > 1:
        v_ext[M - N + 1:] = v[1:][::-1]
    V = np.fft.fft(v_ext)
    return (M, a_re.astype(dtype), a_im.astype(dtype),
            V.real.astype(dtype), V.imag.astype(dtype))


def _bluestein_last(re, im, N, leaf, precision, dtype):
    """Length-N DFT as an M=2^k circular convolution (chirp-z transform)."""
    M, ar, ai, Vr, Vi = _bluestein_tables(N, dtype)
    ar = jnp.asarray(ar)
    ai = jnp.asarray(ai)
    Vr = jnp.asarray(Vr)
    Vi = jnp.asarray(Vi)

    ur, ui = _cmul_pair(re, im, ar, ai)
    pad = [(0, 0)] * (ur.ndim - 1) + [(0, M - N)]
    ur = jnp.pad(ur, pad)
    ui = jnp.pad(ui, pad)

    Ur, Ui = _fft_last(ur, ui, M, leaf, precision, dtype)
    Wr = Ur * Vr - Ui * Vi
    Wi = Ur * Vi + Ui * Vr
    # inverse FFT via conjugation
    wr, wi = _fft_last(Wr, -Wi, M, leaf, precision, dtype)
    wr = wr * (1.0 / M)
    wi = -wi * (1.0 / M)
    wr = wr[..., :N]
    wi = wi[..., :N]
    return _cmul_pair(wr, wi, ar, ai)


# --------------------------------------------------------------------------- #
# Pair arithmetic helpers
# --------------------------------------------------------------------------- #

def _dot(a, b, precision):
    return jnp.dot(a, b, precision=precision,
                   preferred_element_type=a.dtype)


def _dft_last(re, im, M, precision, dtype):
    """Direct DFT along the last axis via two (or four) matmuls."""
    C, S = dft_matrices(M, dtype)
    C = jnp.asarray(C)
    S = jnp.asarray(S)
    if im is None:
        return _dot(re, C, precision), _dot(re, S, precision)
    ro = _dot(re, C, precision) - _dot(im, S, precision)
    io = _dot(re, S, precision) + _dot(im, C, precision)
    return ro, io


def _cmul_pair(ar, ai, br, bi):
    """(ar + j ai) * (br + j bi) with ai possibly None (exact-real)."""
    if ai is None:
        return ar * br, ar * bi
    return ar * br - ai * bi, ar * bi + ai * br


# --------------------------------------------------------------------------- #
# Core recursive transform (last axis)
# --------------------------------------------------------------------------- #

def _fft_last(re, im, N, leaf, precision, dtype):
    if N == 1:
        return re, (jnp.zeros_like(re) if im is None else im)
    if N <= leaf:
        return _dft_last(re, im, N, precision, dtype)
    if _max_prime_factor(N) > _BLUESTEIN_THRESHOLD:
        # a large prime factor would force an O(p^2) DFT matmul with a huge
        # constant matrix; chirp-z re-expresses it as two 2^k FFTs instead
        if im is None:
            im = jnp.zeros_like(re)
        return _bluestein_last(re, im, N, leaf, precision, dtype)
    fac = good_leaf_factorization(N, leaf)
    if fac is None:
        # moderate prime length: direct matmul
        return _dft_last(re, im, N, precision, dtype)
    n1, n2 = fac

    batch = re.shape[:-1]
    # x[n1*n2 view]: n = n1_idx * n2 + n2_idx  ->  (..., n1, n2)
    re2 = re.reshape(batch + (n1, n2))
    im2 = None if im is None else im.reshape(batch + (n1, n2))

    # DFT over n1 (move it last): (..., n2, n1)
    re2 = jnp.swapaxes(re2, -1, -2)
    im2 = None if im2 is None else jnp.swapaxes(im2, -1, -2)
    yr, yi = _fft_last(re2, im2, n1, leaf, precision, dtype)

    # twiddle T[n2, k1]
    tc, ts = _twiddle(N, n1, n2, dtype)
    tc = jnp.asarray(tc)
    ts = jnp.asarray(ts)
    zr = yr * tc - yi * ts
    zi = yr * ts + yi * tc

    # DFT over n2: (..., n2, k1) -> (..., k1, n2)
    zr = jnp.swapaxes(zr, -1, -2)
    zi = jnp.swapaxes(zi, -1, -2)
    xr, xi = _fft_last(zr, zi, n2, leaf, precision, dtype)

    # X[k1 + n1*k2]: result currently (..., k1, k2) -> transpose -> flatten
    xr = jnp.swapaxes(xr, -1, -2).reshape(batch + (N,))
    xi = jnp.swapaxes(xi, -1, -2).reshape(batch + (N,))
    return xr, xi


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #

def _prep(x, n, axis):
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    L = x.shape[-1]
    if n is None:
        n = L
    if L < n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - L)]
        x = jnp.pad(x, pad)
    elif L > n:
        x = x[..., :n]
    return x, n


def fft_pair(re, im=None, n=None, axis=-1, leaf=_DEF_LEAF,
             precision="highest"):
    """Forward DFT of ``re + j im`` along ``axis``; returns ``(re, im)``.

    ``im=None`` marks an exactly-real input (first-stage matmuls halve).
    """
    re, n = _prep(re, n, axis)
    if im is not None:
        im, _ = _prep(im, n, axis)
    dtype = np.dtype(re.dtype)
    ro, io = _fft_last(re, im, n, leaf, precision, dtype)
    return jnp.moveaxis(ro, -1, axis), jnp.moveaxis(io, -1, axis)


def ifft_pair(re, im, n=None, axis=-1, leaf=_DEF_LEAF, precision="highest"):
    """Inverse DFT (1/N-normalized): ``ifft(z) = conj(fft(conj(z))) / N``."""
    re, nn = _prep(re, n, axis)
    im, _ = _prep(im, nn, axis)
    ro, io = _fft_last(re, -im, nn, leaf, precision, np.dtype(re.dtype))
    scale = 1.0 / nn
    return (jnp.moveaxis(ro, -1, axis) * scale,
            jnp.moveaxis(-io, -1, axis) * scale)


@lru_cache(maxsize=None)
def _rfft_combine_tables(n: int, dtype=np.float32):
    """Index/twiddle tables for the even/odd real-input packing of an
    ``n``-point rfft via one ``n/2``-point complex transform."""
    M = n // 2
    k = np.arange(M + 1)
    idx = (k % M).astype(np.int32)
    ridx = ((M - k) % M).astype(np.int32)
    ang = 2.0 * np.pi * k / n
    return idx, ridx, np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def rfft_pair(x, n=None, axis=-1, leaf=_DEF_LEAF, precision="highest"):
    """Real-input DFT; returns the ``n//2 + 1`` non-negative-frequency bins.

    Even ``n`` uses the true half-spectrum factorization — pack
    ``z[m] = x[2m] + j x[2m+1]``, one ``n/2``-point complex transform,
    then the hermitian split-and-twiddle recombination — which halves the
    MXU work of the dominant real-input pipelines versus transforming the
    full length and slicing (the reference's rfft role,
    ``fft_analysis.py:548``).  Odd/short ``n`` falls back to the sliced
    full transform.
    """
    x, n = _prep(x, n, axis)                  # moves the axis last
    if n % 2 or n <= 2 * leaf or n > _RFFT_PACK_MAX:
        dtype = np.dtype(x.dtype)
        re, im = _fft_last(x, None, n, leaf, precision, dtype)
        keep = n // 2 + 1
        return (jnp.moveaxis(re[..., :keep], -1, axis),
                jnp.moveaxis(im[..., :keep], -1, axis))

    M = n // 2
    dtype = np.dtype(x.dtype)
    Zr, Zi = _fft_last(x[..., 0::2], x[..., 1::2], M, leaf, precision, dtype)
    idx, ridx, c, s = _rfft_combine_tables(n, dtype)
    idx = jnp.asarray(idx)
    ridx = jnp.asarray(ridx)
    c = jnp.asarray(c)
    s = jnp.asarray(s)
    Zrk, Zik = Zr[..., idx], Zi[..., idx]
    Zcr, Zci = Zr[..., ridx], -Zi[..., ridx]
    Er, Ei = 0.5 * (Zrk + Zcr), 0.5 * (Zik + Zci)
    Or, Oi = 0.5 * (Zrk - Zcr), 0.5 * (Zik - Zci)
    # X[k] = E[k] - j W_n^k O[k]
    Xr = Er + (c * Oi - s * Or)
    Xi = Ei - (c * Or + s * Oi)
    return jnp.moveaxis(Xr, -1, axis), jnp.moveaxis(Xi, -1, axis)


def irfft_pair(re, im, n, axis=-1, leaf=_DEF_LEAF, precision="highest"):
    """Inverse of :func:`rfft_pair`: hermitian-extend then inverse DFT.

    Accepts ``n//2 + 1`` bins (or fewer — zero-padded, matching
    ``numpy.fft.irfft`` semantics used at reference ``fft_analysis.py:548``)
    and returns the length-``n`` real signal.
    """
    re = jnp.moveaxis(jnp.asarray(re), axis, -1)
    im = jnp.moveaxis(jnp.asarray(im), axis, -1)
    need = n // 2 + 1
    have = re.shape[-1]
    if have < need:
        pad = [(0, 0)] * (re.ndim - 1) + [(0, need - have)]
        re = jnp.pad(re, pad)
        im = jnp.pad(im, pad)
    else:
        re = re[..., :need]
        im = im[..., :need]
    # enforce hermitian symmetry of the implied full spectrum
    im = im.at[..., 0].set(0.0)
    if n % 2 == 0:
        im = im.at[..., -1].set(0.0)
    if n % 2 == 0 and n > 2 * leaf and n <= _RFFT_PACK_MAX:
        # inverse of the rfft packing: rebuild the n/2-point complex
        # spectrum Z[k] = E[k] + j W_n^{-k} O[k], invert once, de-interleave
        M = n // 2
        _, _, c, s = _rfft_combine_tables(n, np.dtype(re.dtype))
        c = jnp.asarray(c[:M])
        s = jnp.asarray(s[:M])
        rr = re[..., M:0:-1]                   # re[M-k], k = 0..M-1
        ri = im[..., M:0:-1]
        Ar = 0.5 * (re[..., :M] + rr)
        Ai = 0.5 * (im[..., :M] - ri)
        Br = 0.5 * (re[..., :M] - rr)
        Bi = 0.5 * (im[..., :M] + ri)
        Zr = Ar - (c * Bi + s * Br)
        Zi = Ai + (c * Br - s * Bi)
        zr, zi = ifft_pair(Zr, Zi, n=M, axis=-1, leaf=leaf,
                           precision=precision)
        out = jnp.stack([zr, zi], axis=-1).reshape(zr.shape[:-1] + (n,))
        return jnp.moveaxis(out, -1, axis)
    body_r = re[..., 1:need - 1] if n % 2 == 0 else re[..., 1:need]
    body_i = im[..., 1:need - 1] if n % 2 == 0 else im[..., 1:need]
    full_r = jnp.concatenate([re, body_r[..., ::-1]], axis=-1)
    full_i = jnp.concatenate([im, -body_i[..., ::-1]], axis=-1)
    out_r, _ = ifft_pair(full_r, full_i, n=n, axis=-1, leaf=leaf,
                         precision=precision)
    return jnp.moveaxis(out_r, -1, axis)


def fftfreq(n, d=1.0):
    """``numpy.fft.fftfreq`` (host-side convenience)."""
    return np.fft.fftfreq(n, d)
