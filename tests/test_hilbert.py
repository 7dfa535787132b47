"""Hilbert transform: analytic ground truth (the reference's strongest
oracle), scipy cross-check, and golden parity with the reference module."""
import numpy as np
import pytest
from scipy.fftpack import hilbert as scipy_hilbert

from pyfft_tpu.hilbert import hilbert, hilbert_1d, analytic_mask


def test_hilbert_of_sine_analytic():
    # reference test_hilbert (hilbert.py:115-179): H[sin] = -cos
    N, f = 32, 1
    dt = 1.0 / N
    t = 2 * np.pi * f * dt * np.arange(N)
    y = np.sin(t)
    z = hilbert(y)
    expected = y + 1j * (-np.cos(t))
    np.testing.assert_allclose(z, expected, atol=1e-10)


def test_hilbert_matches_scipy_fftpack():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(64)
    y -= y.mean()
    z = hilbert(y)
    # scipy.fftpack.hilbert returns the opposite sign convention (-H)
    np.testing.assert_allclose(np.imag(z)[1:], -scipy_hilbert(y)[1:],
                               atol=1e-9)


@pytest.mark.parametrize("n", [32, 33, 100, 255])
def test_hilbert_golden_parity(n):
    # the reference hilbert module is standalone numpy; execute it directly
    ns = {}
    with open("/root/reference/hilbert.py") as f:
        src = f.read()
    exec(compile(src.split("def test_hilbert")[0], "ref_hilbert", "exec"), ns)
    rng = np.random.default_rng(n)
    y = rng.standard_normal(n)
    ours = np.asarray(hilbert(y))
    ref = np.asarray(ns["hilbert"](y.copy()))
    np.testing.assert_allclose(ours, ref, atol=1e-10)
    ours1d = np.asarray(hilbert_1d(y))
    ref1d = np.asarray(ns["hilbert_1d"](y.copy()))
    np.testing.assert_allclose(ours1d, ref1d, atol=1e-10)


def test_hilbert_batched():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((3, 64))
    z = hilbert(y, axes=-1)
    for c in range(3):
        np.testing.assert_allclose(z[c], hilbert(y[c]), atol=1e-12)


def test_analytic_mask_conventions():
    # even: [1, 2...2, 1(at nyq), 0...]; odd keeps bin nyq at unit gain
    m8 = analytic_mask(8)
    np.testing.assert_array_equal(m8, [1, 2, 2, 2, 1, 0, 0, 0])
    # odd: nyq = (n+1)//2, bins 1..nyq-1 doubled, bin nyq unit (reference)
    m9 = analytic_mask(9)
    np.testing.assert_array_equal(m9, [1, 2, 2, 2, 2, 1, 0, 0, 0])


def test_envelope_demodulation():
    # config #4: AM tone -> envelope via |analytic signal|
    fs = 1e3
    t = np.arange(4096) / fs
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 5 * t)
    x = env * np.sin(2 * np.pi * 100 * t)
    z = hilbert(x)
    rec = np.abs(z)
    core = slice(200, -200)
    np.testing.assert_allclose(rec[core], env[core], rtol=0.02, atol=0.02)
    # instantaneous frequency ~ carrier
    phase = np.unwrap(np.angle(z))
    finst = np.diff(phase) * fs / (2 * np.pi)
    assert abs(np.median(finst) - 100) < 1.0


def test_analytic_factored_matches_scipy():
    """The depth-3 contraction-chain analytic signal (envelope_phase's path
    on a backend without complex support) against scipy.signal.hilbert,
    several factorizations."""
    import jax.numpy as jnp
    from scipy.signal import hilbert as sp_hilbert
    from pyfft_tpu.hilbert import _analytic_factored
    from pyfft_tpu.ops.mxu_fft import balanced3_factorization
    rng = np.random.default_rng(2)
    for nfft in [1 << 12, 9 * (1 << 10), 1 << 13]:
        fac = balanced3_factorization(nfft)
        assert fac is not None and np.prod(fac) == nfft
        x = rng.standard_normal(nfft).astype(np.float32)
        zr, zi = _analytic_factored(jnp.asarray(x), nfft=nfft, factors=fac,
                                    prec="highest")
        z = sp_hilbert(np.float64(x))
        scl = np.max(np.abs(z))
        np.testing.assert_allclose(np.asarray(zr), z.real, atol=2e-6 * scl)
        np.testing.assert_allclose(np.asarray(zi), z.imag, atol=2e-6 * scl)


def test_analytic_factored_bf16x3_precision_tier():
    """The 'bf16x3' precision tier (lax.Precision.HIGH) must hold a stated
    accuracy contract too — on CPU the tier lowers to f32 matmuls, which
    still pins the contraction-chain structure."""
    import jax.numpy as jnp
    from scipy.signal import hilbert as sp_hilbert
    from pyfft_tpu.hilbert import _analytic_factored
    from pyfft_tpu.ops.mxu_fft import balanced3_factorization
    rng = np.random.default_rng(5)
    nfft = 1 << 12
    fac = balanced3_factorization(nfft)
    x = rng.standard_normal(nfft).astype(np.float32)
    zr, zi = _analytic_factored(jnp.asarray(x), nfft=nfft, factors=fac,
                                prec="bf16x3")
    z = sp_hilbert(np.float64(x))
    scl = np.max(np.abs(z))
    # bf16x3 compensated products: ~f32-grade, give it 30x the f32 budget
    np.testing.assert_allclose(np.asarray(zr), z.real, atol=6e-5 * scl)
    np.testing.assert_allclose(np.asarray(zi), z.imag, atol=6e-5 * scl)


def test_balanced3_factorization_properties():
    from pyfft_tpu.ops.mxu_fft import balanced3_factorization
    for N in [1 << 23, 1 << 12, 1000, 9 * (1 << 10), 2 * 3 * 5 * 7 * 11]:
        fac = balanced3_factorization(N)
        if fac is not None:
            n1, n2, n3 = fac
            assert n1 * n2 * n3 == N and n1 <= n2 <= n3 <= 512
    assert balanced3_factorization(17 * 19) is None  # no 3-way split


def test_balanced3_factorization_minimal_vs_bruteforce():
    """The factorizer must find the MINIMAL-cost valid triple whenever one
    exists (the sqrt-closest-pair shortcut used to miss splits whose
    balanced pair broke the maxf or ordering constraint)."""
    from pyfft_tpu.ops.mxu_fft import balanced3_factorization

    def brute(N, maxf=512):
        best = None
        for a in range(2, maxf + 1):
            if N % a:
                continue
            for b in range(a, maxf + 1):
                if (N // a) % b:
                    continue
                c = N // a // b
                if b <= c <= maxf:
                    s = a + b + c
                    if best is None or s < best[0]:
                        best = (s, (a, b, c))
        return best[1] if best else None

    rng = np.random.default_rng(11)
    for N in list(range(8, 600)) + [int(rng.integers(1 << 10, 1 << 21))
                                    for _ in range(60)]:
        g = balanced3_factorization(N)
        b = brute(N)
        assert (g is None) == (b is None), N
        if g is not None:
            assert sum(g) == sum(b), (N, g, b)
            assert np.prod(g) == N
