"""Real-pair matmul-DFT backend (``fft_backend='mxu'``) vs numpy.fft (CPU,
float64 for exactness)."""
import numpy as np
import pytest

from pyfft_tpu.ops import mxu_fft as mf


SIZES = [1, 2, 8, 27, 100, 121, 127, 128, 256, 910, 1024, 2184, 3640, 4096]


@pytest.mark.parametrize("n", SIZES)
def test_fft_real_input(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n))
    re, im = mf.fft_pair(x)
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(re), ref.real, rtol=1e-9,
                               atol=1e-9 * n)
    np.testing.assert_allclose(np.asarray(im), ref.imag, rtol=1e-9,
                               atol=1e-9 * n)


@pytest.mark.parametrize("n", [128, 910, 1024])
def test_fft_complex_input(n):
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((2, n))
    xi = rng.standard_normal((2, n))
    re, im = mf.fft_pair(xr, xi)
    ref = np.fft.fft(xr + 1j * xi, axis=-1)
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-8 * n)
    np.testing.assert_allclose(np.asarray(im), ref.imag, atol=1e-8 * n)


@pytest.mark.parametrize("n", [64, 911, 1024])
def test_ifft_roundtrip(n):
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((n,))
    xi = rng.standard_normal((n,))
    fr, fi = mf.fft_pair(xr, xi)
    br, bi = mf.ifft_pair(fr, fi)
    np.testing.assert_allclose(np.asarray(br), xr, atol=1e-10 * n)
    np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-10 * n)


@pytest.mark.parametrize("n", [64, 65, 910, 1023])
def test_rfft_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n))
    re, im = mf.rfft_pair(x)
    ref = np.fft.rfft(x, axis=-1)
    assert re.shape[-1] == n // 2 + 1
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-9 * n)
    np.testing.assert_allclose(np.asarray(im), ref.imag, atol=1e-9 * n)


@pytest.mark.parametrize("n", [64, 65, 910, 1023])
def test_irfft_matches_numpy(n):
    rng = np.random.default_rng(n)
    spec = np.fft.rfft(rng.standard_normal((2, n)), axis=-1)
    ours = mf.irfft_pair(spec.real, spec.imag, n)
    ref = np.fft.irfft(spec, n=n, axis=-1)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=1e-10 * n)


def test_irfft_short_input_zero_pads():
    # numpy semantics used by the reference lag-domain path
    # (fft_analysis.py:548): fewer than n//2+1 bins -> zero-pad
    rng = np.random.default_rng(5)
    spec = np.fft.rfft(rng.standard_normal(64))
    short = spec[:20]
    ours = mf.irfft_pair(short.real, short.imag, 64)
    ref = np.fft.irfft(short, n=64)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=1e-12)


def test_axis_argument():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((16, 5))
    re, im = mf.fft_pair(x, axis=0)
    ref = np.fft.fft(x, axis=0)
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-10)
    np.testing.assert_allclose(np.asarray(im), ref.imag, atol=1e-10)


def test_n_padding_and_truncation():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(100)
    re, im = mf.fft_pair(x, n=128)
    ref = np.fft.fft(x, n=128)
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-10)
    re, im = mf.fft_pair(x, n=64)
    ref = np.fft.fft(x, n=64)
    np.testing.assert_allclose(np.asarray(re), ref.real, atol=1e-10)


def test_rfft_half_spectrum_path_matches_numpy():
    """Even lengths above 2*leaf take the true half-spectrum factorization
    (pack-even/odd + n/2 complex FFT + twiddle recombination)."""
    rng = np.random.default_rng(7)
    for n in (512, 2048, 6000):          # > 2*leaf: packed path
        x = rng.standard_normal((2, n))
        Xr, Xi = mf.rfft_pair(x)
        R = np.fft.rfft(x, axis=-1)
        np.testing.assert_allclose(np.asarray(Xr), R.real, rtol=1e-9,
                                   atol=1e-9 * np.abs(R).max())
        np.testing.assert_allclose(np.asarray(Xi), R.imag, rtol=1e-9,
                                   atol=1e-9 * np.abs(R).max())
        xb = mf.irfft_pair(Xr, Xi, n)
        np.testing.assert_allclose(np.asarray(xb), x, atol=1e-10)
