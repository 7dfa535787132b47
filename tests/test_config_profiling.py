"""SpectralConfig defaulting rules + profiling accounting helpers."""
import numpy as np
import pytest

import pyfft_tpu as ft
from pyfft_tpu.config import SpectralConfig, welch_psd
from pyfft_tpu.utils import profiling as prof


def test_defaulting_rules():
    cfg = SpectralConfig()
    r = cfg.resolve(nsig=2 ** 14, Fs=1e4)
    # hanning ROV = 0.5, Navr default 8
    assert r.overlap == 0.5
    assert r.plan.navr == 8
    assert r.onesided is True

    # minFreq -> tper = 2/minFreq -> nwins = int(Fs * tper)
    r2 = SpectralConfig(minFreq=10.0).resolve(nsig=2 ** 16, Fs=1e4)
    assert r2.plan.nwins == int(1e4 * 2.0 / 10.0)

    # complex input -> two-sided
    r3 = cfg.resolve(nsig=4096, Fs=1.0, iscomplex=True)
    assert r3.onesided is False
    assert r3.freq[0] < 0

    # detrend code/name equivalence
    assert SpectralConfig(detrend="linear").detrend_style == -1
    assert SpectralConfig(detrend=-1).detrend_style == -1
    with pytest.raises(ValueError):
        SpectralConfig(detrend="bogus")


def test_welch_psd_matches_fft_pwelch():
    rng = np.random.default_rng(0)
    fs, n = 1e4, 2 ** 13
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 500 * t) + 0.1 * rng.standard_normal(n)
    y = 0.5 * np.sin(2 * np.pi * 500 * t - 0.8) + 0.1 * rng.standard_normal(n)

    a = welch_psd(t, x, y, SpectralConfig(Navr=8),
                  tbounds=[t[1], t[-2]])
    b = ft.fft_pwelch(t, x, y, tbounds=[t[1], t[-2]], Navr=8,
                      plotit=False, verbose=False)
    np.testing.assert_allclose(np.asarray(a[2]), np.asarray(b[2]))
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]))

    # auto-spectrum shorthand
    c = welch_psd(t, x, cfg=None, tbounds=[t[1], t[-2]], Navr=8)
    np.testing.assert_allclose(np.abs(np.asarray(c[2])),
                               np.abs(np.asarray(b[2])), rtol=1e-10)


def test_flop_models_and_roofline():
    assert prof.fft_flops(1024) == pytest.approx(5 * 1024 * 10)
    assert prof.fft_flops(1024, real=True) == pytest.approx(2.5 * 1024 * 10)
    assert prof.welch_flops(10, 1024, nch=3) > 0
    assert prof.fir_flops(1 << 20, 129) < prof.fir_flops(1 << 20, 129,
                                                         method="direct")
    # H100 SXM, float32 outside the tensor cores: knee = 67e12 / 3.35e12
    # = 20 flops/byte, so AI=10 -> memory, AI=100 -> compute
    h100 = "NVIDIA H100 80GB HBM3"
    assert prof.device_peaks(h100) == (989.0, 495.0, 67.0, 3350.0)
    r = prof.roofline(flops=1e12, bytes_moved=1e11, wall_s=1.0, kind=h100)
    assert r["bound"] == "memory" and 0 < r["fraction"] < 1
    assert r["peak_gbs"] == 3350.0
    r2 = prof.roofline(flops=1e12, bytes_moved=1e10, wall_s=1.0, kind=h100)
    assert r2["bound"] == "compute" and r2["peak_tflops"] == 67.0
    # bf16 tensor-core knee = 989e12 / 3.35e12 ~ 295 flops/byte
    r3 = prof.roofline(flops=1e12, bytes_moved=1e10, wall_s=1.0, kind=h100,
                       unit="bf16")
    assert r3["bound"] == "memory"


def test_stage_and_measure():
    import jax.numpy as jnp
    import jax

    with prof.stage("unit-test-stage"):
        jnp.ones(8).sum()
    assert any(e["stage"] == "unit-test-stage" for e in prof.stage_log())

    f = jax.jit(lambda x: (x * 2).sum())
    dt = prof.measure(f, jnp.ones(1024), iters=3, warmup=1)
    assert dt > 0
