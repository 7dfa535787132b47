"""Unit tests for bench.py's pieces that need no device: the serial
reference chain (the ``vs_baseline`` denominator and chip_smoke's float64
reference for the headline chain), its rate, and the refusal to run
without a GPU."""
import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(HERE, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_numpy_reference_chain_matches_direct_welch():
    """The serial baseline denominator must compute the textbook chain."""
    bench = _load_bench()
    sys.path.insert(0, HERE)
    from pyfft_tpu import segmentation as seg

    rng = np.random.default_rng(0)
    nt, nch = 4096, 2
    x = rng.standard_normal(nt)
    y = rng.standard_normal((nch, nt))
    taps = rng.standard_normal(9)
    plan = seg.plan_segments(nt, nwins=512, windowoverlap=0.5)
    win = np.hanning(513)[:-1]
    Pxx, Pyy, Pxy = bench._numpy_reference_chain(x, y, taps, win, plan)
    assert Pxx.shape == (plan.nfft,)
    assert Pyy.shape == (nch, plan.nfft)
    # cross-check one channel against a direct segment loop
    yf = np.convolve(y[0], taps, mode="full")[:nt]
    yf = yf - yf.mean()
    hop = plan.nwins - plan.noverlap
    acc = np.zeros(plan.nfft)
    for g in range(plan.navr):
        s = np.fft.fft(win * yf[g * hop:g * hop + plan.nwins], plan.nfft)
        acc += np.abs(s) ** 2
    np.testing.assert_allclose(Pyy[0], acc / plan.navr, rtol=1e-10)


def test_serial_baseline_rate_small():
    bench = _load_bench()
    sys.path.insert(0, HERE)
    rate = bench.serial_baseline_rate(nch=2, nt=4096, nwins=512, reps=1)
    assert np.isfinite(rate) and rate > 0


def test_bench_exits_nonzero_without_gpu():
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "bench.py"], cwd=HERE,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "metric" not in r.stdout and "needs a GPU" in r.stderr
