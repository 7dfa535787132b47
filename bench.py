"""Benchmark: the five BASELINE configs and the headline Welch+FIR chain,
timed on one GPU through the public entry points.

Each config is the matching ``chip_smoke`` phase (same entry point, same
sizes, same float64 reference check), run with ``REPS`` warm calls after
one compiling call; rows report their median.  Times are host-clock wall
times around ``jax.block_until_ready``; every row names the platform,
device kind and count as JAX reports them, and the card's name and power
limit as nvidia-smi reports them.  Without a GPU the script fails.

Prints one JSON row per config, then, last, the headline row::

    {"metric": "welch_psd_fir_chain_throughput", "value": N,
     "unit": "samples/s/chip", "vs_baseline": R, ...}

``vs_baseline`` divides by the reference's serial NumPy chain
(:func:`_numpy_reference_chain`) timed on a 2^18-sample slice on this
host and scaled linearly: an indicative ratio, not a device metric.

Usage: ``python bench.py``.
"""
import json
import sys
import time

import numpy as np

#: BASELINE config number -> chip_smoke phase (0 is the headline chain)
CONFIGS = {1: "welch_psd", 2: "stft", 3: "fir", 4: "envelope_phase",
           5: "xcoh_cog", 0: "welch_fir_chain"}
#: warm calls per config
REPS = 3


def _numpy_reference_chain(x, y, taps, win, plan):
    """The reference's serial algorithm: per-channel FIR convolution plus a
    Python loop over Welch segments with numpy.fft (the hot loop at
    reference fft_analysis.py:362-388)."""
    nch, nt = y.shape
    yf = np.empty_like(y)
    for c in range(nch):
        yf[c] = np.convolve(y[c], taps, mode="full")[:nt]
    xf = np.convolve(x, taps, mode="full")[:nt]

    hop = plan.nwins - plan.noverlap
    xf = xf - xf.mean()
    yf = yf - yf.mean(axis=-1, keepdims=True)
    Pxx = np.zeros(plan.nfft)
    Pyy = np.zeros((nch, plan.nfft))
    Pxy = np.zeros((nch, plan.nfft), dtype=complex)
    for g in range(plan.navr):
        s0 = g * hop
        xs = np.fft.fft(win * xf[s0:s0 + plan.nwins], n=plan.nfft)
        for c in range(nch):
            ys = np.fft.fft(win * yf[c, s0:s0 + plan.nwins], n=plan.nfft)
            Pyy[c] += np.abs(ys) ** 2
            Pxy[c] += ys * np.conj(xs)
        Pxx += np.abs(xs) ** 2
    return Pxx / plan.navr, Pyy / plan.navr, Pxy / plan.navr


def serial_baseline_rate(nch=8, nt=1 << 18, nwins=2048, reps=3):
    """Samples/s of :func:`_numpy_reference_chain` on this host (best of
    ``reps``), on an ``nch`` x ``nt`` slice of the headline chain."""
    from pyfft_tpu import filters, segmentation as seg
    rng = np.random.default_rng(0)
    x = rng.standard_normal(nt)
    y = rng.standard_normal((nch, nt))
    taps = filters.firwin(129, [0.05, 0.45], pass_zero=False)
    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1]
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _numpy_reference_chain(x, y, taps, win, plan)
        best = min(best, time.perf_counter() - t0)
    return nch * nt / best


def main():
    import chip_smoke
    card = chip_smoke.card_info()
    dev = chip_smoke.device_record()
    if dev["platform"] != "gpu" or card is None:
        print(f"bench: needs a GPU with nvidia-smi; JAX found "
              f"{dev['platform']!r}, nvidia-smi gave {card!r}",
              file=sys.stderr)
        return 2
    chip_smoke.use_compile_cache()
    name, power_limit = (s.strip() for s in card.split(",", 1))
    where = {"platform": dev["platform"], "device_kind": dev["kind"],
             "count": dev["count"], "card": name,
             "power_limit": power_limit}

    rows = {}
    for config, phase in CONFIGS.items():
        r = chip_smoke.PHASES[phase](reps=REPS)
        if not r.ok:
            print(f"bench: {r.line()}", file=sys.stderr)
            return 1
        rows[config] = {"config": config, "what": phase,
                        "samples": r.samples, "wall_s": r.wall_s,
                        "wall_min_s": min(r.walls),
                        "compile_call_s": r.cold_s,
                        "samples_per_s": r.samples / r.wall_s, **where}
        print(json.dumps(rows[config]), flush=True)

    head = rows[0]
    base = serial_baseline_rate()
    print(json.dumps({
        "metric": "welch_psd_fir_chain_throughput",
        "value": head["samples_per_s"],
        "unit": "samples/s/chip",
        "vs_baseline": head["samples_per_s"] / base,
        "baseline_samples_per_s": base,
        "baseline_what": "serial NumPy FIR+Welch chain on this host, "
                         "2^18-sample slice, scaled",
        **where}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
