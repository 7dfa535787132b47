"""Tracing / profiling / roofline accounting (SURVEY §5.1).

The reference's only observability is ``verbose`` prints
(fft_analysis.py:263-265) and an ASCII progress bar (spectrogram.py:82-97).
This module provides the device-side replacements the survey specifies:

- :func:`stage`: ``jax.named_scope`` + wall-clock context manager, so
  pipeline stages show up named in XLA traces and in host logs;
- :func:`trace`: one-call ``jax.profiler`` capture around a callable,
  writing a TensorBoard-loadable trace directory;
- FLOP/byte accounting for the framework's hot kernels
  (:func:`fft_flops`, :func:`welch_flops`, :func:`fir_flops`),
  :func:`device_peaks` (published peaks keyed by ``device_kind``) and
  :func:`roofline` — achieved fraction of a device's peak given measured
  wall time;
- :func:`measure`: host-clock wall time of a device callable, warm-up
  calls separated, synchronized with ``jax.block_until_ready``.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import NamedTuple

import numpy as np
import jax

__all__ = ["stage", "trace", "fft_flops", "welch_flops", "fir_flops",
           "roofline", "measure", "device_peaks", "Peaks"]


_LOG = []


@contextlib.contextmanager
def stage(name, log=True):
    """Named pipeline stage: shows up in XLA/profiler traces and records
    host wall-clock into the module log (``profiling._LOG``)."""
    t0 = time.perf_counter()
    with jax.named_scope(name):
        yield
    dt = time.perf_counter() - t0
    if log:
        _LOG.append({"stage": name, "wall_s": dt})


def stage_log():
    """The accumulated [(stage, wall_s)] records (host-side, append-only)."""
    return list(_LOG)


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``jax.profiler`` trace of the enclosed block."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# --------------------------------------------------------------------------- #
# FLOP models (complex FFT: 5 N log2 N, the standard radix-2 count)
# --------------------------------------------------------------------------- #

def fft_flops(n, batch=1, real=False):
    """FLOPs of one (batched) length-``n`` FFT; real transforms halve."""
    f = 5.0 * n * np.log2(max(n, 2))
    return batch * (f / 2.0 if real else f)


def welch_flops(navr, nwins, nch=1):
    """Welch chain: window multiply + rFFT + power + accumulate per segment
    for the reference channel and ``nch`` signal channels."""
    per_seg = (nwins                      # window multiply
               + fft_flops(nwins, real=True)
               + 4 * (nwins // 2 + 1))    # |X|^2 + cross-power terms
    return navr * per_seg * (1 + nch)


def fir_flops(nt, ntaps, nch=1, method="overlap-save"):
    """FIR filtering cost: direct is 2*nt*ntaps; overlap-save is the
    two-FFT-per-block form."""
    if method == "direct":
        return 2.0 * nt * ntaps * nch
    nfft = 2 ** int(np.ceil(np.log2(4 * ntaps)))
    hop = nfft - ntaps + 1
    nblocks = int(np.ceil(nt / hop))
    per_block = 2 * fft_flops(nfft) + 6 * nfft
    return nblocks * per_block * nch


class Peaks(NamedTuple):
    """Published per-device peaks: dense TFLOP/s and HBM GB/s."""
    bf16_tflops: float
    tf32_tflops: float
    f32_tflops: float
    hbm_gbs: float


#: keyed by ``jax.devices()[0].device_kind``.  NVIDIA H100 SXM data sheet,
#: dense rates without sparsity: 989 TFLOP/s bf16, 495 TFLOP/s TF32,
#: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3 — at the
#: full 700 W power limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(989.0, 495.0, 67.0, 3350.0),
}


def device_peaks(kind=None) -> Peaks:
    """Published peaks of ``kind`` (default: the first JAX device's
    ``device_kind``).  A kind not in the table raises ``KeyError``: a
    roofline against another machine's peaks is wrong, not approximate."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return _PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(_PEAKS)}") from None


def roofline(flops, bytes_moved, wall_s, kind=None, unit="f32"):
    """Achieved fraction of the device's compute/memory roofline.

    ``unit`` names the compute peak: ``'bf16'``, ``'tf32'`` or ``'f32'``.
    Returns a dict with achieved TFLOP/s, GB/s, the bound ('compute' or
    'memory') and ``fraction`` of the relevant peak.
    """
    pk = device_peaks(kind)
    peak = getattr(pk, f"{unit}_tflops")
    bw = pk.hbm_gbs
    tflops = flops / wall_s / 1e12
    gbs = bytes_moved / wall_s / 1e9
    # which wall is closer at this arithmetic intensity?
    ai = flops / max(bytes_moved, 1)
    knee = peak * 1e12 / (bw * 1e9)
    bound = "compute" if ai >= knee else "memory"
    frac = (tflops / peak) if bound == "compute" else (gbs / bw)
    return {"achieved_tflops": tflops, "achieved_gbs": gbs,
            "bound": bound, "fraction": frac,
            "peak_tflops": peak, "peak_gbs": bw}


def measure(fn, *args, iters=10, warmup=2):
    """Mean host-clock wall time of ``fn(*args)`` after ``warmup`` calls,
    each call waited for with ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def report(entries, path=None):
    """Write one-JSON-line perf records (samples/s, roofline fractions)."""
    lines = [json.dumps(e) for e in entries]
    if path is not None:
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
    return lines
