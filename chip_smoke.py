"""Smoke test of pyfft_tpu's public spectral paths on one NVIDIA GPU.

Usage::

    python chip_smoke.py          # every single-card phase, one GPU
    python chip_smoke.py --four   # the mesh paths on four GPUs, nothing else

Each phase calls a public entry point in float32 (x64 off) at the
benchmark's sizes, compares the result with an independent float64
NumPy/SciPy reference, and prints one line: the phase, each error beside
its tolerance, the warm wall time (host clock around
``jax.block_until_ready``; the first, compiling call is reported apart) and
the device's ``peak_bytes_in_use`` so far.  Any failed check makes the
script exit non-zero without the result line.  The last line of a passing
run is one JSON object naming the device as JAX reports it.

The script drives the card(s) from this one process and starts no other
JAX process.  With no GPU it exits non-zero before any phase runs.

Tolerances cover float32 cuFFT round-off plus summation order against
float64 references.  Each limit over the largest error measured on an H100
(700 W), at 2^20 and 2^24 samples: spectra, filtered samples and envelopes
1e-5 of the reference's maximum (largest error 8.6e-7, 12x); wrapped phase
1e-4 rad (1.8e-6, 56x); coherence 1e-4 absolute (3.5e-6, 29x);
centre-of-gravity frequency 1e-8 of the half bandwidth (1.9e-9, 5x).
The script refuses to run with float64 on (``JAX_ENABLE_X64``): the
phases would then check another path than the one users run.

The headline Welch+FIR chain runs at 8 x 2^24 samples rather than the
8 x 2^25 of earlier benchmark rounds: the GPU path of ``fft_pwelch`` /
``welch_cross_spectra`` still copies every per-segment array to the host
(``spectral._run_welch_core``), and that copy, not the transform, would
dominate a larger chain.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: samples per channel of the single-card phases (the benchmark's size)
N_FULL = 1 << 24
#: channels of the multi-channel phases
NCH = 8
#: sample rate: a power of two, so ``t = arange(n) / FS`` and the rate that
#: ``fft_pwelch`` recovers from ``t`` are exact and ``tper`` maps to an
#: exact segment length
FS = float(1 << 20)


# --------------------------------------------------------------------------- #
# Environment: compile cache, card, device
# --------------------------------------------------------------------------- #

def compile_cache_dir(environ=None, root=HERE):
    """The persistent compile-cache directory this checkout uses:
    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself),
    otherwise the fixed ``<root>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        root, ".jax_cache")


def use_compile_cache(root=HERE):
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.
    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          compile_cache_dir(root=root))
    return jax.config.jax_compilation_cache_dir


def card_info():
    """``name, power.limit`` of the first card as nvidia-smi reports them,
    or None when nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    return r.stdout.strip().splitlines()[0].strip()


def device_record():
    """``{platform, kind, count}`` of the default JAX devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes():
    """``peak_bytes_in_use`` of the first device (None where the backend
    keeps no statistics, as on the CPU)."""
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# --------------------------------------------------------------------------- #
# Phase bookkeeping
# --------------------------------------------------------------------------- #

@dataclass
class PhaseResult:
    """Outcome of one phase: named checks ``(label, err, tol)``, the first
    (compiling) call's wall time, the warm wall times, and the samples one
    call processes."""
    name: str
    checks: list = field(default_factory=list)
    cold_s: float = 0.0
    walls: list = field(default_factory=list)
    samples: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def ok(self):
        return all(np.isfinite(e) and e <= t for _, e, t in self.checks)

    @property
    def wall_s(self):
        return float(np.median(self.walls))

    def line(self):
        parts = [f"phase={self.name}", "ok" if self.ok else "FAIL"]
        parts += [f"err[{lab}]={e:.3e}/tol={t:.1e}"
                  for lab, e, t in self.checks]
        parts.append(f"warm_s={self.wall_s:.6f}")
        parts.append(f"cold_s={self.cold_s:.3f}")
        parts += [f"{k}={v}" for k, v in self.extra.items()]
        parts.append(f"peak_bytes_in_use={peak_bytes()}")
        return " ".join(parts)


def _timed(call, reps):
    """``(result, cold_s, [warm_s...])``: one compiling call, then
    ``reps`` warm calls, each waited for with ``block_until_ready``."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(call())
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(call())
        walls.append(time.perf_counter() - t0)
    return out, cold, walls


def _rel_err(got, ref, mask=None):
    """``max|got - ref| / max|ref|`` (over ``mask`` when given)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    d = np.abs(got - ref)
    if mask is not None:
        d = d[mask]
    return float(np.max(d) / np.max(np.abs(ref)))


def _wrapped_phase_err(ph, ph_ref, mask):
    d = np.angle(np.exp(1j * (np.asarray(ph, np.float64) - ph_ref)))
    return float(np.max(np.abs(d[mask])))


def _tone(n, seed, f0=97e3):
    """Sine at ``f0`` plus white noise, float32 (the benchmark's signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return t, (np.sin(2 * np.pi * f0 * t)
               + 0.3 * rng.standard_normal(n)).astype(np.float32)


def _analyzed_span(x, nwins):
    """What ``fft_pwelch`` analyzes of a full-span input, along the last
    axis: the reflect-extended signal (reference ``fft_analysis.py:196-205``)
    cut to the original length (the span indices are taken before the
    extension, reference ``:282-283``), mean-detrended."""
    n = x.shape[-1]
    xe = np.concatenate((x[..., nwins - 1:0:-1], x, x[..., -1:-nwins:-1]),
                        axis=-1)[..., :n]
    return xe - xe.mean(axis=-1, keepdims=True)


def _frames_fft_sums(xs, ys, win, nwins, hop, navr, chunk=512):
    """float64 segment loop, in chunks of segments: sums over segments of
    ``|X|^2``, ``|Y_c|^2`` and ``Y_c conj(X)`` with ``X = fft(win * seg)``."""
    from numpy.lib.stride_tricks import sliding_window_view
    fx = sliding_window_view(xs, nwins)[::hop][:navr]
    fy = sliding_window_view(ys, nwins, axis=-1)[:, ::hop][:, :navr]
    Sxx = np.zeros(nwins)
    Syy = np.zeros((ys.shape[0], nwins))
    Sxy = np.zeros((ys.shape[0], nwins), complex)
    for g in range(0, navr, chunk):
        X = np.fft.fft(fx[g:g + chunk] * win, axis=-1)
        Sxx += np.sum(np.abs(X) ** 2, axis=0)
        for c in range(ys.shape[0]):
            Y = np.fft.fft(fy[c, g:g + chunk] * win, axis=-1)
            Syy[c] += np.sum(np.abs(Y) ** 2, axis=0)
            Sxy[c] += np.sum(Y * np.conj(X), axis=0)
    return Sxx, Syy, Sxy


# --------------------------------------------------------------------------- #
# Single-card phases
# --------------------------------------------------------------------------- #

def phase_welch_psd(n=N_FULL, reps=1, nwins=4096):
    """``fft_pwelch`` auto-PSD of one channel, Hann, 50 % overlap, full span
    (reflect-extended), against ``csd_oracle`` in float64."""
    import pyfft_tpu as ft
    from pyfft_tpu.spectral import csd_oracle
    t, x = _tone(n, seed=1)
    call = lambda: ft.fft_pwelch(t, x, None, tper=nwins / FS,  # noqa: E731
                                 windowoverlap=0.5, windowfunction="hanning",
                                 plotit=False)
    out, cold, walls = _timed(call, reps)
    Pxx, info = out[2], out[6]
    assert info.nwins == nwins, info.nwins
    xe = _analyzed_span(x.astype(np.float64), nwins)
    hop = nwins - info.noverlap
    xe = xe[:(info.Navr - 1) * hop + nwins]
    ref, _ = csd_oracle(xe, xe, nwins, FS, window=np.asarray(info.win),
                        noverlap=info.noverlap)
    nny = info.Nnyquist
    ref = ref[:nny].real.copy()
    # the reference's one-sided convention keeps the last retained bin of
    # an even nfft at unit gain (spectral._onesided_power_scale)
    ref[-1] /= 2.0
    return PhaseResult("welch_psd", [("Pxx", _rel_err(Pxx, ref), 1e-5)],
                       cold, walls, samples=n)


def phase_stft(n=N_FULL, reps=1, nwins=2048, nsub=64):
    """``specgram`` and ``stft_segments`` of a chirp, Hann, 50 % overlap,
    against a float64 NumPy FFT of a spread subset of segments."""
    import pyfft_tpu as ft
    from pyfft_tpu import segmentation as seg
    t = np.arange(n) / FS
    f_inst = 1e3 + (200e3 - 1e3) * np.arange(n) / n
    chirp = np.sin(2 * np.pi * np.cumsum(f_inst) / FS).astype(np.float32)
    plan = seg.plan_segments(n, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1]

    def call():
        return (ft.specgram(t, chirp, wl=nwins),
                ft.stft_segments(chirp, t, win, plan, FS))

    ((_, _, S), (_, _, X, _)), cold, walls = _timed(call, reps)
    c64 = chirp.astype(np.float64)
    hop = nwins // 2
    # specgram: two-sided |FFT(hanning * seg)|^2 / wl * sqrt(8/3)
    ks = np.unique(np.linspace(0, S.shape[1] - 1, nsub).astype(int))
    fr = np.stack([c64[k * hop:k * hop + nwins] for k in ks])
    Sref = (np.abs(np.fft.fft(fr * np.hanning(nwins), axis=-1)) ** 2
            / nwins * np.sqrt(8.0 / 3.0))
    # stft_segments: one-sided fft_win coefficients of the mean-detrended
    # signal, sqrt(2) on interior bins, / (S1 sqrt(ENBW))
    ks2 = np.unique(np.linspace(0, plan.navr - 1, nsub).astype(int))
    cd = c64 - c64.mean()
    fr2 = np.stack([cd[k * plan.hop:k * plan.hop + nwins] for k in ks2])
    s1 = win.sum()
    enbw = FS * (win ** 2).sum() / s1 ** 2
    amp = np.ones(plan.nnyquist)
    amp[1:-1] = np.sqrt(2.0)
    Xref = (np.fft.fft(fr2 * win, axis=-1)[:, :plan.nnyquist] * amp
            / (s1 * np.sqrt(enbw)))
    return PhaseResult(
        "stft", [("specgram", _rel_err(np.asarray(S)[:, ks], Sref.T), 1e-5),
                 ("stft_segments", _rel_err(np.asarray(X)[ks2], Xref),
                  1e-5)],
        cold, walls, samples=2 * n)


def _fir_chain_taps():
    """The benchmark's FIR chain: band-pass 129 taps convolved with a notch
    turned into a 129-tap FIR (257 taps)."""
    import pyfft_tpu as ft
    bp = ft.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    b_n, a_n = ft.iirnotch(0.2, 30.0)
    return np.convolve(bp, ft.filters.iir_to_fir(b_n, a_n, ntaps=129))


def _channels(n, nch, seed):
    """``nch`` noisy copies of the benchmark tone, float32 ``(nch, n)``."""
    rng = np.random.default_rng(seed)
    _, x = _tone(n, seed)
    return x, (np.tile(x, (nch, 1))
               + 0.1 * rng.standard_normal((nch, n))).astype(np.float32)


def phase_fir(n=N_FULL, reps=1, nch=NCH):
    """``fir_filter`` of ``nch`` channels with the band-pass + notch chain,
    against ``scipy.signal.fftconvolve`` in float64."""
    import pyfft_tpu as ft
    from scipy.signal import fftconvolve
    _, y = _channels(n, nch, seed=2)
    taps = _fir_chain_taps()
    out, cold, walls = _timed(lambda: ft.filters.fir_filter(y, taps), reps)
    ref = fftconvolve(y.astype(np.float64), taps[None, :], axes=-1)[:, :n]
    return PhaseResult("fir", [("y", _rel_err(out, ref), 1e-5)], cold,
                       walls, samples=nch * n)


def phase_envelope_phase(n=N_FULL, reps=1):
    """``envelope_phase`` of an AM tone against ``scipy.signal.hilbert`` in
    float64: envelope relative to its maximum, wrapped phase in radians
    where the envelope is above 1 % of its maximum."""
    import pyfft_tpu as ft
    from scipy.signal import hilbert
    t = np.arange(n) / FS
    am = ((1 + 0.5 * np.sin(2 * np.pi * 500 * t))
          * np.sin(2 * np.pi * 50e3 * t)).astype(np.float32)
    (env, ph), cold, walls = _timed(
        lambda: ft.hilbert_mod.envelope_phase(am), reps)
    z = hilbert(am.astype(np.float64))
    env_ref = np.abs(z)
    live = env_ref >= 1e-2 * env_ref.max()
    return PhaseResult(
        "envelope_phase",
        [("envelope", _rel_err(env, env_ref), 1e-5),
         ("phase_rad", _wrapped_phase_err(ph, np.angle(z), live), 1e-4)],
        cold, walls, samples=n)


def phase_xcoh_cog(n=N_FULL, reps=1, nch=NCH, nwins=4096):
    """``fft_pwelch`` of a complex IQ reference against ``nch`` complex
    channels (two-sided), its coherence, and ``cog`` of every channel,
    against a float64 segment loop and a float64 NumPy COG.  Coherence is
    compared in absolute terms where both PSDs exceed 1e-6 of their
    maximum."""
    import pyfft_tpu as ft
    rng = np.random.default_rng(3)
    t = np.arange(n) / FS
    f0 = 97e3

    def noise(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    x = (np.exp(2j * np.pi * f0 * t) + 0.3 * noise(n)).astype(np.complex64)
    c = np.arange(nch)[:, None]
    # each channel: the reference line, phase-lagged, plus a Doppler line
    # shifted by (c + 1) kHz, so every channel has its own COG
    y = (0.5 * (1 + c) * np.exp(1j * (2 * np.pi * f0 * t[None] - 0.3 * c))
         + 0.7 * np.exp(2j * np.pi * (f0 + 1e3 * (c + 1)) * t[None])
         + 0.3 * noise(nch, n)).astype(np.complex64)

    def call():
        r = ft.fft_pwelch(t, x, y, tper=nwins / FS, windowoverlap=0.5,
                          windowfunction="hanning", plotit=False)
        return r, np.asarray([ft.cog(y[k], FS) for k in range(nch)])

    ((_, Pxy, Pxx, Pyy, Cxy, _, info), cogs), cold, walls = _timed(call, reps)
    hop = nwins - info.noverlap
    xe = _analyzed_span(x.astype(np.complex128), nwins)
    ye = _analyzed_span(y.astype(np.complex128), nwins)
    Sxx, Syy, Sxy = _frames_fft_sums(xe, ye, np.asarray(info.win), nwins,
                                     hop, info.Navr)
    norm = 1.0 / (info.Navr * info.S1 ** 2 * info.ENBW)
    sh = np.fft.fftshift
    Pxx_r = sh(Sxx) * norm
    Pyy_r = sh(Syy, axes=-1).T * norm
    Pxy_r = sh(Sxy, axes=-1).T * norm
    C_r = Pxy_r / np.sqrt(Pxx_r[:, None] * Pyy_r)
    live = ((Pxx_r[:, None] >= 1e-6 * Pxx_r.max())
            & (Pyy_r >= 1e-6 * Pyy_r.max(axis=0)))
    freq = sh(np.fft.fftfreq(n, 1 / FS))
    cog_r = []
    for k in range(nch):
        p = np.abs(sh(np.fft.fft(y[k].astype(np.complex128)))) ** 2
        cog_r.append(np.sum(p * freq) / np.sum(p))
    cog_err = float(np.max(np.abs(cogs - np.asarray(cog_r))) / (FS / 2))
    return PhaseResult(
        "xcoh_cog",
        [("Pxx", _rel_err(Pxx, Pxx_r), 1e-5),
         ("Pyy", _rel_err(Pyy, Pyy_r), 1e-5),
         ("Pxy", _rel_err(Pxy, Pxy_r), 1e-5),
         ("Cxy_abs", float(np.max(np.abs(np.asarray(Cxy) - C_r)[live])),
          1e-4),
         # COG error over the half bandwidth: float32 power sums of the
         # full-length spectrum
         ("cog_over_fs2", cog_err, 1e-8)],
        cold, walls, samples=(nch + 1) * n)


def phase_welch_fir_chain(n=N_FULL, reps=1, nch=NCH, nwins=2048):
    """``welch_filtered_cross_spectra`` (129-tap band-pass FIR, Hann, 50 %
    overlap) against ``bench._numpy_reference_chain`` in float64."""
    import pyfft_tpu as ft
    from pyfft_tpu import segmentation as seg
    from pyfft_tpu.spectral import _onesided_power_scale
    import bench
    x, y = _channels(n, nch, seed=4)
    taps = ft.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    plan = seg.plan_segments(n, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1]
    out, cold, walls = _timed(lambda: ft.welch_filtered_cross_spectra(
        x, y, taps, win, plan, FS), reps)
    Pxx, Pyy, Pxy = bench._numpy_reference_chain(
        x.astype(np.float64), y.astype(np.float64), taps, win, plan)
    s1 = win.sum()
    sc = (_onesided_power_scale(plan.nfft, plan.nnyquist)
          / (s1 ** 2 * FS * (win ** 2).sum() / s1 ** 2))
    k = plan.nnyquist
    return PhaseResult(
        "welch_fir_chain",
        [("Pxx", _rel_err(out["Pxx"], Pxx[:k] * sc), 1e-5),
         ("Pyy", _rel_err(out["Pyy"], (Pyy[:, :k] * sc).T), 1e-5),
         ("Pxy", _rel_err(out["Pxy"], (Pxy[:, :k] * sc).T), 1e-5)],
        cold, walls, samples=(nch + 1) * n)


def phase_streaming(n=N_FULL, reps=1, nch=NCH, nblocks=16, nwins=2048):
    """``StreamingWelch`` fed ``nblocks`` equal blocks, against the batch
    ``welch_cross_spectra`` of the concatenated signal."""
    import pyfft_tpu as ft
    from pyfft_tpu import segmentation as seg
    x, y = _channels(n, nch, seed=5)
    x = x + np.float32(0.2)               # a DC offset for the mean detrend
    edges = np.linspace(0, n, nblocks + 1).astype(int)

    def call():
        sw = ft.StreamingWelch(nwins=nwins, fs=FS, nch=nch,
                               windowoverlap=0.5)
        for a, b in zip(edges[:-1], edges[1:]):
            sw.push(x[a:b], y[:, a:b])
        return sw.result()

    res, cold, walls = _timed(call, reps)
    plan = seg.plan_segments(n, nwins=nwins, windowoverlap=0.5)
    assert res.Navr == plan.navr, (res.Navr, plan.navr)
    # the window StreamingWelch builds for windowfunction="hanning"
    win = np.asarray(ft.windows("hanning", nwins=nwins, verbose=False))
    ref = ft.welch_cross_spectra(x, y, win, plan, FS)
    return PhaseResult(
        "streaming",
        [("Pxx", _rel_err(res.Pxx, np.real(ref["Pxx"])), 1e-5),
         ("Pyy", _rel_err(res.Pyy, np.real(ref["Pyy"]).T), 1e-5),
         ("Pxy", _rel_err(res.Pxy, ref["Pxy"].T), 1e-5)],
        cold, walls, samples=(nch + 1) * n)


def phase_mxu_option(n=N_FULL, reps=1, nwins=4096):
    """``fft_pwelch(fft_backend='mxu')`` (real-pair matmul DFTs) against the
    default cuFFT path at the ``welch_psd`` size; reports both times."""
    import pyfft_tpu as ft
    t, x = _tone(n, seed=1)
    kw = dict(tper=nwins / FS, windowoverlap=0.5, windowfunction="hanning",
              plotit=False)
    ref, _, walls_xla = _timed(
        lambda: ft.fft_pwelch(t, x, None, fft_backend="xla", **kw), reps)
    out, cold, walls = _timed(
        lambda: ft.fft_pwelch(t, x, None, fft_backend="mxu", **kw), reps)
    return PhaseResult(
        "mxu_option", [("Pxx_vs_xla", _rel_err(out[2], ref[2]), 1e-5)],
        cold, walls, samples=n,
        extra={"mxu_warm_s": f"{float(np.median(walls)):.6f}",
               "xla_warm_s": f"{float(np.median(walls_xla)):.6f}"})


PHASES = {
    "welch_psd": phase_welch_psd,
    "stft": phase_stft,
    "fir": phase_fir,
    "envelope_phase": phase_envelope_phase,
    "xcoh_cog": phase_xcoh_cog,
    "welch_fir_chain": phase_welch_fir_chain,
    "streaming": phase_streaming,
    "mxu_option": phase_mxu_option,
}


# --------------------------------------------------------------------------- #
# Mesh phases (--four; shared with __graft_entry__.dryrun_multichip)
# --------------------------------------------------------------------------- #

def mesh_checks(devices, shapes, n=1 << 25, n_long=1 << 26, nch=NCH,
                nwins=4096, ntaps=129, log=print):
    """The ``mesh=`` paths over ``devices`` against the same call on one
    device, one :class:`PhaseResult` per check:

    - ``fft_pwelch(mesh=...)`` and ``fir_filter_sharded`` of ``nch`` x
      ``n`` samples on every ``(ch, t)`` mesh shape in ``shapes``;
    - ``specgram_sharded`` of an ``n``-sample chirp, ``fft_sharded`` of
      ``n_long`` complex samples and ``envelope_phase(mesh=...)`` of
      ``n_long`` samples, on the first shape.

    Spectra, FIR, the four-step FFT (which sums in another order than
    ``jnp.fft.fft``) and the envelope built on it agree with the one-device
    call to 1e-5 of the maximum, the wrapped phase to 1e-4 rad: 9x and 45x
    the largest errors measured on four H100s (1.1e-6 and 2.2e-6 rad).  The collective bytes of
    each mesh's Welch, FIR and four-step steps are logged from the compiled
    HLO (``parallel.audit_mesh_paths``).
    """
    import jax
    import jax.numpy as jnp
    import pyfft_tpu as ft
    from pyfft_tpu import parallel as par
    out = []
    t = np.arange(n) / FS
    x, y = _channels(n, nch, seed=6)
    taps = ft.filters.firwin(ntaps, [0.05, 0.45], pass_zero=False)
    kw = dict(tper=nwins / FS, windowoverlap=0.5, windowfunction="hanning",
              plotit=False)
    one = ft.fft_pwelch(t, x, y, **kw)
    y_one = ft.filters.fir_filter(y, taps)
    for ch, tt in shapes:
        mesh = par.make_mesh(ch=ch, t=tt, devices=devices[:ch * tt])
        tag = f"{ch}x{tt}"
        r, cold, walls = _timed(lambda: ft.fft_pwelch(t, x, y, mesh=mesh,
                                                      **kw), 1)
        out.append(PhaseResult(f"fft_pwelch_mesh_{tag}", [
            ("Pxx", _rel_err(r[2], one[2]), 1e-5),
            ("Pyy", _rel_err(r[3], one[3]), 1e-5),
            ("Pxy", _rel_err(r[1], one[1]), 1e-5)], cold, walls,
            samples=(nch + 1) * n))
        yf, cold, walls = _timed(
            lambda: par.fir_filter_sharded(y, taps, mesh), 1)
        out.append(PhaseResult(f"fir_filter_sharded_{tag}",
                               [("y", _rel_err(yf, y_one), 1e-5)], cold,
                               walls, samples=nch * n))
        audit = par.audit_mesh_paths(mesh, nt=n, nch=nch, nwins=nwins,
                                     ntaps=ntaps, fft_n=n_long)
        for path, rows in audit.items():
            by_op = {}
            for row in rows:
                by_op[row["op"]] = by_op.get(row["op"], 0) + row["bytes"]
            log(f"collectives mesh={tag} path={path} bytes_per_device="
                f"{json.dumps(by_op, sort_keys=True)}")

    ch, tt = shapes[0]
    mesh = par.make_mesh(ch=ch, t=tt, devices=devices[:ch * tt])
    tag = f"{ch}x{tt}"
    f_inst = 1e3 + (200e3 - 1e3) * np.arange(n) / n
    chirp = np.sin(2 * np.pi * np.cumsum(f_inst) / FS).astype(np.float32)
    _, _, S1 = ft.specgram(t, chirp, wl=2048)
    (_, _, S), cold, walls = _timed(
        lambda: par.specgram_sharded(t, chirp, mesh, wl=2048), 1)
    out.append(PhaseResult(f"specgram_sharded_{tag}",
                           [("S", _rel_err(S, S1), 1e-5)], cold, walls,
                           samples=n))

    rng = np.random.default_rng(7)
    z = (rng.standard_normal(n_long)
         + 1j * rng.standard_normal(n_long)).astype(np.complex64)
    Z1 = np.asarray(jnp.fft.fft(jax.device_put(z, devices[0])))
    (zr, zi), cold, walls = _timed(lambda: par.fft_sharded(z, mesh), 1)
    out.append(PhaseResult(
        f"fft_sharded_{tag}",
        [("X", _rel_err(np.asarray(zr) + 1j * np.asarray(zi), Z1), 1e-5)],
        cold, walls, samples=n_long))

    tl = np.arange(n_long) / FS
    am = ((1 + 0.5 * np.sin(2 * np.pi * 500 * tl))
          * np.sin(2 * np.pi * 50e3 * tl)).astype(np.float32)
    env1, ph1 = ft.hilbert_mod.envelope_phase(am)
    (env, ph), cold, walls = _timed(
        lambda: ft.hilbert_mod.envelope_phase(am, mesh=mesh), 1)
    live = env1 >= 1e-2 * env1.max()
    out.append(PhaseResult(
        f"envelope_phase_mesh_{tag}",
        [("envelope", _rel_err(env, env1), 1e-5),
         ("phase_rad", _wrapped_phase_err(ph, ph1.astype(np.float64), live),
          1e-4)], cold, walls, samples=n_long))
    return out


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh paths, on four GPUs")
    args = ap.parse_args(argv)

    card = card_info()
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    import jax
    print(f"jax {jax.__version__} devices={jax.devices()} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    dev = device_record()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev['platform']!r}",
              file=sys.stderr)
        return 2
    if card is None:
        print("chip_smoke: nvidia-smi gave no card name and power limit",
              file=sys.stderr)
        return 2
    if jax.config.jax_enable_x64:
        print("chip_smoke: checks the float32 path; float64 is on "
              "(unset JAX_ENABLE_X64)", file=sys.stderr)
        return 2
    print(f"compile cache: {use_compile_cache()}", flush=True)
    from pyfft_tpu.utils.profiling import device_peaks
    print(f"published peaks ({dev['kind']}): {device_peaks(dev['kind'])}",
          flush=True)

    if args.four:
        if dev["count"] < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {dev['count']}",
                  file=sys.stderr)
            return 2
        devices = jax.devices()[:4]
        results = mesh_checks(devices, [(1, 4), (2, 2)])
        for r in results:
            print(r.line(), flush=True)
    else:
        results = []
        for phase in PHASES.values():
            results.append(phase())
            print(results[-1].line(), flush=True)
    if not all(r.ok for r in results):
        print("chip_smoke: failed: "
              + ", ".join(r.name for r in results if not r.ok),
              file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
