"""Multi-process runtime bootstrap (SURVEY §5.8).

The reference is a single NumPy process; this framework's communication
backend is the JAX distributed runtime: ``jax.distributed.initialize()``
per process, a ``('host', 'ch', 't')`` mesh whose leading axis spans
processes (collectives over it cross the host network; the inner axes stay
within one host, whose GPUs are joined all to all by NVLink).

- :func:`init_distributed`: idempotent wrapper over
  ``jax.distributed.initialize`` (explicit coordinator address, process
  count and id);
- :func:`make_host_mesh`: the three-axis mesh with hosts outermost, so
  channel-DP crosses hosts (embarrassingly parallel) while time-axis halos
  (ppermute) and segment psums stay within a host;
- :func:`scaling_report`: per-axis device counts + the collective->link
  mapping, for the observability log;
- :func:`audit_collectives`: collective ops and their byte volumes read
  from compiled HLO.
"""
from __future__ import annotations

import time

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["init_distributed", "make_host_mesh", "scaling_report",
           "measure_scaling", "audit_collectives", "audit_mesh_paths"]

_initialized = False


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize the JAX distributed runtime (idempotent).

    Pass the coordinator address, process count and process id explicitly
    for multi-process runs.  Single-process (the common case) is a no-op.
    """
    global _initialized
    if _initialized:
        return
    if num_processes is None and coordinator_address is None:
        if jax.process_count() == 1:
            _initialized = True
            return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True


def make_host_mesh(ch=1, t=None):
    """``('host', 'ch', 't')`` mesh: hosts outermost (host network), ch/t
    within a host (NVLink).  ``t`` defaults to all remaining local
    devices."""
    devices = jax.devices()
    nproc = jax.process_count()
    per_host = len(devices) // nproc
    if t is None:
        t = per_host // ch
    if ch * t != per_host:
        raise ValueError(
            f"ch*t = {ch * t} != {per_host} devices per host")
    arr = np.array(devices).reshape(nproc, ch, t)
    return Mesh(arr, axis_names=("host", "ch", "t"))


def scaling_report(mesh, measure=False, **measure_kw):
    """Axis sizes, the collective->link mapping, and (optionally) a
    *measured* scaling-efficiency table from :func:`measure_scaling`."""
    sizes = dict(mesh.shape)
    rep = {
        "axes": sizes,
        "devices": int(np.prod(list(sizes.values()))),
        "collectives": {
            "psum(welch average)": "intra-host ('t')"
            if "t" in sizes else "n/a",
            "ppermute(segment/FIR halo)": "intra-host ('t')"
            if "t" in sizes else "n/a",
            "all_to_all(four-step FFT)": "intra-host ('t')"
            if "t" in sizes else "n/a",
            "all_gather(final spectra)": "inter-host ('host')"
            if "host" in sizes else "n/a",
        },
    }
    if measure:
        rep["measured"] = measure_scaling(**measure_kw)
    return rep


def measure_scaling(nt=1 << 20, nch=4, nwins=1024, iters=5, shard_counts=None,
                    fft_backend=None):
    """Measure Welch throughput vs time-shard count; returns an efficiency
    table (the BASELINE ">=85% at 2 hosts" acceptance harness).

    Runs :func:`pyfft_tpu.parallel.welch_psd_sharded` on ``('ch'=1,
    't'=d)`` meshes for each ``d`` in ``shard_counts`` (default: powers of
    two up to the device count) and reports samples/s plus efficiency
    relative to linear scaling from the smallest count.  On a virtual CPU
    mesh the devices share physical cores, so the efficiency numbers there
    only validate the harness; quote real numbers from multi-chip runs.
    """
    from .. import segmentation as seg
    from .mesh import make_mesh
    from .welch import welch_psd_sharded

    ndev = len(jax.devices())
    if shard_counts is None:
        shard_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(nt).astype(np.float32)
    y = rng.standard_normal((nch, nt)).astype(np.float32)
    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1].astype(np.float32)

    rows = []
    for d in shard_counts:
        mesh = make_mesh(ch=1, t=d, devices=jax.devices()[:d])
        welch_psd_sharded(x, y, win, plan, 1e6, mesh,
                          fft_backend=fft_backend)        # warm compile
        t0 = time.perf_counter()
        for _ in range(iters):
            welch_psd_sharded(x, y, win, plan, 1e6, mesh,
                              fft_backend=fft_backend)
        dt = (time.perf_counter() - t0) / iters
        rows.append({"t_shards": d, "samples_per_s": nch * nt / dt,
                     "wall_s": dt})
    base = rows[0]
    for r in rows:
        ideal = base["samples_per_s"] * (r["t_shards"] / base["t_shards"])
        r["efficiency"] = round(r["samples_per_s"] / ideal, 3)
    return rows


# --------------------------------------------------------------------------- #
# HLO collective audit
# --------------------------------------------------------------------------- #

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "s8": 1, "u8": 1, "pred": 1,
                "c64": 8, "c128": 16}


def audit_collectives(compiled_text):
    """Parse post-SPMD compiled HLO for collective ops and payload bytes.

    Returns rows ``{'op', 'shapes', 'bytes'}`` — the per-device payload of
    each collective taken from its result shape(s).  The byte volumes come
    from the compiler's own partitioned module, not from a hand model.
    An asynchronous collective (``*-start`` / ``*-done``, as the GPU
    backend emits) is counted once, from its ``-done`` result.
    """
    import re
    rows = []
    pat = re.compile(
        r"=\s*([^=]*?)\s*"
        r"(all-reduce|collective-permute|all-to-all|all-gather|"
        r"reduce-scatter)(?:-done)?\(")
    shape_pat = re.compile(r"\b([a-z]+\d+|pred)\[([\d,]*)\]")
    for line in compiled_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        nbytes, desc = 0, []
        for dt, dims in shape_pat.findall(m.group(1)):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES.get(dt, 4)
            desc.append(f"{dt}[{dims}]")
        rows.append({"op": m.group(2), "shapes": desc, "bytes": int(nbytes)})
    return rows


def audit_mesh_paths(mesh, *, nt, nch, nwins, ntaps, fft_n=None):
    """Collectives of the sharded steps, compiled for ``mesh`` but not run.

    Lowers the time-sharded Welch step (``nch`` channels plus the
    reference, ``nt`` samples, Hann segments of ``nwins`` at 50 %
    overlap), the time-sharded overlap-save FIR step (``ntaps`` taps) and,
    with ``fft_n``, the four-step FFT of ``fft_n`` points, from abstract
    sharded inputs, and returns ``{path: audit_collectives rows}`` for
    ``'welch'``, ``'fir'`` and ``'fft4step'``.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .. import segmentation as seg
    from ..filters import _os_plan
    from ..spectral import resolve_fft_backend
    from .fft import _fourstep_jit, four_step_factor
    from .fir import _fir_sharded_jit
    from .welch import _MeshBox, _welch_sharded_jit, plan_shard_segments

    backend = resolve_fft_backend(None)
    d = mesh.shape["t"]
    f32 = jnp.float32

    def arg(shape, spec=None):
        sh = None if spec is None else NamedSharding(mesh, spec)
        return jax.ShapeDtypeStruct(shape, f32, sharding=sh)

    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    B, M = plan_shard_segments(nt, plan.nwins, plan.hop, plan.navr, d)
    welch = _welch_sharded_jit.lower(
        arg((nt,), P("t")), arg((nch, nt), P("ch", "t")), arg((nwins,)),
        arg(()), navr=plan.navr, nwins=plan.nwins, hop=plan.hop,
        nfft=plan.nfft, nnyquist=plan.nnyquist, onesided=True,
        detrend_style=1, backend=backend, B=B, M=M,
        mesh_static=_MeshBox(mesh), ntmodel=False, nt_true=nt, cplx=False)
    nfft_os, hop_os, nblocks = _os_plan(nt // d + ntaps - 1, ntaps, None)
    nh = nfft_os // 2 + 1
    fir = _fir_sharded_jit.lower(
        arg((nch, nt), P("ch", "t")), arg((nh,)), arg((nh,)), ntaps=ntaps,
        nfft=nfft_os, hop=hop_os, nblocks=nblocks, backend=backend,
        mesh_static=_MeshBox(mesh))
    out = {"welch": audit_collectives(welch.compile().as_text()),
           "fir": audit_collectives(fir.compile().as_text())}
    if fft_n is not None:
        n1, n2 = four_step_factor(fft_n, d)
        fft = _fourstep_jit.lower(
            arg((fft_n,), P("t")), arg((fft_n,), P("t")), n=fft_n, n1=n1,
            n2=n2, d=d, axis_name="t", backend=backend, sign=-1.0,
            mesh=mesh)
        out["fft4step"] = audit_collectives(fft.compile().as_text())
    return out
