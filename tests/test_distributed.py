"""Multi-process distributed runtime tests (SURVEY §5.8 / BASELINE 2-host).

These tests stand in for a multi-host run the way SURVEY §4(d) prescribes:
two OS processes with 4 virtual CPU devices each, a genuine
``jax.distributed`` runtime with a localhost coordinator, and the sharded
Welch estimator running halo/psum collectives ACROSS the process boundary.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import jax


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_welch_matches_single():
    """Sharded == single-device across a real process boundary."""
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    # the workers choose their own platform and device count
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert "DISTRIBUTED-OK" in out


def test_measure_scaling_harness():
    """The scaling-efficiency harness runs and reports sane numbers."""
    import pyfft_tpu.parallel as par
    ndev = len(jax.devices())
    if ndev < 2:
        pytest.skip("needs >=2 devices")
    rows = par.measure_scaling(nt=1 << 16, nch=2, nwins=512, iters=2,
                               shard_counts=[1, 2])
    assert [r["t_shards"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["samples_per_s"] > 0 for r in rows)
    # virtual CPU devices share cores: only shape-check efficiency here
    assert 0 < rows[1]["efficiency"] < 10


def test_scaling_report_measured_section():
    import pyfft_tpu.parallel as par
    ndev = len(jax.devices())
    if ndev < 2:
        pytest.skip("needs >=2 devices")
    mesh = par.make_mesh(ch=1, t=min(2, ndev))
    rep = par.scaling_report(mesh, measure=True, nt=1 << 15, nch=1,
                             nwins=512, iters=1, shard_counts=[1, 2])
    assert "measured" in rep and len(rep["measured"]) == 2
    assert "efficiency" in rep["measured"][-1]
