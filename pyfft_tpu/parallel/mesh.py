"""Device-mesh construction helpers.

The framework's scaling model (SURVEY §2.3): a 2-D logical mesh with a
channel axis (``'ch'``, embarrassingly-parallel shots/channels — DP) and a
time axis (``'t'``, sequence parallelism with halo exchange — SP/CP).
Welch averages reduce with ``psum`` over ``'t'``; segment/FIR halos move
with ``ppermute`` along ``'t'``.  The GPUs of one host are joined all to
all, so the mesh shape follows the algorithm alone.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec, NamedSharding

P = PartitionSpec

__all__ = ["make_mesh", "shard_map", "P", "Mesh", "NamedSharding",
           "device_counts"]


def shard_map(f, mesh, in_specs, out_specs, check_vma=False):
    """``jax.shard_map`` with the framework's default ``check_vma=False``."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check_vma)


def device_counts():
    return len(jax.devices())


def make_mesh(ch: int = 1, t: int | None = None, devices=None) -> Mesh:
    """Build a ``('ch', 't')`` mesh over the available devices.

    ``t`` defaults to ``ndevices // ch``.  With a single device this still
    returns a valid 1x1 mesh so the same code path runs everywhere.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if t is None:
        if n % ch:
            raise ValueError(f"{n} devices not divisible by ch={ch}")
        t = n // ch
    if ch * t > n:
        raise ValueError(f"mesh {ch}x{t} needs {ch * t} devices, have {n}")
    devs = np.asarray(devices[:ch * t]).reshape(ch, t)
    return Mesh(devs, axis_names=("ch", "t"))
