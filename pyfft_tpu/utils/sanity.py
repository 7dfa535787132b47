"""Consistency sanitizers (SURVEY §5.2).

The reference is single-threaded NumPy — no race conditions exist, so it
ships nothing here.  The device build's analogous hazards are (a) divergence
between traced/compiled and eager execution, (b) silent NaN/Inf
propagation through jitted pipelines, and (c) nondeterminism between
sharded and single-device execution (collective reassociation).  Each gets
an executable check:

- :func:`check_jit_eager`: run a function both jitted and eagerly on the
  same inputs and compare leaf-wise;
- :func:`nan_guard`: context manager enabling ``jax_debug_nans`` within a
  scope (crash at the op that produced the first NaN);
- :func:`assert_finite`: pytree-wide finiteness assertion with the path of
  the offending leaf;
- :func:`check_sharded_consistency`: compare a mesh-sharded computation
  against its single-device run within a reassociation tolerance.
"""
from __future__ import annotations

import contextlib

import numpy as np
import jax

__all__ = ["check_jit_eager", "nan_guard", "assert_finite",
           "check_sharded_consistency"]


def _compare_trees(a, b, rtol, atol, label_a, label_b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    if ta != tb:
        raise AssertionError(
            f"{label_a} / {label_b} pytree structures differ: {ta} vs {tb}")
    for i, (xa, xb) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(
            np.asarray(xa), np.asarray(xb), rtol=rtol, atol=atol,
            err_msg=f"leaf {i}: {label_a} != {label_b}")


def check_jit_eager(fn, *args, rtol=1e-5, atol=1e-8, static_argnames=()):
    """Assert ``jit(fn)(*args) == fn(*args)`` leaf-wise; returns the jitted
    output on success."""
    eager = fn(*args)
    jitted = jax.jit(fn, static_argnames=static_argnames)(*args)
    _compare_trees(jitted, eager, rtol, atol, "jit", "eager")
    return jitted


@contextlib.contextmanager
def nan_guard(enable=True):
    """Scope with ``jax_debug_nans`` active: the first NaN-producing op
    raises immediately instead of propagating."""
    if not enable:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name="output"):
    """Raise with the leaf path if any array in ``tree`` has NaN/Inf."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
            nbad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {nbad}/{arr.size} "
                "non-finite values")
    return tree


def check_sharded_consistency(sharded_fn, single_fn, *args, rtol=1e-5,
                              atol=1e-8):
    """Assert a sharded computation matches its single-device reference.

    ``sharded_fn`` runs over the mesh; ``single_fn`` is the same math on one
    device.  Tolerances absorb collective reassociation (psum order).
    """
    _compare_trees(sharded_fn(*args), single_fn(*args), rtol, atol,
                   "sharded", "single-device")
