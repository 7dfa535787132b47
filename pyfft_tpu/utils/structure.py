"""Result containers for the spectral-analysis framework.

The reference package carries all results in a mutable attribute-bag
(``pybaseutils.Struct``; see the output-schema definition in the reference's
``fft_analysis.py:796-828`` ``fftinfosc``).  Here we keep a tiny, dependency-free
equivalent (:class:`Struct`) for API parity, and register it as a JAX pytree so
result bundles can flow through ``jax.jit`` / ``jax.device_get`` untouched.
"""
from __future__ import annotations

import jax


class Struct:
    """A minimal attribute-bag (replacement for ``pybaseutils.Struct``).

    Supports construction from a dict, attribute access, and conversion back
    to a dict via :meth:`dict_from_class` (name kept for reference parity).
    """

    def __init__(self, d=None):
        if d is not None:
            if not isinstance(d, dict):
                d = d.dict_from_class()
            self.__dict__.update(d)

    def dict_from_class(self):
        return dict(self.__dict__)

    def update(self, d=None):
        if d is not None:
            if not isinstance(d, dict):
                d = d.dict_from_class()
            self.__dict__.update(d)
        return self

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):  # pragma: no cover - debugging aid
        keys = ", ".join(sorted(self.__dict__.keys()))
        return f"Struct({keys})"


def _struct_flatten(s: Struct):
    keys = sorted(s.__dict__.keys())
    return [s.__dict__[k] for k in keys], tuple(keys)


def _struct_unflatten(keys, values):
    s = Struct()
    s.__dict__.update(dict(zip(keys, values)))
    return s


jax.tree_util.register_pytree_node(Struct, _struct_flatten, _struct_unflatten)
