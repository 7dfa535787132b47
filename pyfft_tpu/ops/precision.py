"""Matmul precision policy for the real-pair matmul-DFT tier.

The matmul DFTs (:mod:`pyfft_tpu.ops.mxu_fft`, the factored analytic chain
in :mod:`pyfft_tpu.hilbert`) take one of three precision names, mapped to
``jax.lax.Precision`` where the contraction is built:

- ``'highest'`` — full float32 products (``Precision.HIGHEST``);
- ``'bf16x3'``  — three-pass bf16 compensated products (``Precision.HIGH``);
- ``'bf16'``    — one bf16 pass (``Precision.DEFAULT``).

The default is ``'highest'`` on every platform: on an NVIDIA GPU a float32
product with no precision stated runs in TF32, which keeps about three
decimal digits — too few for spectral estimation.
"""
from __future__ import annotations

__all__ = ["KERNEL_PRECISIONS", "resolve_kernel_precision"]

#: precision names accepted by the matmul-DFT tier
KERNEL_PRECISIONS = ("highest", "bf16x3", "bf16")


def resolve_kernel_precision(precision=None) -> str:
    """None -> ``'highest'``; a known name passes through; else ValueError."""
    if precision in KERNEL_PRECISIONS:
        return precision
    if precision is not None:
        raise ValueError(f"unknown kernel precision {precision!r}; "
                         f"expected one of {KERNEL_PRECISIONS} or None")
    return "highest"
