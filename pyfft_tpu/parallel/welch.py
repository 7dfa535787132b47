"""Sharded Welch cross-spectral estimation (SP over time, DP over channels).

The reference is strictly serial (largest self-test: 2^19 samples,
``fft_analysis.py:2957``); this module is the scaling layer SURVEY §2.3
specifies for it:

- the **time axis** is partitioned across the ``'t'`` mesh axis; each device
  computes the Welch segments whose *start* falls in its block.  Segments
  that straddle a block boundary read up to ``nwins - 1`` neighbor samples,
  delivered by a single ``lax.ppermute`` halo exchange (the reference's
  overlap-slicing ``ist = arange(Navr) * hop``, ``fft_analysis.py:359``,
  turned into a neighbor collective);
- the **channel axis** is data-parallel over ``'ch'``;
- segment power sums reduce with ``lax.psum`` over ``'t'`` (the reference's
  ``np.mean(P_seg)``, ``fft_analysis.py:444-446``, as a collective);
- global mean/linear detrend moments also reduce over ``'t'`` so sharded
  results match the single-device pipeline bit-for-bit (up to float
  reassociation).

All shapes/counts are resolved statically; the jitted step contains only
ppermute + batched FFT + psum, which XLA schedules over ICI.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .. import segmentation as seg
from ..ops import mxu_fft
from ..spectral import _onesided_power_scale, resolve_fft_backend
from .mesh import shard_map, P, NamedSharding


__all__ = ["welch_psd_sharded", "plan_shard_segments"]


def plan_shard_segments(nt: int, nwins: int, hop: int, navr: int, dshards: int):
    """Static segment->device assignment.

    Device ``d`` owns time block ``[d*B, (d+1)*B)`` and computes the global
    segments whose start index lies in its block.  ``nt`` may include
    zero-padding to a shard multiple (the caller masks segments by
    ``navr``).  Returns ``(B, M)`` with ``M`` the (padded) per-device
    segment count.
    """
    if nt % dshards:
        raise ValueError(f"time axis {nt} not divisible by {dshards} shards")
    B = nt // dshards
    if nwins - 1 > B:
        raise ValueError(
            f"segment length {nwins} needs a halo of {nwins - 1} > block {B};"
            " use fewer time shards or longer signals")
    counts = np.zeros(dshards, dtype=int)
    for g in range(navr):
        counts[(g * hop) // B] += 1
    return B, int(counts.max())


def _detrend_sharded(v, style, axis_name, nt_true=None):
    """Global mean/linear detrend via psum'd moments along the time axis.

    ``nt_true`` is the unpadded signal length: padding zeros contribute
    nothing to the moment sums, so dividing by the true length makes the
    sharded moments bit-equivalent to the single-device ones.
    """
    if style == 0:
        return v
    nt_local = v.shape[-1]
    nshards = lax.psum(1, axis_name)
    ntot = nt_true if nt_true is not None else nt_local * nshards
    s = lax.psum(jnp.sum(v, axis=-1, keepdims=True), axis_name)
    mean = s / ntot
    if style > 0:
        return v - mean
    # linear: fit against the *global* sample index (pad samples carry
    # v = 0 - mean after centering, so exclude them via an index mask)
    d = lax.axis_index(axis_name)
    tloc = jnp.arange(nt_local, dtype=v.dtype) + d * nt_local
    valid = (tloc < ntot).astype(v.dtype)
    tmean = (ntot - 1) / 2.0
    tc = (tloc - tmean) * valid
    st = lax.psum(jnp.sum(v * tc, axis=-1, keepdims=True), axis_name)
    # sum over the global centered grid of tc^2 (closed form over ntot)
    denom = (ntot * (ntot ** 2 - 1)) / 12.0
    slope = st / denom
    return v - mean - slope * tc


def _halo_right(v, halo, axis_name):
    """Append the first ``halo`` samples of the right neighbor.

    ``lax.ppermute`` with a non-cyclic permutation zero-fills the last
    shard's halo — harmless because no valid segment reads past the end.
    """
    nshards = lax.psum(1, axis_name)
    head = v[..., :halo]
    perm = [(i, i - 1) for i in range(1, nshards)]
    recv = lax.ppermute(head, axis_name, perm)
    return jnp.concatenate([v, recv], axis=-1)


@partial(jax.jit, static_argnames=("navr", "nwins", "hop", "nfft", "nnyquist",
                                   "onesided", "detrend_style", "backend",
                                   "B", "M", "mesh_static", "ntmodel",
                                   "nt_true", "cplx"))
def _welch_sharded_jit(x, y, win, s1sq_enbw, *, navr, nwins, hop, nfft,
                       nnyquist, onesided, detrend_style, backend, B, M,
                       mesh_static, ntmodel=False, nt_true=None, cplx=False):
    mesh = mesh_static.mesh

    def step(x_l, y_l, win_l, norm_l):
        # x_l: (B_local,) time-sharded — or the replicated (nwins,) model
        # when ntmodel (reference fft_analysis.py:170-191); y_l: (nch_l, B).
        # Complex signals ride as a stacked (re, im) leading axis of size 2
        # — x_l (2, B), y_l (nch_l, 2, B) — so no complex dtype crosses a
        # collective; the transform consumes the
        # pair directly (reference two-sided branch fft_analysis.py:423-427)
        y_l = _detrend_sharded(y_l, detrend_style, "t", nt_true)

        halo = nwins - 1
        y_h = _halo_right(y_l, halo, "t")

        d = lax.axis_index("t")
        g0 = (d * B + hop - 1) // hop           # first segment in this block
        g_ids = g0 + jnp.arange(M)
        valid = (g_ids * hop < (d + 1) * B) & (g_ids < navr)
        starts = jnp.clip(g_ids * hop - d * B, 0, B + halo - nwins)

        idx = starts[:, None] + jnp.arange(nwins)[None, :]
        if ntmodel:
            from ..utils.detrend import detrend_func
            xm = detrend_func(detrend_style)(x_l[..., :nwins], axis=-1)
            xfr = jnp.broadcast_to((xm * win_l)[..., None, :],
                                   x_l.shape[:-1] + (M, nwins))
        else:
            x_l = _detrend_sharded(x_l, detrend_style, "t", nt_true)
            x_h = _halo_right(x_l, halo, "t")
            xfr = x_h[..., idx] * win_l         # ([2,] M, nwins)
        yfr = y_h[..., idx] * win_l             # (nch_l, [2,] M, nwins)

        def _fft(fr, lead):
            """(re, im) spectra of real or stacked-pair frames."""
            if cplx:
                re, im = fr[lead + (0,)], fr[lead + (1,)]
            else:
                re, im = fr, None
            if backend == "xla":
                Z = jnp.fft.fft(re if im is None else lax.complex(re, im),
                                n=nfft, axis=-1)
                return jnp.real(Z), jnp.imag(Z)
            return mxu_fft.fft_pair(re, im, n=nfft, axis=-1)

        Xr, Xi = _fft(xfr, ())
        Yr, Yi = _fft(yfr, (slice(None),))
        Pxx = Xr * Xr + Xi * Xi
        Pyy = Yr * Yr + Yi * Yi
        Pxy_re = Yr * Xr + Yi * Xi              # Y conj(X), reference :393
        Pxy_im = Yi * Xr - Yr * Xi

        w = valid.astype(Pxx.dtype)
        Pxx = jnp.sum(Pxx * w[:, None], axis=0)
        Pyy = jnp.sum(Pyy * w[None, :, None], axis=1)
        Pxy_re = jnp.sum(Pxy_re * w[None, :, None], axis=1)
        Pxy_im = jnp.sum(Pxy_im * w[None, :, None], axis=1)

        # Welch average: psum the per-device partial sums over 't'
        Pxx = lax.psum(Pxx, "t") / navr
        Pyy = lax.psum(Pyy, "t") / navr
        Pxy_re = lax.psum(Pxy_re, "t") / navr
        Pxy_im = lax.psum(Pxy_im, "t") / navr

        if onesided:
            sc = jnp.asarray(_onesided_power_scale(nfft, nnyquist),
                             dtype=Pxx.dtype)
            Pxx = Pxx[..., :nnyquist] * sc
            Pyy = Pyy[..., :nnyquist] * sc
            Pxy_re = Pxy_re[..., :nnyquist] * sc
            Pxy_im = Pxy_im[..., :nnyquist] * sc
        else:
            Pxx = jnp.fft.fftshift(Pxx, axes=-1)
            Pyy = jnp.fft.fftshift(Pyy, axes=-1)
            Pxy_re = jnp.fft.fftshift(Pxy_re, axes=-1)
            Pxy_im = jnp.fft.fftshift(Pxy_im, axes=-1)

        return (Pxx * norm_l, Pyy * norm_l, Pxy_re * norm_l, Pxy_im * norm_l)

    if cplx:
        x_spec = P() if ntmodel else P(None, "t")
        y_spec = P("ch", None, "t")
    else:
        x_spec = P() if ntmodel else P("t")
        y_spec = P("ch", "t")
    return shard_map(
        step, mesh,
        in_specs=(x_spec, y_spec, P(), P()),
        out_specs=(P(), P("ch", None), P("ch", None), P("ch", None)),
        check_vma=False,
    )(x, y, win, 1.0 / s1sq_enbw)


class _MeshBox:
    """Hashable wrapper so a Mesh can ride in a static jit argument."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash((tuple(self.mesh.axis_names), self.mesh.devices.shape,
                     tuple(d.id for d in self.mesh.devices.flat)))

    def __eq__(self, other):
        return (isinstance(other, _MeshBox)
                and self.mesh.axis_names == other.mesh.axis_names
                and self.mesh.devices.shape == other.mesh.devices.shape
                and all(a.id == b.id for a, b in
                        zip(self.mesh.devices.flat, other.mesh.devices.flat)))


def welch_psd_sharded(x, y, win, plan: seg.SegmentPlan, fs, mesh, *,
                      onesided=True, detrend_style=1, fft_backend=None,
                      ntmodel=False):
    """Distributed Welch auto-/cross-spectra over a ``('ch','t')`` mesh.

    ``x (nt,)`` is the common reference signal (time-sharded) — or, with
    ``ntmodel=True``, a one-window model replicated to every device
    (reference ``fft_analysis.py:170-191``); ``y (nch, nt)`` is channel-
    and time-sharded.  Complex signals are supported on both the one- and
    two-sided paths (the Doppler IQ configuration, reference
    ``fft_analysis.py:423-427``): they travel as stacked (re, im) real
    pairs so no complex dtype reaches the device.  Signals whose length is
    not a multiple of the time shards are zero-padded (exactly compensated
    in the detrend moments and masked out of the segment set).  Returns
    numpy ``(freq, Pxx, Pyy, Pxy)`` with the identical normalization
    contract as the single-device pipeline — sharded == unsharded is
    asserted in the test-suite and the driver dryrun.
    """
    x = np.asarray(x)
    y = np.atleast_2d(np.asarray(y))
    cplx = np.iscomplexobj(x) or np.iscomplexobj(y)
    if cplx:
        # stacked (re, im) pairs: x (2, nt), y (nch, 2, nt)
        x = np.stack([np.ascontiguousarray(x.real),
                      np.ascontiguousarray(x.imag)])
        y = np.stack([np.ascontiguousarray(y.real),
                      np.ascontiguousarray(y.imag)], axis=1)
    win_np = np.asarray(win)
    s1 = seg.get_s1(win_np)
    enbw = seg.get_enbw(fs, s1, seg.get_s2(win_np))

    dt_shards = mesh.shape["t"]
    dch = mesh.shape["ch"]
    if y.shape[0] % dch:
        raise ValueError(f"nch={y.shape[0]} not divisible by ch shards {dch}")
    nt = y.shape[-1]
    pad = (-nt) % dt_shards
    if pad:
        y = np.concatenate([y, np.zeros(y.shape[:-1] + (pad,), y.dtype)],
                           axis=-1)
        if not ntmodel:
            x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)],
                               axis=-1)
    B, M = plan_shard_segments(nt + pad, plan.nwins, plan.hop, plan.navr,
                               dt_shards)

    def _put(arr, spec):
        sh = NamedSharding(mesh, spec)
        if jax.process_count() > 1:
            # multi-process: assemble the global array from local shards
            # (device_put refuses non-addressable shardings)
            return jax.make_array_from_callback(arr.shape, sh,
                                                lambda idx: arr[idx])
        return jax.device_put(arr, sh)

    if cplx:
        xs = _put(x, P() if ntmodel else P(None, "t"))
        ys = _put(y, P("ch", None, "t"))
    else:
        xs = _put(x, P() if ntmodel else P("t"))
        ys = _put(y, P("ch", "t"))
    wd = jnp.asarray(win_np, dtype=xs.dtype)

    Pxx, Pyy, Pxy_re, Pxy_im = _welch_sharded_jit(
        xs, ys, wd, jnp.asarray(s1 ** 2 * enbw, dtype=xs.dtype),
        navr=plan.navr, nwins=plan.nwins, hop=plan.hop, nfft=plan.nfft,
        nnyquist=plan.nnyquist, onesided=bool(onesided),
        detrend_style=int(detrend_style),
        backend=resolve_fft_backend(fft_backend), B=B, M=M,
        mesh_static=_MeshBox(mesh), ntmodel=bool(ntmodel),
        nt_true=int(nt), cplx=cplx)

    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    freq = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return (freq, np.asarray(Pxx), np.asarray(Pyy),
            np.asarray(Pxy_re) + 1j * np.asarray(Pxy_im))
