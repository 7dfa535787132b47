"""Sharded STFT: segment spectra computed where the samples live.

Spectrogram workloads keep every segment (no Welch average), so the output
stays big — ``(navr, nfreq)``.  Each device computes the segments whose
start falls in its time block (ppermute halo for stragglers, exactly like
:mod:`pyfft_tpu.parallel.welch`), applies the reference ``fft_win``
coefficient scaling (sqrt2-amplitude one-sided, ``1/(S1 sqrt(ENBW))``), and
the host compacts the per-device (M, nfreq) tiles into global segment
order.  Matches :func:`pyfft_tpu.fftanal.stft_segments` bit-for-bit up to
collective reassociation (asserted in tests).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .. import segmentation as seg
from ..ops import mxu_fft
from ..spectral import _onesided_amp_scale, resolve_fft_backend
from .mesh import shard_map, P
from .welch import plan_shard_segments, _detrend_sharded, _halo_right, \
    _MeshBox

__all__ = ["stft_sharded", "specgram_sharded"]


@partial(jax.jit, static_argnames=("navr", "nwins", "hop", "nfft",
                                   "nnyquist", "onesided", "detrend_style",
                                   "backend", "B", "M", "mesh_static",
                                   "cplx", "raw", "power", "nt_true"))
def _stft_sharded_jit(x, tvec, win, s1, sqrt_enbw, *, navr, nwins, hop,
                      nfft, nnyquist, onesided, detrend_style, backend, B,
                      M, mesh_static, cplx=False, raw=False, power=False,
                      nt_true=None):
    mesh = mesh_static.mesh

    def step(x_l, t_l, win_l, s1_l, senbw_l):
        # complex signals arrive as a stacked (re, im) leading axis of 2.
        # nt_true = unpadded length, so shard-padding zeros cannot skew
        # the global detrend moments (same contract as welch_psd_sharded)
        x_l = _detrend_sharded(x_l, detrend_style, "t", nt_true=nt_true)
        halo = nwins - 1
        x_h = _halo_right(x_l, halo, "t")
        t_h = _halo_right(t_l, halo, "t")

        d = lax.axis_index("t")
        g0 = (d * B + hop - 1) // hop
        g_ids = g0 + jnp.arange(M)
        valid = (g_ids * hop < (d + 1) * B) & (g_ids < navr)
        starts = jnp.clip(g_ids * hop - d * B, 0, B + halo - nwins)

        idx = starts[:, None] + jnp.arange(nwins)[None, :]
        xw = x_h[..., idx] * win_l               # ([2,] M, nwins)
        tt = jnp.mean(t_h[idx], axis=-1)

        re, im = (xw[0], xw[1]) if cplx else (xw, None)
        if backend == "xla":
            X = jnp.fft.fft(re if im is None else lax.complex(re, im),
                            n=nfft, axis=-1)
            Xr, Xi = jnp.real(X), jnp.imag(X)
        else:
            Xr, Xi = mxu_fft.fft_pair(re, im, n=nfft, axis=-1)
        if raw:
            # the Welch core's Xfft_seg contract (fft_analysis.py:391-393):
            # full-nfft, natural bin order, no coefficient scaling
            scale = jnp.ones((), Xr.dtype)
        elif onesided:
            amp = jnp.asarray(_onesided_amp_scale(nfft, nnyquist),
                              dtype=Xr.dtype)
            Xr = Xr[..., :nnyquist] * amp
            Xi = Xi[..., :nnyquist] * amp
            scale = 1.0 / (s1_l * senbw_l)
        else:
            Xr = jnp.fft.fftshift(Xr, axes=-1)
            Xi = jnp.fft.fftshift(Xi, axes=-1)
            scale = 1.0 / (s1_l * senbw_l)
        Xr = Xr * scale
        Xi = Xi * scale
        gid = g_ids * valid - (1 - valid)        # -1 marks padding rows
        if power:
            # power-spectrogram consumers gather the REAL |X|^2 grid —
            # half the bytes of the complex pair
            return Xr * Xr + Xi * Xi, tt, gid
        return Xr, Xi, tt, gid

    if power:
        return shard_map(
            step, mesh,
            in_specs=(P(None, "t") if cplx else P("t"), P("t"),
                      P(), P(), P()),
            out_specs=(P("t", None), P("t"), P("t")),
            check_vma=False,
        )(x, tvec, win, s1, sqrt_enbw)
    return shard_map(
        step, mesh,
        in_specs=(P(None, "t") if cplx else P("t"), P("t"), P(), P(), P()),
        out_specs=(P("t", None), P("t", None), P("t"), P("t")),
        check_vma=False,
    )(x, tvec, win, s1, sqrt_enbw)


def stft_sharded(x, tvec, win, plan: seg.SegmentPlan, fs, mesh, *,
                 onesided=True, detrend_style=1, fft_backend=None,
                 raw=False, power=False):
    """Distributed STFT of ``x (nt,)`` over the ``'t'`` mesh axis.

    Real or complex input (complex rides as a stacked (re, im) pair and is
    normally analyzed two-sided, matching :func:`stft_segments`).  Returns
    host numpy ``(tt (navr,), freq, Xfft (navr, nfreq) complex)`` with the
    exact :func:`stft_segments` scaling contract.

    ``raw=True`` returns the Welch core's per-segment convention instead
    (full ``nfft`` bins, natural order, no coefficient scaling — the
    ``Xfft_seg`` contract of reference ``fft_analysis.py:391-393``); used
    by the distributed lazy segment fill so per-segment arrays never
    require the signal to fit one device.

    ``power=True`` reduces to ``|X|^2`` ON-DEVICE and gathers the real
    power grid instead of the complex pair — half the host/collective
    bytes, the right entry for spectrogram-shaped consumers (returns
    ``(tt, freq, P (navr, nfreq) real)``).
    """
    backend = resolve_fft_backend(fft_backend)
    tshards = mesh.shape["t"]
    hop = plan.nwins - plan.noverlap

    # zero-pad to a shard multiple: every valid segment ends within the
    # true span (plan construction), padded frames are masked out by the
    # g_ids < navr validity test, and nt_true keeps the detrend moments
    # exact — so any signal length welch_psd_sharded accepts works here
    # too (the lazy mesh segment fill depends on this)
    x_np = np.asarray(x)
    tvec = np.asarray(tvec, dtype=np.float64)
    nt_true = x_np.shape[-1]
    L = -(-nt_true // tshards) * tshards
    if L != nt_true:
        x_np = np.pad(x_np, (0, L - nt_true))
        tvec = np.pad(tvec, (0, L - nt_true))
    B, M = plan_shard_segments(L, plan.nwins, hop, plan.navr, tshards)

    win_np = np.asarray(win, dtype=np.float64)
    s1 = seg.get_s1(win_np)
    enbw = seg.get_enbw(fs, s1, seg.get_s2(win_np))

    # widest dtype the backend actually supports (f32 unless x64 is enabled)
    wdt = jax.dtypes.canonicalize_dtype(np.float64)
    cplx = np.iscomplexobj(x_np)
    if cplx:
        # stacked (re, im) pair — no complex dtype reaches the device
        x_np = np.stack([np.ascontiguousarray(x_np.real),
                         np.ascontiguousarray(x_np.imag)])
    kw = dict(navr=plan.navr, nwins=plan.nwins, nt_true=nt_true,
              hop=hop, nfft=plan.nfft, nnyquist=plan.nnyquist,
              onesided=bool(onesided), detrend_style=int(detrend_style),
              backend=backend, B=B, M=M, mesh_static=_MeshBox(mesh),
              cplx=cplx, raw=bool(raw), power=bool(power))
    args = (jnp.asarray(x_np, wdt), jnp.asarray(tvec, wdt),
            jnp.asarray(win_np), jnp.asarray(s1),
            jnp.asarray(np.sqrt(enbw)))
    with mesh:
        if power:
            Pw, tt, gid = _stft_sharded_jit(*args, **kw)
            Xr, Xi = np.asarray(Pw), None
        else:
            Xr, Xi, tt, gid = _stft_sharded_jit(*args, **kw)
            Xr, Xi = np.asarray(Xr), np.asarray(Xi)

    tt, gid = np.asarray(tt), np.asarray(gid)
    keep = gid >= 0
    order = np.argsort(gid[keep], kind="stable")
    X = (Xr[keep] if Xi is None else (Xr[keep] + 1j * Xi[keep]))[order]
    tt = tt[keep][order]
    nfreq = plan.nfft if raw else (plan.nnyquist if onesided
                                   else plan.nfft)
    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    if not raw:
        freq = (freq[:plan.nnyquist] if onesided
                else np.fft.fftshift(freq))
    assert X.shape == (plan.navr, nfreq)
    return tt, freq, X


def specgram_sharded(t, s, mesh, wl=512, hanning=True, overlap=True,
                     windowAverage=None, fft_backend=None):
    """Distributed simple spectrogram — the reference ``specgram``
    contract (``spectrogram.py:49-134``: per-window two-sided power
    ``|FFT(hanning * seg)|^2 / wl`` with the sqrt(8/3) Hann correction,
    hop ``wl/2`` with overlap, reference time-axis formulas) computed
    where the samples live.  Only the REAL ``(wl, nW)`` power grid is
    assembled on the host — half the bytes of gathering the complex STFT,
    the largest transfer of spectrogram-shaped outputs.

    Returns ``(time, fAxis, spectrogram[wl, nW])`` exactly like
    :func:`pyfft_tpu.spectrogram.specgram` (asserted in tests).
    """
    s = np.asarray(s).flatten()
    t = np.asarray(t)
    n = len(s)
    dt = np.abs(t[1] - t[0])
    wl = int(wl)
    if windowAverage is not None:
        overlap = False
    if overlap:
        nW = 2 * (n - (n % wl)) // wl - 1
        hop = wl // 2
    else:
        nW = (n - (n % wl)) // wl - 1
        hop = wl
    if nW < 1:
        raise ValueError(f"window length {wl} too long for {n} samples")
    win = np.hanning(wl) if hanning else np.ones(wl)

    plan = seg.SegmentPlan(nsig=n, nwins=wl, noverlap=wl - hop, navr=nW,
                           nfft=wl, nnyquist=wl // 2 + 1)
    _, _, Pw = stft_sharded(s.astype(np.float64), t.astype(np.float64),
                            win, plan, 1.0 / dt, mesh,
                            onesided=False, detrend_style=0,
                            fft_backend=fft_backend, raw=True, power=True)
    Pw = Pw / wl
    if hanning:
        Pw = np.sqrt(8.0 / 3.0) * Pw
    spectrogram_arr = Pw.T                                # (wl, nW)

    fAxis = np.fft.fftfreq(wl, dt)
    if windowAverage is not None:
        windowAverage = int(windowAverage)
        nA = nW // windowAverage
        avg = spectrogram_arr[:, :nA * windowAverage]
        avg = avg.reshape(wl, nA, windowAverage).mean(axis=-1)
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nA)
        return time, fAxis, avg
    if not overlap:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nW)
    else:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW / 2 - 1) + 1 / 2), num=nW)
    return time, fAxis, spectrogram_arr
