"""Sharded == unsharded correctness on the virtual 8-device CPU mesh.

This is the distributed test strategy SURVEY §4 prescribes: halo-exchange
and psum-average results must match the single-device pipeline bit-for-bit
(up to float reassociation)."""
import numpy as np
import pytest
import jax

from pyfft_tpu import segmentation as seg
from pyfft_tpu import parallel as par
from pyfft_tpu import filters as flt
from pyfft_tpu.spectral import welch_cross_spectra


needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


def _sigs(nt=4096, nch=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(nt)
    y = (np.sin(2 * np.pi * 97.0 * t - 0.5)[None, :]
         * (1.0 + np.arange(nch))[:, None]
         + 0.1 * rng.standard_normal((nch, nt)))
    return t, x, y


@needs8
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (1, 1)])
@pytest.mark.parametrize("detrend", [0, 1, -1])
def test_sharded_welch_matches_single_device(mesh_shape, detrend):
    ch, tsh = mesh_shape
    t, x, y = _sigs()
    mesh = par.make_mesh(ch=ch, t=tsh)
    plan = seg.plan_segments(len(x), navr=64, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]
    fs = 1e3

    freq, Pxx, Pyy, Pxy = par.welch_psd_sharded(
        x, y, win, plan, fs, mesh, onesided=True, detrend_style=detrend)

    ref = welch_cross_spectra(x, y, win, plan, fs, onesided=True,
                              detrend_style=detrend)
    np.testing.assert_allclose(freq, np.asarray(ref["freq"]), atol=1e-12)
    np.testing.assert_allclose(Pxx, np.asarray(ref["Pxx"]).real,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Pyy.T, np.asarray(ref["Pyy"]).real,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Pxy.T, np.asarray(ref["Pxy"]),
                               rtol=1e-8, atol=1e-12)


@needs8
def test_sharded_welch_twosided():
    t, x, y = _sigs()
    mesh = par.make_mesh(ch=2, t=4)
    plan = seg.plan_segments(len(x), navr=48, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]
    freq, Pxx, Pyy, Pxy = par.welch_psd_sharded(
        x, y, win, plan, 1e3, mesh, onesided=False, detrend_style=1)
    ref = welch_cross_spectra(x, y, win, plan, 1e3, onesided=False,
                              detrend_style=1)
    np.testing.assert_allclose(Pxy.T, np.asarray(ref["Pxy"]),
                               rtol=1e-8, atol=1e-12)


@needs8
def test_sharded_welch_mxu_backend():
    """The distributed path with real-pair transforms (fft_backend='mxu')."""
    t, x, y = _sigs()
    mesh = par.make_mesh(ch=1, t=8)
    plan = seg.plan_segments(len(x), navr=64, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]
    f1, Pxx1, Pyy1, Pxy1 = par.welch_psd_sharded(
        x, y, win, plan, 1e3, mesh, fft_backend="mxu")
    f2, Pxx2, Pyy2, Pxy2 = par.welch_psd_sharded(
        x, y, win, plan, 1e3, mesh, fft_backend="xla")
    np.testing.assert_allclose(Pxx1, Pxx2, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(Pxy1, Pxy2, rtol=1e-7, atol=1e-10)


@needs8
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_fir_matches_oaconvolve(mesh_shape):
    ch, tsh = mesh_shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4096))
    taps = flt.firwin(101, 0.2)
    mesh = par.make_mesh(ch=ch, t=tsh)
    y = par.fir_filter_sharded(x, taps, mesh)
    ref = flt.fir_filter(x, taps)
    np.testing.assert_allclose(y, ref, rtol=1e-7, atol=1e-9)


@needs8
def test_sharded_fir_mxu_backend():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2048))
    taps = flt.firwin(51, 0.3)
    mesh = par.make_mesh(ch=1, t=8)
    y = par.fir_filter_sharded(x, taps, mesh, fft_backend="mxu")
    ref = flt.fir_filter(x, taps)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)  # f32 path


def test_plan_shard_segments_covers_all():
    plan = seg.plan_segments(4096, navr=64, windowoverlap=0.5)
    B, M = par.plan_shard_segments(4096, plan.nwins, plan.hop, plan.navr, 8)
    assert B == 512
    # every segment is owned by exactly one shard
    owners = [(g * plan.hop) // B for g in range(plan.navr)]
    assert len(owners) == plan.navr
    assert max(owners) < 8


def test_shard_errors():
    plan = seg.plan_segments(4096, navr=2, windowoverlap=0.0)
    with pytest.raises(ValueError, match="halo"):
        par.plan_shard_segments(4096, plan.nwins, plan.hop, plan.navr, 8)
    with pytest.raises(ValueError, match="divisible"):
        par.plan_shard_segments(4095, 16, 8, 10, 8)


def test_host_mesh_and_report():
    import jax
    from pyfft_tpu.parallel.runtime import (init_distributed,
                                            make_host_mesh, scaling_report)

    init_distributed()          # single-process no-op
    n = len(jax.devices())
    mesh = make_host_mesh(ch=2, t=n // 2)
    assert dict(mesh.shape) == {"host": 1, "ch": 2, "t": n // 2}
    rep = scaling_report(mesh)
    assert rep["devices"] == n
    # one host's GPUs are joined all to all: every 't' collective stays
    # intra-host; only the 'host' axis crosses the host network
    assert "intra-host" in rep["collectives"]["psum(welch average)"]
    assert "inter-host" in rep["collectives"]["all_gather(final spectra)"]

    import pytest
    with pytest.raises(ValueError):
        make_host_mesh(ch=3, t=n)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_stft_sharded_matches_single():
    from pyfft_tpu.parallel.stft import stft_sharded
    from pyfft_tpu.fftanal import stft_segments

    rng = np.random.default_rng(4)
    nt = 4096
    fs = 1e3
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 100 * t) + 0.1 * rng.standard_normal(nt)
    plan = seg.plan_segments(nt, nwins=256, windowoverlap=0.5)
    win = np.hanning(257)[:-1]
    mesh = par.make_mesh(ch=1, t=8)

    tt_s, freq_s, X_s = stft_sharded(x, t, win, plan, fs, mesh,
                                     onesided=True, detrend_style=1)
    tt_1, freq_1, X_1, pseg = stft_segments(x, t, win, plan, fs,
                                            onesided=True, detrend_style=1)
    np.testing.assert_allclose(freq_s, freq_1, rtol=1e-12)
    np.testing.assert_allclose(tt_s, np.asarray(tt_1), rtol=1e-12)
    np.testing.assert_allclose(X_s, np.asarray(X_1), rtol=1e-9, atol=1e-12)


@needs8
@pytest.mark.parametrize("tsh", [8, 4])
def test_fft_pwelch_mesh_matches_single_device(tsh):
    """VERDICT hard-part (e): the public API with a mesh must reproduce the
    single-device result including full-span reflect-extension."""
    from pyfft_tpu.spectral import fft_pwelch
    t, x, y = _sigs(nt=5000)            # odd length: exercises shard padding
    mesh = par.make_mesh(ch=1, t=tsh)
    f1, Pxy1, Pxx1, Pyy1, C1, phi1, info1 = fft_pwelch(
        t, x, y, Navr=16, plotit=False, verbose=False)   # full span: reflect
    f2, Pxy2, Pxx2, Pyy2, C2, phi2, info2 = fft_pwelch(
        t, x, y, Navr=16, plotit=False, verbose=False, mesh=mesh)
    np.testing.assert_allclose(f2, f1, atol=1e-12)
    np.testing.assert_allclose(Pxx2, Pxx1, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Pyy2, Pyy1, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Pxy2, Pxy1, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(phi2, phi1, rtol=1e-6, atol=1e-8)
    # per-segment arrays are lazy on the mesh path: first touch computes
    # them WHERE THE SAMPLES LIVE (sharded raw STFT, parallel/stft.py) —
    # never a single-device recompute — and must match the eager run
    assert "Pxx_seg" not in info2.__dict__
    np.testing.assert_allclose(np.asarray(info2.Pxx_seg),
                               np.asarray(info1.Pxx_seg),
                               rtol=1e-8, atol=1e-12)
    assert "Xfft_seg" in info2.__dict__  # fill populated every field
    sx = np.abs(np.asarray(info1.Xfft_seg)).max()
    np.testing.assert_allclose(np.asarray(info2.Xfft_seg),
                               np.asarray(info1.Xfft_seg),
                               atol=1e-9 * sx)
    np.testing.assert_allclose(np.asarray(info2.Yfft_seg),
                               np.asarray(info1.Yfft_seg),
                               atol=1e-9 * np.abs(
                                   np.asarray(info1.Yfft_seg)).max())
    np.testing.assert_allclose(np.asarray(info2.Pxy_seg),
                               np.asarray(info1.Pxy_seg),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(info2.Pyy_seg),
                               np.asarray(info1.Pyy_seg),
                               rtol=1e-8, atol=1e-12)


@needs8
def test_fft_pwelch_mesh_subspan_and_linear_detrend():
    from pyfft_tpu.spectral import fft_pwelch
    t, x, y = _sigs(nt=4096)
    x = x + 0.25 * np.linspace(0, 3.0, len(t))          # trend
    mesh = par.make_mesh(ch=2, t=4)
    kw = dict(tbounds=[t[7], t[-9]], Navr=12, detrend_style=-1,
              plotit=False, verbose=False)
    r1 = fft_pwelch(t, x, y, **kw)
    r2 = fft_pwelch(t, x, y, mesh=mesh, **kw)
    np.testing.assert_allclose(r2[2], r1[2], rtol=1e-8, atol=1e-12)  # Pxx
    np.testing.assert_allclose(r2[1], r1[1], rtol=1e-8, atol=1e-12)  # Pxy


@needs8
def test_fft_pwelch_mesh_ntmodel():
    """nT-model (len(sigx) != len(sigy)): x is a one-window model that is
    broadcast against every segment of y (reference fft_analysis.py:170)."""
    from pyfft_tpu.spectral import fft_pwelch
    rng = np.random.default_rng(5)
    nt, nwins = 4096, 512
    t = np.arange(nt) / 1e3
    model = np.sin(2 * np.pi * 97.0 * t[:nwins])
    y = (np.sin(2 * np.pi * 97.0 * t - 0.3)
         + 0.1 * rng.standard_normal(nt))
    mesh = par.make_mesh(ch=1, t=8)
    kw = dict(tbounds=[t[1], t[-2]], windowoverlap=0.5, plotit=False,
              verbose=False)
    r1 = fft_pwelch(t, model, y, **kw)
    r2 = fft_pwelch(t, model, y, mesh=mesh, **kw)
    np.testing.assert_allclose(r2[2], r1[2], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r2[1], r1[1], rtol=1e-8, atol=1e-12)


def _iq_sigs(nt=4096, nch=2, seed=9):
    """Complex IQ-style signals (the Doppler configuration)."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) / 1e3
    z = (np.exp(1j * 2 * np.pi * 83.0 * t)
         + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    y = (np.exp(1j * (2 * np.pi * 83.0 * t - 0.4))[None, :]
         * (1.0 + np.arange(nch))[:, None]
         + 0.1 * (rng.standard_normal((nch, nt))
                  + 1j * rng.standard_normal((nch, nt))))
    return t, z, y


@needs8
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("backend", ["xla", "mxu"])
def test_sharded_welch_complex_twosided(mesh_shape, backend):
    """Complex signals on the distributed path (stacked re/im pairs) must
    reproduce the single-device two-sided spectra — the sharded analogue
    of the reference's complex branch (fft_analysis.py:423-427)."""
    ch, tsh = mesh_shape
    t, z, y = _iq_sigs()
    mesh = par.make_mesh(ch=ch, t=tsh)
    plan = seg.plan_segments(len(z), navr=48, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]
    freq, Pxx, Pyy, Pxy = par.welch_psd_sharded(
        z, y, win, plan, 1e3, mesh, onesided=False, detrend_style=1,
        fft_backend=backend)
    ref = welch_cross_spectra(z, y, win, plan, 1e3, onesided=False,
                              detrend_style=1, fft_backend="xla")
    tol = dict(rtol=1e-8, atol=1e-12) if backend == "xla" else \
        dict(rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(freq, np.asarray(ref["freq"]), atol=1e-12)
    np.testing.assert_allclose(Pxx, np.asarray(ref["Pxx"]).real, **tol)
    np.testing.assert_allclose(Pyy.T, np.asarray(ref["Pyy"]).real, **tol)
    np.testing.assert_allclose(Pxy.T, np.asarray(ref["Pxy"]), **tol)


@needs8
def test_fft_pwelch_mesh_complex_matches_single_device():
    """The public API with a mesh on complex input (defaults to two-sided)
    — config 5's 'channels sharded across hosts' Doppler-IQ intent."""
    from pyfft_tpu.spectral import fft_pwelch
    t, z, y = _iq_sigs(nt=5000)         # odd length: exercises shard padding
    mesh = par.make_mesh(ch=2, t=4)
    r1 = fft_pwelch(t, z, y, Navr=16, plotit=False, verbose=False)
    r2 = fft_pwelch(t, z, y, Navr=16, plotit=False, verbose=False,
                    mesh=mesh)
    np.testing.assert_allclose(r2[0], r1[0], atol=1e-12)            # freq
    np.testing.assert_allclose(r2[2], r1[2], rtol=1e-8, atol=1e-12)  # Pxx
    np.testing.assert_allclose(r2[3], r1[3], rtol=1e-8, atol=1e-12)  # Pyy
    np.testing.assert_allclose(r2[1], r1[1], rtol=1e-8, atol=1e-12)  # Pxy
    np.testing.assert_allclose(r2[5], r1[5], rtol=1e-6, atol=1e-8)   # phase
    # the sharded lazy segment fill must also cover the complex/two-sided
    # configuration (stft_sharded raw mode rides stacked re/im pairs)
    info1, info2 = r1[6], r2[6]
    assert "Xfft_seg" not in info2.__dict__
    sx = np.abs(np.asarray(info1.Xfft_seg)).max()
    np.testing.assert_allclose(np.asarray(info2.Xfft_seg),
                               np.asarray(info1.Xfft_seg),
                               atol=1e-9 * sx)
    np.testing.assert_allclose(np.asarray(info2.Pxy_seg),
                               np.asarray(info1.Pxy_seg),
                               atol=1e-9 * np.abs(np.asarray(
                                   info1.Pxy_seg)).max())


@needs8
def test_collective_audit_and_scaling_projection():
    """The HLO collective audit must see exactly the collectives the design
    calls for (halo ppermute + Welch psum, SURVEY §2.3; all-to-alls in the
    four-step FFT), with byte volumes that follow the shapes."""
    nwins, nch = 1024, 4
    mesh = par.make_mesh(ch=1, t=8)
    r = par.audit_mesh_paths(mesh, nt=1 << 18, nch=nch, nwins=nwins,
                             ntaps=33, fft_n=1 << 14)
    ops = {c["op"] for c in r["welch"]}
    assert "collective-permute" in ops          # segment halos
    assert "all-reduce" in ops                  # Welch psum / detrend moments
    halo = sum(c["bytes"] for c in r["welch"]
               if c["op"] == "collective-permute")
    # x halo + y halos: (nwins - 1) f32 samples for the reference and
    # each channel
    assert halo >= (nwins - 1) * (nch + 1) * 4
    fir_ops = {c["op"] for c in r["fir"]}
    assert fir_ops == {"collective-permute"}    # FIR halo only
    assert sum(c["bytes"] for c in r["fir"]) == (33 - 1) * nch * 4
    a2a = [c for c in r["fft4step"] if c["op"] == "all-to-all"]
    assert len(a2a) >= 3 and all(c["bytes"] > 0 for c in a2a)
    # a 2x4 mesh halves the per-device channel block: FIR halo bytes halve
    r2 = par.audit_mesh_paths(par.make_mesh(ch=2, t=4), nt=1 << 18,
                              nch=nch, nwins=nwins, ntaps=33)
    assert sum(c["bytes"] for c in r2["fir"]) == (33 - 1) * (nch // 2) * 4


@needs8
def test_stft_sharded_complex_twosided():
    """Complex input on the distributed STFT (stacked re/im pair) must
    match the single-device stft_segments two-sided contract."""
    from pyfft_tpu.parallel.stft import stft_sharded
    from pyfft_tpu.fftanal import stft_segments
    rng = np.random.default_rng(8)
    nt, fs = 4096, 1e3
    t = np.arange(nt) / fs
    z = (np.exp(1j * 2 * np.pi * 83.0 * t)
         + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    plan = seg.plan_segments(nt, nwins=256, windowoverlap=0.5)
    win = np.hanning(257)[:-1]
    mesh = par.make_mesh(ch=1, t=8)
    tt_s, freq_s, X_s = stft_sharded(z, t, win, plan, fs, mesh,
                                     onesided=False, detrend_style=1)
    tt_1, freq_1, X_1, _ = stft_segments(z, t, win, plan, fs,
                                         onesided=False, detrend_style=1)
    np.testing.assert_allclose(freq_s, freq_1, rtol=1e-12)
    np.testing.assert_allclose(X_s, np.asarray(X_1), rtol=1e-9, atol=1e-12)


@needs8
@pytest.mark.parametrize("kwargs", [dict(), dict(hanning=False),
                                    dict(overlap=False),
                                    dict(windowAverage=3)])
def test_specgram_sharded_matches_single(kwargs):
    """The distributed simple spectrogram must reproduce
    spectrogram.specgram exactly (same frames, two-sided power, Hann
    correction, time-axis formulas) while gathering only the real power
    grid."""
    from pyfft_tpu.spectrogram import specgram
    from pyfft_tpu.parallel.stft import specgram_sharded
    rng = np.random.default_rng(6)
    nt, fs = 6000, 1e3                  # non-multiple of wl AND of shards
    t = np.arange(nt) / fs
    s = np.sin(2 * np.pi * 120.0 * t) + 0.1 * rng.standard_normal(nt)
    mesh = par.make_mesh(ch=1, t=8)
    tm1, f1, P1 = specgram(t, s, wl=256, **kwargs)
    tm2, f2, P2 = specgram_sharded(t, s, mesh, wl=256, **kwargs)
    np.testing.assert_allclose(f2, f1, atol=1e-12)
    np.testing.assert_allclose(tm2, tm1, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(P2), np.asarray(P1),
                               rtol=1e-8, atol=1e-10 * np.max(P1))


@needs8
def test_stft_sharded_power_mode():
    """power=True must equal |stft_sharded|^2 with a real result."""
    from pyfft_tpu.parallel.stft import stft_sharded
    rng = np.random.default_rng(7)
    nt, fs = 4096, 1e3
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 100 * t) + 0.1 * rng.standard_normal(nt)
    plan = seg.plan_segments(nt, nwins=256, windowoverlap=0.5)
    win = np.hanning(257)[:-1]
    mesh = par.make_mesh(ch=1, t=8)
    _, _, X = stft_sharded(x, t, win, plan, fs, mesh)
    _, _, P = stft_sharded(x, t, win, plan, fs, mesh, power=True)
    assert not np.iscomplexobj(P)
    np.testing.assert_allclose(P, np.abs(X) ** 2, rtol=1e-10,
                               atol=1e-12 * np.max(np.abs(X) ** 2))


@needs8
@pytest.mark.parametrize("detrend", [1, -1])
def test_stft_sharded_non_divisible_length(detrend):
    """A span whose length is not a multiple of the shard count must work
    (internal zero-padding) with EXACT detrend moments (nt_true) — the
    lazy mesh segment fill depends on this (round-5 review finding)."""
    from pyfft_tpu.parallel.stft import stft_sharded
    from pyfft_tpu.fftanal import stft_segments
    rng = np.random.default_rng(8)
    nt, fs = 4999, 1e3                  # 4999 % 8 != 0
    t = np.arange(nt) / fs
    x = (np.sin(2 * np.pi * 100 * t) + 0.3
         + 0.1 * rng.standard_normal(nt))
    plan = seg.plan_segments(nt, nwins=256, windowoverlap=0.5)
    win = np.hanning(257)[:-1]
    mesh = par.make_mesh(ch=1, t=8)
    tt_s, fq_s, X_s = stft_sharded(x, t, win, plan, fs, mesh,
                                   detrend_style=detrend)
    tt_1, fq_1, X_1, _ = stft_segments(x, t, win, plan, fs,
                                       detrend_style=detrend)
    np.testing.assert_allclose(tt_s, np.asarray(tt_1), rtol=1e-12)
    np.testing.assert_allclose(X_s, np.asarray(X_1), rtol=1e-9,
                               atol=1e-10 * np.abs(np.asarray(X_1)).max())


@needs8
def test_mesh_segment_fill_non_divisible_span():
    """fft_pwelch(mesh=...) whose analyzed span is not a shard multiple:
    the sharded lazy fill must still produce the per-segment arrays
    (round-5 review finding — it raised ValueError before)."""
    from pyfft_tpu.spectral import fft_pwelch
    t, x, y = _sigs(nt=4996)            # reflect-extended span % 8 != 0
    mesh = par.make_mesh(ch=1, t=8)
    kw = dict(tbounds=[t[3], t[-5]], Navr=16, plotit=False, verbose=False)
    r1 = fft_pwelch(t, x, y, **kw)
    r2 = fft_pwelch(t, x, y, mesh=mesh, **kw)
    np.testing.assert_allclose(r2[2], r1[2], rtol=1e-8, atol=1e-12)
    info1, info2 = r1[6], r2[6]
    np.testing.assert_allclose(
        np.asarray(info2.Xfft_seg), np.asarray(info1.Xfft_seg),
        atol=1e-9 * np.abs(np.asarray(info1.Xfft_seg)).max())


def test_audit_collectives_counts_async_pairs_once():
    """GPU HLO splits collectives into -start/-done pairs: each is counted
    once, from the -done result (the -start tuple holds buffers and
    contexts, not payload)."""
    hlo = "\n".join([
        "%ars = f32[8,1024]{1,0} all-reduce-start(f32[8,1024]{1,0} %x), "
        "replica_groups={{0,1}}",
        "%ard = f32[8,1024]{1,0} all-reduce-done(f32[8,1024]{1,0} %ars)",
        "%cps = (f32[4095]{0}, f32[4095]{0}, u32[], u32[]) "
        "collective-permute-start(f32[4095]{0} %h), "
        "source_target_pairs={{0,1}}",
        "%cpd = f32[4095]{0} collective-permute-done((f32[4095]{0}, "
        "f32[4095]{0}, u32[], u32[]) %cps)",
        "%a2a = f32[4,256]{1,0} all-to-all(f32[4,256]{1,0} %z), "
        "dimensions={0}",
    ])
    rows = par.audit_collectives(hlo)
    assert [(r["op"], r["bytes"]) for r in rows] == [
        ("all-reduce", 8 * 1024 * 4), ("collective-permute", 4095 * 4),
        ("all-to-all", 4 * 256 * 4)]
