"""Worker process for the multi-process distributed correctness test.

Launched by ``tests/test_distributed.py`` as N separate Python processes
(CPU backend, 4 virtual devices each).  Every process initializes the JAX
distributed runtime against a shared coordinator, builds ONE global
``('ch','t')`` mesh whose time axis spans all processes, runs the sharded
Welch estimator (halo ppermute + psum now crossing process boundaries),
and checks the result against the locally-computed single-device pipeline.

Exit code 0 + the line ``DISTRIBUTED-OK`` signal success.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import numpy as np  # noqa: E402


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import jax
    # jax may already be imported with another platform; the config API
    # overrides the snapshotted env
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    import pyfft_tpu.parallel as par
    from pyfft_tpu import segmentation as seg
    from pyfft_tpu.spectral import welch_cross_spectra

    ndev = len(jax.devices())
    assert ndev == 4 * nproc, f"expected {4 * nproc} global devices, {ndev}"
    assert jax.process_count() == nproc

    rng = np.random.default_rng(0)          # same data in every process
    nt, nch = 1 << 14, 2
    x = rng.standard_normal(nt)
    y = rng.standard_normal((nch, nt))
    plan = seg.plan_segments(nt, navr=64, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]

    mesh = par.make_mesh(ch=1, t=ndev)      # time axis spans both processes
    freq, Pxx, Pyy, Pxy = par.welch_psd_sharded(
        x, y, win, plan, 1e3, mesh, detrend_style=1)

    ref = welch_cross_spectra(x, y, win, plan, 1e3, detrend_style=1)
    np.testing.assert_allclose(Pxx, np.asarray(ref["Pxx"]).real,
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(Pyy.T, np.asarray(ref["Pyy"]).real,
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(Pxy.T, np.asarray(ref["Pxy"]),
                               rtol=1e-5, atol=1e-8)

    # complex/two-sided (Doppler-IQ) path: (re, im) channel pairs, halo
    # ppermute + psum still crossing the process boundary
    t = np.arange(nt) / 1e3
    zc = (np.exp(1j * 2 * np.pi * 83.0 * t)
          + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    yc = (np.exp(1j * (2 * np.pi * 83.0 * t - 0.4))[None]
          + 0.1 * (rng.standard_normal((1, nt))
                   + 1j * rng.standard_normal((1, nt))))
    _, Pxx_c, _, Pxy_c = par.welch_psd_sharded(
        zc, yc, win, plan, 1e3, mesh, onesided=False, detrend_style=1)
    ref_c = welch_cross_spectra(zc, yc, win, plan, 1e3, onesided=False,
                                detrend_style=1)
    sc = np.abs(np.asarray(ref_c["Pxx"])).max()
    np.testing.assert_allclose(Pxx_c, np.asarray(ref_c["Pxx"]).real,
                               rtol=1e-4, atol=1e-6 * sc)
    np.testing.assert_allclose(Pxy_c.T, np.asarray(ref_c["Pxy"]),
                               rtol=1e-4, atol=1e-6 * sc)
    print(f"DISTRIBUTED-OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
