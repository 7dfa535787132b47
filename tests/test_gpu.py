"""Checks that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run on a GPU machine with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.  ``chip_smoke.py`` drives the same paths at full size.
"""
import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_device_peaks_on_card(gpu):
    from pyfft_tpu.utils.profiling import device_peaks
    assert device_peaks() == device_peaks(gpu.device_kind)


@pytest.mark.parametrize("name", ["welch_psd", "envelope_phase", "fir"])
def test_phase_on_card(gpu, name):
    import chip_smoke
    r = chip_smoke.PHASES[name](n=1 << 20)
    assert r.ok, r.line()


def test_envelope_phase_runs_on_card(gpu):
    import jax
    import jax.numpy as jnp
    from pyfft_tpu.hilbert import _envelope_phase_dev
    u = jax.device_put(np.random.default_rng(0).standard_normal(
        1 << 16).astype(np.float32), gpu)
    env, ph = _envelope_phase_dev(u, nfft=1 << 16, axis=-1)
    assert env.devices() == {gpu} and bool(jnp.all(jnp.isfinite(ph)))
