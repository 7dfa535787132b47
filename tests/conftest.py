"""Test configuration.

- Runs JAX on a virtual 8-device CPU platform (unless ``JAX_PLATFORMS``
  names another), so sharding tests run without accelerators.  Tests that
  need a GPU carry the ``gpu`` marker and take the ``gpu`` fixture, which
  skips them elsewhere; on a GPU machine run them with
  ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
- Enables float64 so parity tests against SciPy / the reference oracle are
  exact to ~1e-12.  Tests of the float32 path users run take the
  ``x64_off`` fixture.
- Puts the reference-oracle shim (tests/refshim) on sys.path: it loads the
  upstream reference sources with a minimal pybaseutils stand-in so golden
  parity tests can call the genuine reference implementation on CPU.
"""
import os
import sys

# NOTE: jax may already be imported when this file runs, and jax snapshots
# JAX_PLATFORMS at import time — so use jax.config.update, not os.environ.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("MPLBACKEND", "Agg")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "refshim"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def ref_fft():
    """The genuine reference fft_analysis module (CPU, via the shim)."""
    import FFT.fft_analysis as ref
    return ref


@pytest.fixture(scope="session")
def ref_windows():
    import FFT.windows as refw
    return refw


@pytest.fixture
def x64_off():
    """float64 off for the test, as users and ``chip_smoke.py`` run the
    float32 path; the session's setting comes back afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


@pytest.fixture
def gpu(x64_off):
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, when the test runs, never at import or collection.  The
    test runs with float64 off."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX runs on {dev.platform!r} (on a GPU "
                    "machine: JAX_PLATFORMS=cuda python -m pytest -m gpu "
                    "tests/)")
    return dev


@pytest.fixture(scope="session")
def ref_hilbert():
    import FFT.hilbert as refh
    return refh


@pytest.fixture(scope="session")
def ref_doppler():
    import FFT.Doppler as refd
    return refd
