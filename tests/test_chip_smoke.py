"""chip_smoke.py on the CPU: every phase and the mesh checks at small
sizes, the refusal to run without a GPU, the compile-cache rule, and the
``__graft_entry__`` functions that share its mesh checks."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("name", sorted(chip_smoke.PHASES))
def test_phase_at_small_size(name, x64_off):
    r = chip_smoke.PHASES[name](n=1 << 14)
    assert r.ok, r.line()
    assert r.checks and len(r.walls) == 1 and r.samples > 0
    line = r.line()
    assert line.startswith(f"phase={name} ok") and "peak_bytes_in_use=" in line


@pytest.mark.parametrize("shapes", [[(1, 4), (2, 2)], [(2, 2), (1, 4)]])
def test_mesh_checks_on_four_virtual_devices(shapes, x64_off):
    logged = []
    rs = chip_smoke.mesh_checks(jax.devices()[:4], shapes, n=1 << 14,
                                n_long=1 << 12, nwins=256, ntaps=33,
                                log=logged.append)
    assert all(r.ok for r in rs), [r.line() for r in rs if not r.ok]
    names = [r.name for r in rs]
    for ch, t in shapes:
        assert f"fft_pwelch_mesh_{ch}x{t}" in names
        assert f"fir_filter_sharded_{ch}x{t}" in names
    tag = "{}x{}".format(*shapes[0])
    assert {f"specgram_sharded_{tag}", f"fft_sharded_{tag}",
            f"envelope_phase_mesh_{tag}"} <= set(names)
    # collective bytes per mesh and path, read from the compiled HLO
    assert len(logged) == 3 * len(shapes)
    assert all("bytes_per_device=" in s for s in logged)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"]])
def test_exits_nonzero_without_gpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_shape(monkeypatch, capsys, x64_off):
    """With a GPU reported, the last line is the one JSON result."""
    monkeypatch.setattr(chip_smoke, "card_info",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(chip_smoke, "use_compile_cache", lambda: "cache")
    ran = []

    def fake_phase(n=None, reps=1):
        ran.append(1)
        return chip_smoke.PhaseResult("fake", [("x", 0.0, 1.0)], 0.1, [0.01],
                                      samples=1)

    monkeypatch.setattr(chip_smoke, "PHASES", {"fake": fake_phase})
    assert chip_smoke.main([]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert out[-2] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    assert ran == [1]


def test_failed_phase_prints_no_result(monkeypatch, capsys, x64_off):
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "GPU, 700.00 W")
    monkeypatch.setattr(chip_smoke, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(chip_smoke, "use_compile_cache", lambda: "cache")
    monkeypatch.setattr(chip_smoke, "PHASES", {
        "bad": lambda: chip_smoke.PhaseResult("bad", [("x", 2.0, 1.0)],
                                              0.1, [0.01])})
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_exits_nonzero_with_float64_on(monkeypatch, capsys):
    """The phases check the float32 path; with x64 on they would compare
    float64 results with float64 references and prove nothing."""
    assert jax.config.jax_enable_x64
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "GPU, 700.00 W")
    monkeypatch.setattr(chip_smoke, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    ran = []
    monkeypatch.setattr(chip_smoke, "PHASES", {"p": lambda: ran.append(1)})
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert '"ok"' not in out and "float64 is on" in err and not ran


@pytest.mark.parametrize("environ,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/here"}, "/cache/here"),
    ({}, os.path.join("/checkout", ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join("/checkout",
                                                     ".jax_cache")),
])
def test_compile_cache_dir(environ, want):
    assert chip_smoke.compile_cache_dir(environ, root="/checkout") == want


def test_use_compile_cache_sets_fixed_path_only_without_env(monkeypatch,
                                                            tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = chip_smoke.use_compile_cache(root=str(tmp_path))
        assert got == os.path.join(str(tmp_path), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", before)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        assert chip_smoke.use_compile_cache(root="/elsewhere") == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_dryrun_multichip_on_virtual_devices(capsys):
    import __graft_entry__ as g
    g.dryrun_multichip(8)
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_entry_forward_step_jits():
    import numpy as np
    import __graft_entry__ as g
    forward, (x, y) = g.entry()
    Pxx, Pyy, Pxy = jax.jit(forward)(x, y)
    assert Pxx.shape == (512,) and Pyy.shape == Pxy.shape == (512, 4)
    assert np.all(np.isfinite(np.asarray(Pxy)))
