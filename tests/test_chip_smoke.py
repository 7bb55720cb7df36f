"""chip_smoke.py off the card: it refuses to run without a GPU, and its
one-card phase functions run at tiny shapes on the CPU (accuracy bounds
relaxed — they hold at the real shapes only).  Also the helpers it rests
on: the compile-cache rule, the device-memory reading and the band choice."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.parallel import streamed
from stereo_match_traditional_tpu.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (32, 44, 10)
ANY = {k: 1.0 for k in chip_smoke.REFERENCE_BAD2}


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_exits_nonzero_without_gpu():
    out = _run_script(os.path.join(_REPO, "chip_smoke.py"), _REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _records(phase):
    recs = list(phase)
    assert recs and all("phase" in r for r in recs)
    return recs


def test_phase_reference_paths_tiny():
    recs = _records(chip_smoke.phase_reference_paths(TINY, ANY))
    assert [r["phase"] for r in recs] == [
        f"reference/{n}" for n in chip_smoke.REFERENCE_BAD2]
    for r in recs:
        assert r["compile_s"] >= 0 and r["run_s"] > 0
        assert r["memory_analysis"]["temp_size_in_bytes"] >= 0


def test_phase_full_tiny():
    _records(chip_smoke.phase_full(TINY, bound=None))


def test_phase_cli_tiny():
    (rec,) = _records(chip_smoke.phase_cli(TINY, bound=1.0))
    assert rec["summary"]["shape"] == [TINY[0], TINY[1]]


def test_phase_batched_tiny():
    (rec,) = _records(chip_smoke.phase_batched(TINY, batch=2, bound=1.0))
    assert rec["mismatch_vs_direct"] <= chip_smoke.TIE_FLIP


def test_phase_canonical_tiny():
    _records(chip_smoke.phase_canonical(TINY, bound=1.0))


def test_phase_streamed_tiny():
    (rec,) = _records(chip_smoke.phase_streamed((37, 48, 8), row_tile=16))
    assert rec["row_tile"] == 16


def test_phase_asw_kernel_tiny_interpreted():
    recs = _records(chip_smoke.phase_asw_kernel(
        (14, 18, 5), win_size=2, time_shapes=(), interpret=True))
    assert [r["phase"] for r in recs] == ["asw_kernel/left", "asw_kernel/right"]


def test_phase_asw_grid_tiny():
    _records(chip_smoke.phase_asw_grid(TINY, bound=1.0))


def test_phase_matmul_exactness_tiny():
    recs = _records(chip_smoke.phase_matmul_exactness(TINY))
    assert all(r["max_abs_err"] <= 0.5 for r in recs)


def test_check_raises_smoke_failure():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")


def test_compile_cache_follows_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.configure_compile_cache() == "/elsewhere/cache"
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure_compile_cache()
    assert got == compile_cache.CACHE_DIR == os.path.join(_REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", got)]
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_concurrently_compiles_every_job():
    import jax.numpy as jnp

    x = jnp.arange(4.0)
    double = jax.jit(lambda v: v * 2)
    inc = jax.jit(lambda v: v + 1)
    secs = compile_cache.compile_concurrently([(double, (x,)), (inc, (x,))])
    assert len(secs) == 2 and all(t >= 0 for t in secs)
    assert compile_cache.compile_concurrently([]) == []
    assert list(double(x)) == [0.0, 2.0, 4.0, 6.0]
    assert list(inc(x)) == [1.0, 2.0, 3.0, 4.0]


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_bytes_raises_without_stats():
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        streamed._device_memory_bytes(_FakeDevice("gpu", None))
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        streamed._device_memory_bytes(_FakeDevice("gpu", {"bytes_in_use": 1}))


def test_device_memory_bytes_reads_limit_and_cpu_host():
    assert streamed._device_memory_bytes(
        _FakeDevice("gpu", {"bytes_limit": 60 * 2**30})) == 60 * 2**30
    assert streamed._device_memory_bytes(_FakeDevice("cpu", None)) > 0


def _small_memory(monkeypatch, nbytes):
    monkeypatch.setattr(streamed, "_device_memory_bytes", lambda dev=None: nbytes)


def test_phase_streamed_uses_the_auto_row_tile_band(monkeypatch):
    """Without ``row_tile`` the phase reports the band ``auto_row_tile``
    picks from the device memory, the one ``streamed_pipeline`` runs."""
    h, w, d = 40, 48, 8
    cfg = chip_smoke._full_cfg(d)
    # room for a 16-row band at this width: 6 live band volumes + halo part
    halo = streamed.receptive_field_rows("ad_census", cfg)
    _small_memory(monkeypatch, (6 * 16 + 12 * halo) * d * w * 4.0 / 0.70 + 1)
    assert streamed.auto_row_tile("ad_census", cfg, h, w) == 16
    (rec,) = _records(chip_smoke.phase_streamed((h, w, d)))
    assert rec["row_tile"] == 16


def test_streamed_pipeline_default_band_is_auto_row_tile(monkeypatch):
    """``row_tile=None`` runs the band ``auto_row_tile`` names, and gives
    the same maps as that band passed explicitly."""
    import numpy as np

    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    cfg = cfgs.SADConfig(max_disparity=4, winsize=1)
    L, R, _ = make_pair(40, 32, 4, seed=0)
    halo = streamed.receptive_field_rows("sad", cfg)
    _small_memory(monkeypatch, (4 * 16 + 8 * halo) * 4 * 32 * 4.0 / 0.70 + 1)
    picks = []
    real = streamed.auto_row_tile
    monkeypatch.setattr(streamed, "auto_row_tile",
                        lambda *a, **k: picks.append(real(*a, **k)) or picks[-1])
    auto = jax.jit(streamed.streamed_pipeline("sad", cfg))(L, R)
    assert picks == [16]
    fixed = jax.jit(streamed.streamed_pipeline("sad", cfg, 16))(L, R)
    np.testing.assert_array_equal(np.asarray(auto.disp_left),
                                  np.asarray(fixed.disp_left))
