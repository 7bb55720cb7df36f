"""Per-stage observability + stage checkpoints (SURVEY.md §5 rows
"Tracing/profiling" and "Checkpoint/resume")."""

import json
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.models.registry import finish_from_volumes
from stereo_match_traditional_tpu.utils import checkpoint
from stereo_match_traditional_tpu.utils.synthetic import make_pair

_CFGS = {
    "sad": cfgs.SADConfig(max_disparity=8, winsize=1, run_post=True),
    "ncc": cfgs.NCCConfig(disp_range=8, win_size=3),
    "asw": cfgs.ASWConfig(disp_range=8, win_size=2, use_pallas=False),
    "ad_census": cfgs.ADCensusConfig(disp_range=8),
    "cblsm": cfgs.CBLSMConfig(disp_range=8),
}


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_stage_scopes_visible_in_hlo(name):
    """jax.named_scope stages must survive into the compiled program's
    metadata — that is what makes an XProf trace show named stages."""
    L, R, _ = make_pair(32, 48, 8, seed=0)
    fn, _ = get_pipeline(name)
    cfg = _CFGS[name]
    lowered = jax.jit(lambda l, r: fn(l, r, cfg)).lower(
        jnp.asarray(L), jnp.asarray(R)
    )
    text = lowered.as_text(debug_info=True)
    assert "stereo/cost_volume" in text, name
    assert "stereo/wta" in text, name


@pytest.mark.parametrize(
    "name",
    [n if n == "ncc" else pytest.param(n, marks=pytest.mark.slow)
     for n in sorted(_CFGS)],
)
def test_return_stages_and_reentry(name):
    """return_stages=True yields the stage volumes, and re-entering at the
    WTA stage from them reproduces the maps bit-for-bit."""
    L, R, _ = make_pair(32, 48, 8, seed=1)
    fn, _ = get_pipeline(name)
    cfg = _CFGS[name]
    res, stages = fn(jnp.asarray(L), jnp.asarray(R), cfg, return_stages=True)
    assert "cost_left" in stages
    vol_l = stages.get("aggregated_left", stages["cost_left"])
    vol_r = stages.get("aggregated_right", stages.get("cost_right"))
    re = finish_from_volumes(name, vol_l, vol_r, cfg)
    for field in res._fields:
        a, b = getattr(res, field), getattr(re, field)
        assert (a is None) == (b is None), (name, field)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


def test_stage_checkpoint_roundtrip(tmp_path):
    """Volumes written by save_array re-enter through load_array."""
    L, R, _ = make_pair(32, 48, 8, seed=2)
    fn, _ = get_pipeline("ad_census")
    cfg = _CFGS["ad_census"]
    res, stages = fn(jnp.asarray(L), jnp.asarray(R), cfg, return_stages=True)
    for k, v in stages.items():
        checkpoint.save_array(str(tmp_path), k, v)
    re = finish_from_volumes(
        "ad_census",
        checkpoint.load_array(str(tmp_path), "aggregated_left"),
        checkpoint.load_array(str(tmp_path), "aggregated_right"),
        cfg,
    )
    np.testing.assert_array_equal(np.asarray(res.disp_left), np.asarray(re.disp_left))


@pytest.mark.slow
def test_cli_save_stages_includes_volumes(tmp_path):
    """`stereo run --save-stages` must persist the aggregated volume
    (the stage re-entry surface needs it)."""
    out = subprocess.run(
        [
            sys.executable, "-m", "stereo_match_traditional_tpu.cli", "--cpu",
            "run", "ad_census", "--synthetic", "32x48", "--disp-range", "8",
            "--save-stages", str(tmp_path),
        ],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert checkpoint.has_stage(str(tmp_path), "aggregated_left"), out.stderr
    assert checkpoint.has_stage(str(tmp_path), "cost_left")
    summary = json.loads(out.stdout)
    assert "stages_ms" in summary
