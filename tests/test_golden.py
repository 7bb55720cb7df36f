"""Golden regression tests: frozen disparity outputs for all five pipelines.

Guards behavior across refactors/optimization passes — these arrays were
produced by the oracle-validated implementations (every stage has its own
unit test against `tests/oracles.py`); any future change that shifts a
single pixel of any pipeline output fails here and must either be a bug or
consciously regenerate the goldens (see the generation snippet in git
history, commit message of this file).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.utils.synthetic import make_pair

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipelines_seed42.npz")

_CASES = {
    "sad": cfgs.SADConfig(max_disparity=10, winsize=1, run_post=True),
    "ncc": cfgs.NCCConfig(disp_range=10, win_size=3),
    "asw": cfgs.ASWConfig(disp_range=10, win_size=2, run_post=True, use_pallas=False),
    "ad_census": cfgs.ADCensusConfig(
        disp_range=10, scanline=cfgs.ScanlineConfig(), run_post=True
    ),
    "cblsm": cfgs.CBLSMConfig(disp_range=10, run_post=True),
}


@pytest.fixture(scope="module")
def golden():
    return np.load(_GOLDEN)


def _check_golden(prefix, res, golden):
    checked = 0
    for field in res._fields:
        key = f"{prefix}/{field}"
        if key not in golden.files:
            continue
        got = np.asarray(getattr(res, field))
        want = golden[key]
        # exact equality, treating equal-position infs as equal
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=key)
        np.testing.assert_allclose(
            got[finite], want[finite], rtol=0, atol=1e-5, err_msg=key
        )
        checked += 1
    assert checked >= 1, prefix


@pytest.mark.parametrize("name", sorted(_CASES))
def test_pipeline_matches_golden(name, golden):
    L, R, _ = make_pair(48, 64, 10, seed=42)
    fn, _ = get_pipeline(name)
    res = fn(jnp.asarray(L), jnp.asarray(R), _CASES[name])
    _check_golden(name, res, golden)


# --------------------------------------------------------------------------
# Quirk-flag goldens: every catalogued reference quirk
# flag gets its own frozen output so a regression in a non-default path
# trips the golden net.  Regenerate: python tests/golden/generate_quirks.py
# --------------------------------------------------------------------------

_QUIRKS = os.path.join(os.path.dirname(__file__), "golden", "quirks_seed42.npz")


@pytest.fixture(scope="module")
def quirk_golden():
    return np.load(_QUIRKS)


def _quirk_cases():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    import generate_quirks

    return generate_quirks.quirk_cases(), generate_quirks.lab_cases()


@pytest.mark.parametrize(
    "idx,case_id",
    [(0, "adc_vertical_l2"), (1, "adc_vertical_p2"), (2, "ncc_sentinel"),
     (3, "cblsm_own_arms"), (4, "adc_cross_two_pass")],
)
def test_quirk_flag_matches_golden(idx, case_id, quirk_golden):
    cases, _ = _quirk_cases()
    name, pipe, cfg, kw = cases[idx]
    assert name == case_id
    L, R, _ = make_pair(48, 64, 10, seed=42)
    fn, _ = get_pipeline(pipe)
    res = fn(jnp.asarray(L), jnp.asarray(R), cfg, **kw)
    _check_golden(name, res, quirk_golden)


@pytest.mark.parametrize("idx,case_id", [(0, "asw_lab"), (1, "asw_lab_faithful_lut")])
def test_lab_variant_matches_golden(idx, case_id, quirk_golden):
    _, lab = _quirk_cases()
    name, pipe, cfg, kw, gl, gr = lab[idx]
    assert name == case_id
    fn, _ = get_pipeline(pipe)
    res = fn(jnp.asarray(gl), jnp.asarray(gr), cfg, **kw)
    _check_golden(name, res, quirk_golden)
