"""End-to-end pipeline tests: golden accuracy on synthetic pairs.

The reference publishes no outputs, so the golden standard is
(a) oracle equality at the kernel level (other test files) and (b) bad-2.0
accuracy against synthetic ground truth here.
"""

import jax
import numpy as np
import pytest

from stereo_match_traditional_tpu.config import (
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    CrossArmConfig,
    NCCConfig,
    SADConfig,
    ScanlineConfig,
)
from stereo_match_traditional_tpu.models import (
    ad_census_pipeline,
    asw_pipeline,
    cblsm_pipeline,
    get_pipeline,
    ncc_pipeline,
    sad_pipeline,
)
from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate


def test_sad_accuracy(small_pair):
    L, R, gt = small_pair
    cfg = SADConfig(max_disparity=14, winsize=2)
    res = jax.jit(lambda l, r: sad_pipeline(l, r, cfg))(L, R)
    assert bad_pixel_rate(np.asarray(res.disp_left), gt) < 0.15


def test_sad_full_post(small_pair):
    L, R, gt = small_pair
    cfg = SADConfig(max_disparity=14, winsize=2, compute_right=True, run_post=True)
    res = jax.jit(lambda l, r: sad_pipeline(l, r, cfg))(L, R)
    assert res.disp_right is not None and res.disp_final is not None
    final = np.asarray(res.disp_final)
    assert np.isfinite(final).mean() > 0.95


def test_ncc_accuracy(small_pair):
    L, R, gt = small_pair
    cfg = NCCConfig(disp_range=14, win_size=3)
    res = jax.jit(lambda l, r: ncc_pipeline(l, r, cfg))(L, R)
    d = np.asarray(res.disp_left)
    w = d.shape[1]
    inner = slice(4, -4)
    assert bad_pixel_rate(d[inner, 6:], gt[inner, 6:]) < 0.35


def test_asw_accuracy(small_pair):
    L, R, gt = small_pair
    cfg = ASWConfig(disp_range=14, win_size=3, run_post=False)
    res = jax.jit(lambda l, r: asw_pipeline(l, r, cfg))(L, R)
    assert bad_pixel_rate(np.asarray(res.disp_left), gt) < 0.15


def test_ad_census_accuracy(small_pair):
    L, R, gt = small_pair
    cfg = ADCensusConfig(disp_range=14)
    res = jax.jit(lambda l, r: ad_census_pipeline(l, r, cfg))(L, R)
    assert bad_pixel_rate(np.asarray(res.disp_left), gt) < 0.15


@pytest.mark.slow
def test_ad_census_scanline_improves_or_holds(small_pair):
    L, R, gt = small_pair
    base = ADCensusConfig(disp_range=14)
    full = ADCensusConfig(disp_range=14, scanline=ScanlineConfig(), run_post=True)
    r0 = jax.jit(lambda l, r: ad_census_pipeline(l, r, base))(L, R)
    r1 = jax.jit(lambda l, r: ad_census_pipeline(l, r, full))(L, R)
    b0 = bad_pixel_rate(np.asarray(r0.disp_left), gt)
    b1 = bad_pixel_rate(np.asarray(r1.disp_left), gt)
    assert b1 <= b0 + 0.02
    assert r1.disp_final is not None


def test_cblsm_accuracy(small_pair):
    L, R, gt = small_pair
    cfg = CBLSMConfig(disp_range=14, arms=CrossArmConfig(tao1=25))
    res = jax.jit(lambda l, r: cblsm_pipeline(l, r, cfg))(L, R)
    assert bad_pixel_rate(np.asarray(res.disp_left), gt) < 0.12


def test_registry_complete():
    for name in ("sad", "ncc", "asw", "ad_census", "cblsm"):
        fn, cfg_cls = get_pipeline(name)
        assert callable(fn) and cfg_cls is not None
    with pytest.raises(KeyError):
        get_pipeline("nope")


def test_pipelines_deterministic(small_pair):
    """Pure-functional determinism — the property the reference's racy
    OpenMP loops lack (SURVEY.md §5)."""
    L, R, _ = small_pair
    cfg = CBLSMConfig(disp_range=10, arms=CrossArmConfig(tao1=25))
    f = jax.jit(lambda l, r: cblsm_pipeline(l, r, cfg))
    a = np.asarray(f(L, R).disp_left)
    b = np.asarray(f(L, R).disp_left)
    np.testing.assert_array_equal(a, b)


def test_asw_approx_grid_close_to_exact(small_pair):
    """Opt-in approx='grid' (intensity-binned bilateral grid) must stay
    within a small bad-2.0 delta of the exact kernel on the synthetic
    pair — and the exact path must remain the default (a clearly-flagged
    non-parity trade)."""
    L, R, gt = small_pair
    exact = jax.jit(
        lambda l, r: asw_pipeline(l, r, ASWConfig(disp_range=14, win_size=3,
                                                  use_pallas=False))
    )(L, R)
    approx = jax.jit(
        lambda l, r: asw_pipeline(l, r, ASWConfig(disp_range=14, win_size=3,
                                                  approx="grid"))
    )(L, R)
    be = bad_pixel_rate(np.asarray(exact.disp_left), gt)
    ba = bad_pixel_rate(np.asarray(approx.disp_left), gt)
    assert ba <= be + 0.05, (be, ba)


def test_asw_approx_rejects_lab_and_unknown(small_pair):
    L, R, _ = small_pair
    with pytest.raises(ValueError, match="lab"):
        asw_pipeline(L, R, ASWConfig(variant="lab", approx="grid"),
                     left_lab=L, right_lab=R)
    with pytest.raises(ValueError, match="approx"):
        asw_pipeline(L, R, ASWConfig(approx="bogus"))


def test_tiled_support_rejects_unknown_approx():
    from stereo_match_traditional_tpu.parallel.tiled import _check_tiled_support

    _check_tiled_support("asw", ASWConfig(approx="grid"))  # round-4: supported
    with pytest.raises(ValueError, match="approx"):
        _check_tiled_support("asw", ASWConfig(approx="bogus"))
