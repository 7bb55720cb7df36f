"""Single-chip streamed (row-band lax.map) execution == untiled pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.parallel import run_streamed
from stereo_match_traditional_tpu.utils.synthetic import make_pair


def _mismatch(a, b, ignore_cols=0, side="left"):
    """Trim the ill-defined clamp triangle: the left `ignore_cols` columns
    for left-view maps, the right ones for the mirrored right view."""
    sl = slice(ignore_cols, None) if side == "left" else slice(None, -ignore_cols or None)
    a = np.asarray(a)[:, sl]
    b = np.asarray(b)[:, sl]
    return float(np.mean(a != b))


@pytest.mark.parametrize(
    "name,cfg,exact",
    [
        ("sad", cfgs.SADConfig(max_disparity=10, winsize=1), True),
        pytest.param("ad_census", cfgs.ADCensusConfig(disp_range=10), False,
                     marks=pytest.mark.slow),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10), False),
        pytest.param("asw", cfgs.ASWConfig(disp_range=10, win_size=2,
                     use_pallas=False), False, marks=pytest.mark.slow),
        ("ncc", cfgs.NCCConfig(disp_range=10, win_size=2), False),
    ],
)
def test_streamed_matches_untiled(name, cfg, exact):
    L, R, _ = make_pair(53, 64, 10, seed=1)  # non-multiple of the band size
    fn, _ = get_pipeline(name)
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed(name, L, R, cfg, row_tile=16)
    d_range = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", 0))
    for field in ("disp_left", "disp_right", "disp_final"):
        w = getattr(want, field)
        g = getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        frac = _mismatch(
            g, w, ignore_cols=d_range,
            side="right" if field == "disp_right" else "left",
        )
        if exact:
            assert frac == 0.0, (field, frac)
        else:
            assert frac <= 5e-3, (field, frac)


@pytest.mark.parametrize(
    "scan_cfg",
    [
        cfgs.ScanlineConfig(),
        pytest.param(
            cfgs.ScanlineConfig(faithful_vertical_l2=True,
                                faithful_vertical_p2=True),
            marks=pytest.mark.slow,
        ),
    ],
)
def test_streamed_scanline_matches_untiled(scan_cfg):
    """FULL flagship (scanline + post) streams over row bands: the vertical
    band-carry continuation is bit-identical to the monolithic pass, so
    streamed == direct outside the clamp triangle.
    Rows are a non-multiple of the band size, exercising the padded-tail
    path-start reset of the bottom-up pass."""
    d = 8
    cfg = cfgs.ADCensusConfig(disp_range=d, scanline=scan_cfg, run_post=True)
    L, R, _ = make_pair(37, 48, d, seed=2)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("ad_census", L, R, cfg, row_tile=16)
    for field in ("disp_left", "disp_right", "disp_final"):
        frac = _mismatch(
            getattr(got, field), getattr(want, field), ignore_cols=d,
            side="right" if field == "disp_right" else "left",
        )
        assert frac == 0.0, (field, frac)


@pytest.mark.slow
def test_streamed_scanline_single_band():
    """h < row_tile: one band holds the whole image plus padded tail rows;
    the bottom-up pass must reset its carry at the true last row."""
    d = 8
    cfg = cfgs.ADCensusConfig(disp_range=d, scanline=cfgs.ScanlineConfig(),
                              run_post=True)
    L, R, _ = make_pair(12, 40, d, seed=4)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("ad_census", L, R, cfg, row_tile=16)
    for field in ("disp_left", "disp_right", "disp_final"):
        frac = _mismatch(
            getattr(got, field), getattr(want, field), ignore_cols=d,
            side="right" if field == "disp_right" else "left",
        )
        assert frac == 0.0, (field, frac)


@pytest.mark.slow
def test_streamed_variants_match_untiled():
    """The streamed executor inherits the round-3 variant coverage through
    the shared tile cores: a dormant cblsm cost and the asw 'lab' variant
    (aux inputs banded like the gray pair) equal the direct pipeline."""
    from stereo_match_traditional_tpu.utils import io

    L, R, _ = make_pair(37, 48, 10, seed=6)
    cfg = cfgs.CBLSMConfig(disp_range=10, cost="sad_mean", win_size=1)
    fn, _ = get_pipeline("cblsm")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("cblsm", L, R, cfg, row_tile=16)
    assert _mismatch(got.disp_left, want.disp_left, 10) <= 5e-3

    Lc, Rc, _ = make_pair(37, 48, 10, seed=6, color=True)
    lab_l, lab_r = io.rgb_to_lab_u8(Lc), io.rgb_to_lab_u8(Rc)
    cfg = cfgs.ASWConfig(disp_range=10, win_size=2, variant="lab", run_post=False)
    fa, _ = get_pipeline("asw")
    want = fa(jnp.asarray(L), jnp.asarray(R), cfg,
              left_lab=jnp.asarray(lab_l), right_lab=jnp.asarray(lab_r))
    got = run_streamed("asw", L, R, cfg, row_tile=16, aux=(lab_l, lab_r))
    assert _mismatch(got.disp_left, want.disp_left, 10) <= 5e-3

    # round-4: the ASW grid approximation streams (global-boundary-aware
    # truncated-Gaussian blurs)
    cfg = cfgs.ASWConfig(disp_range=10, win_size=2, approx="grid",
                         approx_bins=6, run_post=False)
    want = fa(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("asw", L, R, cfg, row_tile=16)
    assert _mismatch(got.disp_left, want.disp_left, 10) <= 5e-3


def test_auto_row_tile_matches_recorded_sweeps():
    """row_tile=None derives the band from the live-buffer model,
    anchored on a recorded 4K/D=256 compile sweep of a 16 GB part:
    rt=432 was the swept optimum, rt>=540 failed to compile.  The model
    must land within 10% of the optimum and below the compile boundary
    on a 16 GB part; at 720p everything fits, so the pick degenerates to
    a single band."""
    from stereo_match_traditional_tpu.parallel.streamed import auto_row_tile

    mem = 16 * 2**30
    full = cfgs.ADCensusConfig(
        disp_range=256, scanline=cfgs.ScanlineConfig(), run_post=True
    )
    t4k = auto_row_tile("ad_census", full, 2160, 3840, memory_bytes=mem)
    assert 432 * 0.9 <= t4k < 540, t4k

    full_720 = cfgs.ADCensusConfig(
        disp_range=128, scanline=cfgs.ScanlineConfig(), run_post=True
    )
    assert auto_row_tile("ad_census", full_720, 720, 1280, memory_bytes=mem) == 720

    # canonical model: smaller bands (more live xs + 140-row halos), >= floor
    canon = cfgs.ADCensusConfig(
        disp_range=256, aggregation="cross_two_pass",
        scanline=cfgs.ScanlineConfig(), run_post=True,
    )
    tc = auto_row_tile("ad_census", canon, 2160, 3840, memory_bytes=mem)
    assert 16 <= tc < t4k, tc

    # infeasible workloads reject with guidance instead of OOMing
    with pytest.raises(ValueError):
        auto_row_tile("ad_census", full, 2160, 3840, memory_bytes=2**30)

    # the auto path runs end-to-end (tiny image -> single band)
    L, R, _ = make_pair(24, 32, 6, seed=0)
    cfg = cfgs.SADConfig(max_disparity=6, winsize=1)
    fn, _ = get_pipeline("sad")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("sad", L, R, cfg)  # row_tile=None
    assert np.array_equal(np.asarray(got.disp_left), np.asarray(want.disp_left))


@pytest.mark.parametrize("da", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_streamed_canonical_matches_untiled(da):
    """The canonical (ADCensusOption) family streams:
    cross_two_pass aggregation + tso-scheduled scanline on BOTH volumes
    (band-carried vertical continuations) + the canonical post on the
    gathered maps — with the optional discontinuity adjustment as a third
    band sweep — equals the direct executor.  Rows are a non-multiple of
    the band size, exercising the padded-tail path-start reset."""
    cfg = cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass",
        scanline=cfgs.ScanlineConfig(), run_post=True,
        cross_params=cfgs.CrossAggregatorParams(
            cross_l1=5, cross_l2=3, num_iters=2,
            do_discontinuity_adjustment=da,
        ),
    )
    L, R, _ = make_pair(37, 48, 8, seed=3)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("ad_census", L, R, cfg, row_tile=16)
    for field in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        frac = _mismatch(
            g, w, ignore_cols=8,
            side="right" if field == "disp_right" else "left",
        )
        assert frac <= 5e-3, (field, frac)


def test_streamed_canonical_staged_matches_fused():
    """`streamed_canonical_staged` (the two-program serving form) equals
    the fused streamed executor bitwise on every output — the split only
    moves a program boundary."""
    from stereo_match_traditional_tpu.parallel.streamed import (
        streamed_canonical_staged, streamed_pipeline,
    )

    cfg = cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass",
        scanline=cfgs.ScanlineConfig(), run_post=True,
        cross_params=cfgs.CrossAggregatorParams(
            cross_l1=5, cross_l2=3, num_iters=2,
        ),
    )
    L, R, _ = make_pair(37, 48, 8, seed=3)
    Lj, Rj = jnp.asarray(L), jnp.asarray(R)
    fused = streamed_pipeline("ad_census", cfg, row_tile=16)(Lj, Rj)
    staged = streamed_canonical_staged(cfg, row_tile=16)(Lj, Rj)
    for field in ("disp_left", "disp_right", "disp_final", "occlusion",
                  "mismatch"):
        f, s = getattr(fused, field), getattr(staged, field)
        assert (f is None) == (s is None), field
        if f is not None:
            np.testing.assert_array_equal(np.asarray(f), np.asarray(s), err_msg=field)

    import pytest as _pytest
    with _pytest.raises(ValueError):
        streamed_canonical_staged(cfgs.ADCensusConfig(disp_range=8))


@pytest.mark.slow
def test_streamed_canonical_no_scanline_post():
    """Canonical aggregation without scanline still routes the canonical
    post chain (not the legacy one) on the gathered streamed maps."""
    cfg = cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass", run_post=True,
        cross_params=cfgs.CrossAggregatorParams(cross_l1=5, cross_l2=3,
                                                num_iters=2),
    )
    L, R, _ = make_pair(37, 48, 8, seed=3)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_streamed("ad_census", L, R, cfg, row_tile=16)
    for field in ("disp_left", "disp_right", "disp_final"):
        frac = _mismatch(
            getattr(got, field), getattr(want, field), ignore_cols=8,
            side="right" if field == "disp_right" else "left",
        )
        assert frac <= 5e-3, (field, frac)
