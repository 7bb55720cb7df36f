"""Row-sharded post chain (`parallel.post_shard`) vs the untiled chains.

The sharded speckle flood propagates *global* min labels with ppermute
halo merges until a global fixpoint, so its final labels (the component
minimum) and the psum'd area histogram are identical to the untiled run;
fills and medians see halo'd tiles with global-border masking.  The
sharded post is bit-exact given the same disparity inputs, so each test
runs the SAME tiled core twice — gathered post vs sharded post — and
asserts equality (the core's own tie-flip tolerance is covered by
`test_parallel.test_tiled_matches_untiled`).
"""

import jax
import numpy as np
import pytest

from stereo_match_traditional_tpu.config import (
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    SADConfig,
)
from stereo_match_traditional_tpu.parallel.mesh import make_mesh
from stereo_match_traditional_tpu.parallel.tiled import tiled_pipeline
from stereo_match_traditional_tpu.utils.synthetic import make_pair

pytestmark = pytest.mark.slow


def _assert_result_equal(a, b):
    for f in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


@pytest.mark.parametrize("rows", [96, 90])  # divisible and padded tiles
def test_ad_census_shard_post_exact(rows):
    left, right, _ = make_pair(rows, 70, 12, seed=11)
    cfg = ADCensusConfig(disp_range=16, run_post=True)
    mesh = make_mesh(8, ("tile",))
    ref = jax.jit(tiled_pipeline("ad_census", cfg, mesh, shard_post=False))(
        left, right
    )
    got = jax.jit(tiled_pipeline("ad_census", cfg, mesh, shard_post=True))(
        left, right
    )
    _assert_result_equal(got, ref)


def test_cblsm_shard_post_exact():
    left, right, _ = make_pair(96, 70, 12, seed=12)
    cfg = CBLSMConfig(disp_range=16, run_post=True)
    mesh = make_mesh(8, ("tile",))
    ref = jax.jit(tiled_pipeline("cblsm", cfg, mesh, shard_post=False))(left, right)
    got = jax.jit(tiled_pipeline("cblsm", cfg, mesh, shard_post=True))(left, right)
    _assert_result_equal(got, ref)


def test_shard_post_unsupported_pipeline_raises():
    # SAD's faithful default (unbounded hole-fill rays, `Sad.h:365`) still
    # rejects sharded post; the opt-in ray cap makes it buildable
    mesh = make_mesh(8, ("tile",))
    with pytest.raises(NotImplementedError, match="fill_max_search"):
        tiled_pipeline("sad", SADConfig(), mesh, shard_post=True)
    tiled_pipeline(
        "sad", SADConfig(fill_max_search=16), mesh, shard_post=True
    )  # builds


def test_sad_shard_post_exact_with_ray_cap():
    """With the opt-in fill_max_search cap the sharded
    SAD post (LR classes -> background-seeded speckles -> capped 8-dir fill
    -> truncate median) is bit-equal to the gathered chain."""
    left, right, _ = make_pair(96, 70, 12, seed=14)
    cfg = SADConfig(
        max_disparity=16, winsize=2, compute_right=True, run_post=True,
        fill_max_search=16,
    )
    mesh = make_mesh(8, ("tile",))
    ref = jax.jit(tiled_pipeline("sad", cfg, mesh, shard_post=False))(left, right)
    got = jax.jit(tiled_pipeline("sad", cfg, mesh, shard_post=True))(left, right)
    _assert_result_equal(got, ref)


def test_asw_shard_post_exact():
    # replicate-border medians + global min-max scale + 4-conn speckles;
    # 90 rows exercises the bottom tile's padding re-replication
    left, right, _ = make_pair(90, 70, 8, seed=13)
    cfg = ASWConfig(disp_range=8, win_size=2, run_post=True)
    mesh = make_mesh(8, ("tile",))
    ref = jax.jit(tiled_pipeline("asw", cfg, mesh, shard_post=False))(left, right)
    got = jax.jit(tiled_pipeline("asw", cfg, mesh, shard_post=True))(left, right)
    _assert_result_equal(got, ref)


def test_asw_shard_post_padding_rows_cannot_perturb_normalize():
    """Regression: the global min-max scale must ignore the bottom tile's
    out-of-image padding rows.  Feed the sharded post chain tiles whose
    padding rows carry an extreme value (as edge-replicated image rows can
    produce) and assert the real rows still match the untiled chain."""
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from stereo_match_traditional_tpu.models.asw import asw_post
    from stereo_match_traditional_tpu.parallel.post_shard import asw_post_sharded

    h_real, w, tiles = 90, 70, 8
    t = -(-h_real // tiles)  # 12 -> padded 96
    rng = np.random.default_rng(7)
    real = rng.integers(0, 8, size=(h_real, w)).astype(np.float32)
    dl = np.full((tiles * t, w), 200.0, np.float32)  # padding rows: extreme
    dl[:h_real] = real
    dr = dl.copy()
    cfg = ASWConfig(disp_range=8, win_size=2, run_post=True)
    mesh = make_mesh(tiles, ("tile",))

    def tile_fn(dlt, drt):
        idx = lax.axis_index("tile")
        out, _, _ = asw_post_sharded(
            dlt, drt, cfg, "tile", row_offset=idx * t, global_rows=h_real
        )
        return out

    got = jax.jit(
        jax.shard_map(
            tile_fn, mesh=mesh, in_specs=(P("tile"), P("tile")),
            out_specs=P("tile"), check_vma=False,
        )
    )(jnp.asarray(dl), jnp.asarray(dr))
    want = asw_post(jnp.asarray(real), jnp.asarray(dr[:h_real]), cfg)
    np.testing.assert_array_equal(np.asarray(got)[:h_real], np.asarray(want))


def test_tiled_and_streamed_accept_canonical():
    """Round 4: BOTH executors build the canonical (cross_two_pass)
    scanline/post (invariance asserted in
    test_parallel.test_tiled_canonical_scanline_and_post and
    test_streamed.test_streamed_canonical_matches_untiled)."""
    mesh = make_mesh(8, ("tile",))
    from stereo_match_traditional_tpu.config import ScanlineConfig
    from stereo_match_traditional_tpu.parallel.streamed import streamed_pipeline

    for kw in (dict(scanline=ScanlineConfig()), dict(run_post=True)):
        cfg = ADCensusConfig(disp_range=8, aggregation="cross_two_pass", **kw)
        tiled_pipeline("ad_census", cfg, mesh)   # builds without raising
        streamed_pipeline("ad_census", cfg)      # round 4: builds too


def test_ncc_tile_disp_rejects_shifted_variant():
    from stereo_match_traditional_tpu.config import NCCConfig
    from stereo_match_traditional_tpu.parallel.tiled import ncc_tile_disp

    mesh = make_mesh(8, ("tile", "disp"), shape=(4, 2))
    with pytest.raises(NotImplementedError, match="variant"):
        ncc_tile_disp(NCCConfig(disp_range=8, variant="shifted"), mesh)


def test_finish_from_volumes_canonical_post_needs_arms():
    import jax.numpy as jnp

    from stereo_match_traditional_tpu.models.registry import finish_from_volumes

    cfg = ADCensusConfig(disp_range=4, aggregation="cross_two_pass", run_post=True)
    vol = jnp.zeros((4, 8, 10), jnp.float32)
    with pytest.raises(ValueError, match="arm"):
        finish_from_volumes("ad_census", vol, vol, cfg)


def test_finish_from_volumes_canonical_roundtrip():
    """Canonical (cross_two_pass + run_post) stage re-entry == the direct
    run bit-for-bit, from the saved volumes + arm maps."""
    import jax.numpy as jnp
    import numpy as np

    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.models.registry import finish_from_volumes
    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    cfg = ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass",
        scanline=None, run_post=True,
    )
    L, R, _ = make_pair(24, 32, 8, seed=5)
    fn, _ = get_pipeline("ad_census")
    res, stages = fn(jnp.asarray(L), jnp.asarray(R), cfg, return_stages=True)
    arms = {k: stages[f"arms_left_{k}"] for k in ("left", "right", "up", "down")}
    re = finish_from_volumes(
        "ad_census", stages["aggregated_left"], stages["aggregated_right"],
        cfg, arms_left=arms,
    )
    for field in res._fields:
        a, b = getattr(res, field), getattr(re, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


def _run_sharded(fn, tiles, t, *tile_arrays):
    """Run a post_shard op under shard_map on `tiles` devices."""
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(tiles, ("tile",))
    specs = (P("tile"),) * len(tile_arrays)

    def tile_fn(*ts):
        idx = lax.axis_index("tile")
        return fn(*ts, row_offset=idx * t)

    return jax.jit(
        jax.shard_map(
            tile_fn, mesh=mesh, in_specs=specs, out_specs=P("tile"),
            check_vma=False,
        )
    )(*[jnp.asarray(a) for a in tile_arrays])


def test_sharded_speckles_jump_phase_exact():
    """The pointer-jump phase (all_gather label resolution) must reach the
    same fixpoint as plain sweeping: force it from sweep 0 on a spiral
    component whose min-label run-path far exceeds any small sweep count."""
    from stereo_match_traditional_tpu.ops.post import INVALID, remove_speckles
    from stereo_match_traditional_tpu.parallel.post_shard import (
        remove_speckles_sharded,
    )

    h = w = 64
    tiles, t = 8, 8
    d = np.full((h, w), INVALID, np.float32)
    # pitch-2 serpentine: full-width runs on even rows, single connector
    # cells alternating ends — one 4/8-connected component whose min-label
    # run-path is ~h runs long
    for r in range(0, h, 2):
        d[r, :] = 5.0
    for k, r in enumerate(range(1, h - 1, 2)):
        d[r, w - 1 if k % 2 == 0 else 0] = 5.0
    area = int((d == 5.0).sum())
    # threshold just above the true area: correct labeling keeps exactly
    # one component of `area` pixels and kills it; fragmented labels would
    # undercount every fragment and kill it too — so ALSO check the
    # keep side with a threshold just below
    for thresh in (area + 1, area):
        want = np.asarray(remove_speckles(d, 1.0, thresh, invalid_value=INVALID))

        def op(dt, row_offset, thresh=thresh):
            return remove_speckles_sharded(
                dt, 1.0, thresh, "tile", row_offset, h,
                invalid_value=INVALID, plain_sweeps=0,  # every sweep jumps
            )

        got = np.asarray(_run_sharded(op, tiles, t, d))
        np.testing.assert_array_equal(got, want, err_msg=f"thresh {thresh}")
    # sanity at thresh=area: the single spiral component survives intact
    assert (want == 5.0).sum() == area


def test_sharded_hole_fill_chained_passes_exact():
    """Regression: the three fill passes compound their reach — a single
    max_search halo was not enough.  Tall invalid bands spanning several
    8-device tile boundaries (t=12 << 3*(max_search-1)) must fill exactly
    as the untiled op."""
    from stereo_match_traditional_tpu.ops.post import INVALID, fill_holes_8dir
    from stereo_match_traditional_tpu.parallel.post_shard import (
        fill_holes_8dir_sharded,
    )

    h, w, tiles = 96, 40, 8
    t = h // tiles
    rng = np.random.default_rng(21)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        d = rng.uniform(1.0, 9.0, (h, w)).astype(np.float32)
        occl = np.zeros((h, w), bool)
        mism = np.zeros((h, w), bool)
        # tall invalid column bands crossing many tile boundaries
        for c0, kind in ((5, "occl"), (15, "mism"), (25, "none")):
            r0 = rng.integers(0, 20)
            height = rng.integers(40, 70)
            d[r0 : r0 + height, c0 : c0 + 6] = INVALID
            if kind == "occl":
                occl[r0 : r0 + height, c0 : c0 + 6] = True
            elif kind == "mism":
                mism[r0 : r0 + height, c0 : c0 + 6] = True
        want = np.asarray(
            fill_holes_8dir(d, occl, mism, INVALID, max_search=16)
        )

        def op(dt, ot, mt, row_offset):
            return fill_holes_8dir_sharded(
                dt, ot, mt, "tile", row_offset, h,
                invalid_value=INVALID, max_search=16,
            )

        got = np.asarray(_run_sharded(op, tiles, t, d, occl, mism))
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
