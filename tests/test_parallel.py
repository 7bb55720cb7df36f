"""Multi-device tests on the 8-device CPU mesh (SURVEY.md §4).

The single most important distributed test: tiled (N-device) == untiled
(1-device) for every pipeline — proving halo widths, global-border
coordinates, sharded WTA and the scanline reshard correct.  Equality is
checked on disparity maps; cost sums may differ in the last ulp between
tilings (different float summation orders), so a vanishing mismatch
fraction is allowed where aggregation is involved.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.ops import volume, wta
from stereo_match_traditional_tpu.parallel import (
    add_row_halo,
    make_mesh,
    run_tiled,
    scanline_optimize_sharded,
    wta_sharded,
)
from stereo_match_traditional_tpu.parallel.tiled import (
    ad_census_tile_disp,
    tiled_pipeline,
)
from stereo_match_traditional_tpu.parallel.wta_shard import optimal_disparity_sharded
from stereo_match_traditional_tpu.utils.synthetic import make_pair


def _mismatch_fraction(a, b, ignore_cols: int = 0):
    """Fraction of differing pixels; ``ignore_cols`` drops a strip at each
    vertical edge where the clamp triangle duplicates costs exactly and
    argmin ties flip with float summation order (disparity there is
    ill-defined in the reference too — all candidates index off-image)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if ignore_cols:
        a = a[:, ignore_cols:-ignore_cols]
        b = b[:, ignore_cols:-ignore_cols]
    return float(np.mean(a != b))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_add_row_halo_multi_hop():
    """Halo larger than the tile: gathered rows equal the edge-replicated
    global image."""
    mesh = make_mesh(8, ("tile",))
    h, w, halo = 24, 8, 7  # tile height 3 < halo 7 -> 3 hops
    x = jnp.arange(h * w, dtype=jnp.float32).reshape(h, w)

    fn = jax.jit(
        jax.shard_map(
            lambda t: add_row_halo(t, halo, "tile"),
            mesh=mesh,
            in_specs=P("tile", None),
            out_specs=P("tile", None),
            check_vma=False,
        )
    )
    out = np.asarray(fn(x)).reshape(8, 3 + 2 * halo, w)
    xp = np.pad(np.asarray(x), ((halo, halo), (0, 0)), mode="edge")
    for i in range(8):
        np.testing.assert_array_equal(out[i], xp[i * 3 : i * 3 + 3 + 2 * halo])


def test_wta_sharded_matches_argmin():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((16, 9, 11)).astype(np.float32)
    mesh = make_mesh(8, ("disp",))
    fn = jax.jit(
        jax.shard_map(
            lambda v: wta_sharded(v, "disp", "min"),
            mesh=mesh,
            in_specs=P("disp", None, None),
            out_specs=P(),
            check_vma=False,
        )
    )
    got = np.asarray(fn(vol))
    np.testing.assert_array_equal(got, np.argmin(vol, axis=0).astype(np.float32))


def test_wta_sharded_tie_breaks_low():
    vol = np.ones((8, 4, 5), np.float32)
    mesh = make_mesh(8, ("disp",))
    fn = jax.jit(
        jax.shard_map(
            lambda v: wta_sharded(v, "disp", "min"),
            mesh=mesh,
            in_specs=P("disp", None, None),
            out_specs=P(),
            check_vma=False,
        )
    )
    np.testing.assert_array_equal(np.asarray(fn(vol)), np.zeros((4, 5), np.float32))


def test_optimal_disparity_sharded_matches():
    rng = np.random.default_rng(3)
    vol = (rng.random((16, 7, 9)) * 100).astype(np.float32)
    want = np.asarray(wta.optimal_disparity(jnp.asarray(vol), 0.01, False))
    mesh = make_mesh(8, ("disp",))
    fn = jax.jit(
        jax.shard_map(
            lambda v: optimal_disparity_sharded(v, "disp", 0.01, False, disp_range=16),
            mesh=mesh,
            in_specs=P("disp", None, None),
            out_specs=P(),
            check_vma=False,
        )
    )
    np.testing.assert_array_equal(np.asarray(fn(vol)), want)


def test_optimal_disparity_sharded_masks_pad_garbage():
    # disp_range=13 over 8 devices: d_local=2, 3 padded slots that the
    # caller filled with 0.0 (cheaper than every real cost).  The op must
    # mask them itself — a pad winning the argmin would emit an
    # out-of-range disparity that escapes the border reject checks.
    rng = np.random.default_rng(5)
    vol = (rng.random((16, 7, 9)) * 100 + 10).astype(np.float32)
    vol[13:] = 0.0  # pad garbage
    want = np.asarray(
        wta.optimal_disparity(jnp.asarray(vol[:13]), 0.01, False)
    )
    mesh = make_mesh(8, ("disp",))
    fn = jax.jit(
        jax.shard_map(
            lambda v: optimal_disparity_sharded(v, "disp", 0.01, False, disp_range=13),
            mesh=mesh,
            in_specs=P("disp", None, None),
            out_specs=P(),
            check_vma=False,
        )
    )
    np.testing.assert_array_equal(np.asarray(fn(vol)), want)


def test_wta_sharded_rejects_unknown_mode():
    # ops.wta.wta defaults unknown strings to max while wta_sharded
    # defaulted them to min — a typo silently inverted the winner between
    # sharded and unsharded runs; now it raises.
    with pytest.raises(ValueError, match="mode"):
        wta_sharded(jnp.zeros((2, 3, 4)), "disp", "Max")


def test_ad_census_tile_disp_rejects_scanline():
    mesh = make_mesh(8, ("tile", "disp"), (4, 2))
    cfg = cfgs.ADCensusConfig(scanline=cfgs.ScanlineConfig())
    with pytest.raises(NotImplementedError, match="scanline"):
        ad_census_tile_disp(cfg, mesh)


def test_scanline_sharded_matches_unsharded():
    from stereo_match_traditional_tpu.ops.scanline import scanline_optimize

    L, R, _ = make_pair(40, 52, 8, seed=7)
    cost = volume.ad_volume(L, R, 8, "left")
    cfg = cfgs.ScanlineConfig(p1=10.0, p2=150.0)
    want = np.asarray(scanline_optimize(cost, jnp.asarray(L), cfg))

    mesh = make_mesh(8, ("tile",))
    fn = jax.jit(
        jax.shard_map(
            lambda c, g: scanline_optimize_sharded(c, g, cfg, "tile", true_rows=40),
            mesh=mesh,
            in_specs=(P(None, "tile", None), P("tile", None)),
            out_specs=P(None, "tile", None),
            check_vma=False,
        )
    )
    got = np.asarray(fn(cost, jnp.asarray(L).astype(jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,cfg,exact",
    [
        ("sad", cfgs.SADConfig(max_disparity=10, winsize=1), False),
        ("ncc", cfgs.NCCConfig(disp_range=10, win_size=3), False),
        (
            "asw",
            cfgs.ASWConfig(disp_range=10, win_size=2, run_post=True),
            False,
        ),
        ("ad_census", cfgs.ADCensusConfig(disp_range=10), False),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10), False),
    ],
)
def test_tiled_matches_untiled(name, cfg, exact):
    """THE invariance test: 8-device row tiling == single-device run."""
    L, R, _ = make_pair(48, 64, 10, seed=1)
    fn, _ = get_pipeline(name)
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    mesh = make_mesh(8, ("tile",))
    got = run_tiled(name, L, R, cfg, mesh)

    d_range = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", 0))
    for field in ("disp_left", "disp_right", "disp_final"):
        w = getattr(want, field)
        g = getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        frac = _mismatch_fraction(g, w, ignore_cols=d_range)
        if exact:
            assert frac == 0.0, (field, frac)
        else:
            # float-sum-order argmin flips only on near-exact cost ties
            assert frac <= 5e-3, (field, frac)


@pytest.mark.slow
def test_tiled_ad_census_with_scanline_and_post():
    cfg = cfgs.ADCensusConfig(
        disp_range=10, scanline=cfgs.ScanlineConfig(), run_post=True
    )
    L, R, _ = make_pair(48, 64, 10, seed=2)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    mesh = make_mesh(8, ("tile",))
    got = run_tiled("ad_census", L, R, cfg, mesh)
    assert _mismatch_fraction(got.disp_left, want.disp_left) <= 5e-3
    w = np.asarray(want.disp_final)
    g = np.asarray(got.disp_final)
    both = np.isfinite(w) & np.isfinite(g)
    assert float(np.mean(np.isfinite(w) != np.isfinite(g))) <= 1e-2
    assert float(np.mean(np.abs(w[both] - g[both]) > 1e-3)) <= 1e-2


@pytest.mark.slow
@pytest.mark.parametrize("da", [False, True])
def test_tiled_canonical_scanline_and_post(da):
    """The canonical (ADCensusOption) family on the explicit-halo executor
   : cross_two_pass aggregation + tso-scheduled
    scanline on BOTH volumes (sharded via the all_to_all column reshard)
    + the canonical post (LR at lrcheck_thres, region voting, optional
    row-local discontinuity adjustment on the tile-sharded volume, median)
    == the direct executor."""
    cfg = cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass",
        scanline=cfgs.ScanlineConfig(), run_post=True,
        cross_params=cfgs.CrossAggregatorParams(do_discontinuity_adjustment=da),
    )
    L, R, _ = make_pair(37, 48, 8, seed=3)  # rows a non-multiple of 8 tiles
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    mesh = make_mesh(8, ("tile",))
    got = run_tiled("ad_census", L, R, cfg, mesh)
    for field in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        assert _mismatch_fraction(g, w, ignore_cols=8) <= 5e-3, field


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,cfg,color",
    [
        ("ncc", cfgs.NCCConfig(disp_range=10, variant="shifted",
                               alt_max_offset=12, alt_kernel=3), False),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10, cost="sad_mean", win_size=1), False),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10, cost="sad_mean_v4", win_size=1), True),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10, aggregation="rect_mean_v4"), False),
        ("cblsm", cfgs.CBLSMConfig(disp_range=10, cost="local_mean",
                                   aggregation="cross_two_pass"), False),
        # round-4: the opt-in ASW grid approximation
        # tiles exactly — the truncated-Gaussian row blur is
        # global-boundary-aware, so edge-replicated halo rows outside the
        # image are zeroed out of the blur like the untiled blur's
        # implicit zero boundary
        ("asw", cfgs.ASWConfig(disp_range=10, win_size=2, approx="grid",
                               approx_bins=6, run_post=False), False),
    ],
)
def test_tiled_variant_matches_untiled(name, cfg, color):
    """The dormant reference variants (ncc 'shifted', every cblsm
    cost/aggregation) run on the explicit-halo executor with
    variant-aware halos, equal to the direct pipeline."""
    L, R, _ = make_pair(37, 48, 10, seed=6, color=color)
    fn, _ = get_pipeline(name)
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = run_tiled(name, L, R, cfg, make_mesh(4, ("tile",)))
    for field in ("disp_left", "disp_right"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert _mismatch_fraction(g, w, ignore_cols=10) <= 5e-3, field


@pytest.mark.slow
def test_tiled_asw_lab_aux_inputs():
    """The dormant Lab-weight ASW variant on the tiled executor: the Lab
    pair rides as aux inputs, sharded and halo'd like the gray pair."""
    from stereo_match_traditional_tpu.utils import io

    L, R, _ = make_pair(37, 48, 10, seed=6)
    Lc, Rc, _ = make_pair(37, 48, 10, seed=6, color=True)
    lab_l, lab_r = io.rgb_to_lab_u8(Lc), io.rgb_to_lab_u8(Rc)
    cfg = cfgs.ASWConfig(disp_range=10, win_size=2, variant="lab", run_post=True)
    fn, _ = get_pipeline("asw")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg,
              left_lab=jnp.asarray(lab_l), right_lab=jnp.asarray(lab_r))
    got = run_tiled("asw", L, R, cfg, make_mesh(4, ("tile",)),
                    aux=(lab_l, lab_r))
    for field in ("disp_left", "disp_right", "disp_final"):
        assert _mismatch_fraction(
            getattr(got, field), getattr(want, field), ignore_cols=10
        ) <= 5e-3, field


def test_tiled_canonical_rejects_shard_post():
    cfg = cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass", run_post=True
    )
    mesh = make_mesh(8, ("tile",))
    with pytest.raises(NotImplementedError):
        tiled_pipeline("ad_census", cfg, mesh, shard_post=True)


@pytest.mark.slow
def test_ad_census_tile_disp_2d_mesh():
    """Rows x disparity 2-D mesh equals the single-device pipeline."""
    cfg = cfgs.ADCensusConfig(disp_range=16)
    L, R, _ = make_pair(48, 64, 12, seed=4)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    mesh = make_mesh(8, ("tile", "disp"), (4, 2))
    run = jax.jit(ad_census_tile_disp(cfg, mesh))
    got = run(jnp.asarray(L), jnp.asarray(R))
    assert _mismatch_fraction(got.disp_left, want.disp_left, ignore_cols=16) <= 5e-3
    assert _mismatch_fraction(got.disp_right, want.disp_right, ignore_cols=16) <= 5e-3


@pytest.mark.slow
def test_tiled_deterministic_across_runs():
    """Determinism property (SURVEY.md §5: replaces the reference's OpenMP
    races): identical inputs -> identical tiled outputs, twice."""
    cfg = cfgs.CBLSMConfig(disp_range=8)
    L, R, _ = make_pair(32, 48, 8, seed=9)
    mesh = make_mesh(8, ("tile",))
    a = run_tiled("cblsm", L, R, cfg, mesh)
    b = run_tiled("cblsm", L, R, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(a.disp_left), np.asarray(b.disp_left))


@pytest.mark.slow
def test_gspmd_pipeline_matches_single_device():
    """GSPMD (jit + sharding constraints) must be semantics-preserving for
    every pipeline, including post chains — XLA chooses the collectives.

    When XLA reshards a reduction (e.g. the SAT triangular matmuls of
    `aggregate._sat`), the float summation order changes at the last ulp,
    which can flip argmin ties; the envelope below bounds such flips to
    <1% of pixels (the same philosophy as the tiled invariance tests).
    SAD has no resharded reduction feeding its argmin and stays exact.
    """
    from stereo_match_traditional_tpu.parallel.gspmd import gspmd_pipeline

    L, R, _ = make_pair(48, 64, 10, seed=3)
    mesh = make_mesh(8, ("tile",))
    for name, cfg, exact in [
        ("sad", cfgs.SADConfig(max_disparity=10, winsize=1, run_post=True), True),
        ("ad_census", cfgs.ADCensusConfig(disp_range=10, run_post=True), False),
        # the full canonical (ADCensusOption) chain — the mode the tiled
        # executor rejects and routes here (tso scanline on both volumes,
        # region voting, discontinuity adjustment)
        (
            "ad_census",
            cfgs.ADCensusConfig(
                disp_range=10, aggregation="cross_two_pass",
                scanline=cfgs.ScanlineConfig(), run_post=True,
            ),
            False,
        ),
    ]:
        fn, _ = get_pipeline(name)
        want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
        got = gspmd_pipeline(name, cfg, mesh)(jnp.asarray(L), jnp.asarray(R))
        wl = np.asarray(want.disp_left)
        gl = np.asarray(got.disp_left)
        if exact:
            np.testing.assert_array_equal(gl, wl)
        else:
            frac = np.mean(gl != wl)
            assert frac < 0.01, f"{name}: {frac:.3%} pixels flipped"
        w = np.asarray(want.disp_final)
        g = np.asarray(got.disp_final)
        both = np.isfinite(w) & np.isfinite(g)
        if exact:
            np.testing.assert_array_equal(np.isfinite(w), np.isfinite(g))
            np.testing.assert_allclose(g[both], w[both], atol=1e-5)
        else:
            assert np.mean(np.isfinite(w) != np.isfinite(g)) < 0.01
            assert np.mean(np.abs(g[both] - w[both]) > 1e-5) < 0.01


def test_distributed_helpers_single_process():
    """initialize() is a safe no-op single-process; host_chip_mesh builds
    the (host, chip) mesh over all visible devices."""
    from stereo_match_traditional_tpu.parallel import host_chip_mesh, initialize

    # The backend is already up in this process and nothing configured a
    # coordinator, so initialize() must report (not hide) the degradation.
    assert initialize() in ("single-process", "already-initialized")
    mesh = host_chip_mesh()
    assert mesh.axis_names == ("host", "chip")
    assert mesh.shape["host"] == 1 and mesh.shape["chip"] == 8
    # and it drives a sharded pipeline end to end
    L, R, _ = make_pair(32, 48, 8, seed=6)
    got = run_tiled(
        "sad", L, R, cfgs.SADConfig(max_disparity=8, winsize=1), mesh,
        axis_name="chip",
    )
    fn, _ = get_pipeline("sad")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfgs.SADConfig(max_disparity=8, winsize=1))
    assert _mismatch_fraction(got.disp_left, want.disp_left, ignore_cols=8) == 0.0


@pytest.mark.slow
def test_ncc_tile_disp_2d_mesh():
    """NCC rows x disparity 2-D mesh equals the single-device pipeline
    (NCC's D=200 axis is the one that most wants disparity sharding)."""
    from stereo_match_traditional_tpu.parallel.tiled import ncc_tile_disp

    cfg = cfgs.NCCConfig(disp_range=16, win_size=3)
    L, R, _ = make_pair(48, 64, 12, seed=4)
    fn, _ = get_pipeline("ncc")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    mesh = make_mesh(8, ("tile", "disp"), (2, 4))
    run = jax.jit(ncc_tile_disp(cfg, mesh))
    got = run(jnp.asarray(L), jnp.asarray(R))
    np.testing.assert_array_equal(
        np.asarray(got.disp_left), np.asarray(want.disp_left)
    )


@pytest.mark.slow
@pytest.mark.parametrize("disp_range", [10, 13])
def test_tile_disp_non_divisible_disparity(disp_range):
    """disp_range % n_d != 0: the padded +inf slices never win and the 2-D
    mesh still matches the single-device run (both pipelines)."""
    from stereo_match_traditional_tpu.parallel.tiled import (
        ad_census_tile_disp,
        ncc_tile_disp,
    )

    L, R, _ = make_pair(48, 64, 10, seed=8)
    mesh = make_mesh(8, ("tile", "disp"), (2, 4))

    cfg = cfgs.ADCensusConfig(disp_range=disp_range)
    fn, _ = get_pipeline("ad_census")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg)
    got = jax.jit(ad_census_tile_disp(cfg, mesh))(jnp.asarray(L), jnp.asarray(R))
    assert _mismatch_fraction(got.disp_left, want.disp_left,
                              ignore_cols=disp_range) <= 5e-3

    ncfg = cfgs.NCCConfig(disp_range=disp_range, win_size=3)
    nfn, _ = get_pipeline("ncc")
    nwant = nfn(jnp.asarray(L), jnp.asarray(R), ncfg)
    ngot = jax.jit(ncc_tile_disp(ncfg, mesh))(jnp.asarray(L), jnp.asarray(R))
    np.testing.assert_array_equal(
        np.asarray(ngot.disp_left), np.asarray(nwant.disp_left)
    )


def test_gspmd_aux_inputs_lab_variant():
    """Variants needing extra image inputs (ASW Lab weights,
    `ASWeight.cpp:33-34`) run under GSPMD by declaring aux_names — the
    tiled executor rejects them and routes here, so this path must work."""
    from stereo_match_traditional_tpu.parallel.gspmd import gspmd_pipeline

    rng = np.random.default_rng(9)
    L, R, _ = make_pair(40, 52, 8, seed=4)
    lab_l = jnp.asarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8))
    lab_r = jnp.asarray(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8))
    cfg = cfgs.ASWConfig(disp_range=8, win_size=2, variant="lab")
    fn, _ = get_pipeline("asw")
    want = fn(jnp.asarray(L), jnp.asarray(R), cfg, left_lab=lab_l, right_lab=lab_r)
    mesh = make_mesh(8, ("tile",))
    run = gspmd_pipeline(
        "asw", cfg, mesh, aux_names=("left_lab", "right_lab")
    )
    got = run(jnp.asarray(L), jnp.asarray(R), lab_l, lab_r)
    assert (
        _mismatch_fraction(got.disp_left, want.disp_left, ignore_cols=8) < 0.01
    )


def test_make_mesh_shape_only():
    """shape without n_devices takes exactly prod(shape) devices; an
    impossible shape fails with a clear error, not a numpy reshape crash."""
    mesh = make_mesh(axis_names=("tile", "disp"), shape=(2, 2))
    assert mesh.shape == {"tile": 2, "disp": 2}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(4, ("tile",), shape=(3,))
    with pytest.raises(ValueError, match="devices"):
        make_mesh(99, ("tile",))


def test_finish_from_volumes_requires_right_volume():
    from stereo_match_traditional_tpu.models.registry import finish_from_volumes

    vol = jnp.zeros((4, 8, 8))
    with pytest.raises(ValueError, match="both views"):
        finish_from_volumes("ad_census", vol, None, cfgs.ADCensusConfig(disp_range=4))
