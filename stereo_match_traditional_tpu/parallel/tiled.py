"""Tile-data-parallel pipeline execution (`shard_map` over row tiles).

The reference parallelizes its outer row loops with (racy) OpenMP pragmas
(`SAD/Sad.h:112`, SURVEY.md §2.6); here the image is split into row tiles
across devices on a `Mesh`, each tile is extended with a halo sized to the
pipeline's exact receptive field (:func:`receptive_field_rows`), the
cost/aggregate/WTA stages run per tile, and the cheap [H, W] post-processing
runs on the gathered disparity maps.  A tiled run equals the untiled run up
to float summation order (the invariance test of SURVEY.md §4).

The flagship AD-Census pipeline additionally supports a 2-D
``('tile', 'disp')`` mesh — rows tile-data-parallel and the disparity axis
tensor-parallel with a two-stage WTA (`parallel.wta_shard`).  The
clamped-column gather used by the AD and census costs makes every d-shard
locally computable (no cross-shard border fill; see `ops.volume.ad_volume`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from stereo_match_traditional_tpu import config as _cfg
from stereo_match_traditional_tpu.models.ad_census import ad_census_post
from stereo_match_traditional_tpu.models.asw import asw_post
from stereo_match_traditional_tpu.models.base import StereoResult
from stereo_match_traditional_tpu.models.cblsm import cblsm_post
from stereo_match_traditional_tpu.models.sad import sad_post
from stereo_match_traditional_tpu.ops import aggregate, volume, wta
from stereo_match_traditional_tpu.ops.kernels import (
    asw_volume_pallas,
    resolve_use_pallas,
)
from stereo_match_traditional_tpu.parallel.halo import add_row_halo, crop_row_halo
from stereo_match_traditional_tpu.parallel.scan_carry import (
    scanline_canonical_sharded,
    scanline_optimize_sharded,
)
from stereo_match_traditional_tpu.parallel.wta_shard import wta_sharded


def receptive_field_rows(name: str, cfg) -> int:
    """Static per-pipeline halo calculator (SURVEY.md §7 "halo sizing").

    Returns the number of neighbor rows a tile needs so its own rows are
    computed exactly as in the untiled run.  Scanline optimization needs no
    halo — the sharded version reshards to full-height columns instead
    (`parallel.scan_carry`).
    """
    if name == "sad":
        return cfg.winsize + 1                      # window radius, Sad.h:109
    if name == "ncc":
        if cfg.variant == "shifted":
            return cfg.alt_kernel                   # 11x11 window, NCC.h:122
        return cfg.win_size                         # window radius, NCC.h:15
    if name == "asw":
        return cfg.win_size + 1                     # support radius, ASW.h:333
    if name == "ad_census":
        census_rf = cfg.census_rows // 2            # 4 rows, AD-Census.h:167
        if cfg.aggregation == "rect_mean":
            return cfg.arms.max_length * cfg.agg_iters + census_rf
        if cfg.aggregation == "cross_two_pass":
            return cfg.cross_params.cross_l1 * cfg.cross_params.num_iters + census_rf
        return census_rf
    if name == "cblsm":
        cost_rf = {
            "ad": 0,                                # no row reach
            "sad_mean": cfg.win_size + 1,           # window radius
            "sad_mean_v4": cfg.win_size + 1,
            "local_mean": cfg.arms.max_length,      # arm-region mean
        }[cfg.cost]
        agg_rf = {
            "rect_mean": cfg.arms.max_length * cfg.agg_passes,
            "rect_mean_v4": cfg.arms.max_length,    # single V4 application
            "cross_two_pass": cfg.cross_params.cross_l1 * cfg.cross_params.num_iters,
            "none": 0,
        }[cfg.aggregation]
        return cost_rf + agg_rf
    raise KeyError(name)


# ---------------------------------------------------------------------------
# per-pipeline tile cores: (left_ext, right_ext, ctx) -> dict of [T, W] tiles
# ---------------------------------------------------------------------------


def _sad_tile(le, re, cfg, ro_ext, rows, halo, axis_name, aux=()):
    vol_l = volume.sad_volume(le, re, cfg.max_disparity, cfg.winsize, "left")
    out = {
        "disp_left": crop_row_halo(
            wta.optimal_disparity(vol_l, cfg.uniqueness_eps, cfg.subpixel), halo, 0
        )
    }
    if cfg.compute_right or cfg.run_post:
        vol_r = volume.sad_volume(le, re, cfg.max_disparity, cfg.winsize, "right")
        out["disp_right"] = crop_row_halo(wta.wta(vol_r, "min"), halo, 0)
    return out


def _ncc_tile(le, re, cfg, ro_ext, rows, halo, axis_name, aux=()):
    if cfg.variant == "shifted":
        depth = volume.ncc_shifted_depth(
            le, re, cfg.alt_max_offset, cfg.alt_kernel, "left",
            cfg.alt_add_constant, cfg.alt_depth_scale,
            row_offset=ro_ext, global_rows=rows,
        )
        return {"disp_left": crop_row_halo(depth, halo, 0)}
    vol, interior = volume.ncc_volume(
        le, re, cfg.disp_range, cfg.win_size, cfg.invalid_mode, cfg.eps,
        row_offset=ro_ext, global_rows=rows,
    )
    disp = jnp.where(interior, wta.wta(vol, "max"), 0.0)
    return {"disp_left": crop_row_halo(disp, halo, 0)}


def _asw_tile(le, re, cfg, ro_ext, rows, halo, axis_name, aux=()):
    kw = dict(
        disp_range=cfg.disp_range,
        win_size=cfg.win_size,
        space_sigma=cfg.space_sigma,
        color_sigma=cfg.color_sigma,
        truncation=cfg.truncation,
    )
    if cfg.variant == "lab":
        # dormant Lab-weight variant: the Lab pairs arrive as halo-extended
        # aux tiles (tiled_pipeline(..., aux=(left_lab, right_lab)))
        if len(aux) != 2:
            raise ValueError(
                "asw variant='lab' under the tiled executor needs the Lab "
                "pair as aux inputs: tiled_pipeline(...)(left, right, "
                "left_lab, right_lab)"
            )
        vol_l = volume.asw_lab_volume(
            le, re, aux[0], aux[1], faithful_lut=cfg.lab_faithful_lut, **kw
        )
    elif cfg.approx == "grid":
        # opt-in constant-time approximation: the truncated-Gaussian row
        # blur is global-boundary-aware, so the radius-row halo is exact
        # (volume.asw_volume_approx_grid row_offset/global_rows)
        vol_l = volume.asw_volume_approx_grid(
            le, re, bins=cfg.approx_bins, row_offset=ro_ext,
            global_rows=rows, **kw
        )
    elif resolve_use_pallas(cfg.use_pallas):
        vol_l = asw_volume_pallas(le, re, view="left", **kw)
    else:
        vol_l = volume.asw_volume(le, re, **kw)
    # exact shift identity costR(q,d) = costL(q+d,d) (row-local, so valid
    # per row-tile unchanged) — same as models/asw.py
    vol_r = volume.right_volume_from_left(vol_l)
    disp_l = wta.wta(vol_l, "min")
    disp_r = wta.wta(vol_r, "min")
    return {
        "disp_left": crop_row_halo(disp_l, halo, 0),
        "disp_right": crop_row_halo(disp_r, halo, 0),
    }


def _ad_census_band_volumes(le, re, cfg, ro_ext, rows):
    """Aggregated AD-Census volumes of one halo-extended row band —
    the shared core of the tiled and streamed executors (uncropped;
    callers drop the halo with :func:`crop_row_halo`).  Returns
    ``(agg_l, agg_r)``, each ``[D, T + 2*halo, W]``."""
    d = cfg.disp_range
    vol_l = volume.ad_census_volume(
        le, re, d, cfg.sigma_c, cfg.sigma_s, cfg.census_rows, cfg.census_cols,
        "left", ro_ext, rows,
    )
    vol_r = volume.ad_census_volume(
        le, re, d, cfg.sigma_c, cfg.sigma_s, cfg.census_rows, cfg.census_cols,
        "right", ro_ext, rows,
    )
    if cfg.aggregation == "rect_mean":
        arms_l = aggregate.cross_arms(le, cfg.arms, ro_ext, rows)
        arms_r = aggregate.cross_arms(re, cfg.arms, ro_ext, rows)
        agg_l, agg_r = vol_l, vol_r
        for _ in range(cfg.agg_iters):
            agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l, max_span=cfg.arms.max_length)
            agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r, max_span=cfg.arms.max_length)
    elif cfg.aggregation == "cross_two_pass":
        arms_l = aggregate.canonical_cross_arms(le, cfg.cross_params, ro_ext, rows)
        arms_r = aggregate.canonical_cross_arms(re, cfg.cross_params, ro_ext, rows)
        agg_l = aggregate.cross_aggregate(vol_l, arms_l, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
        agg_r = aggregate.cross_aggregate(vol_r, arms_r, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
    else:
        agg_l, agg_r = vol_l, vol_r
    return agg_l, agg_r


def _ad_census_tile(le, re, cfg, ro_ext, rows, halo, axis_name, aux=()):
    agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, ro_ext, rows)
    agg_l = crop_row_halo(agg_l, halo, 1)
    agg_r = crop_row_halo(agg_r, halo, 1)
    canonical = cfg.aggregation == "cross_two_pass"

    if cfg.scanline is not None:
        left_tile = crop_row_halo(le, halo, 0)
        if canonical:
            # canonical (ADCensusOption) mode: tso-scheduled scanline on
            # BOTH volumes, matching models.ad_census_pipeline
            right_tile = crop_row_halo(re, halo, 0)
            cp = cfg.cross_params
            agg_l = scanline_canonical_sharded(
                agg_l, left_tile, right_tile, cp.so_p1, cp.so_p2, cp.so_tso,
                "left", axis_name, rows,
            )
            agg_r = scanline_canonical_sharded(
                agg_r, right_tile, left_tile, cp.so_p1, cp.so_p2, cp.so_tso,
                "right", axis_name, rows,
            )
        else:
            agg_l = scanline_optimize_sharded(
                agg_l, left_tile, cfg.scanline, axis_name, rows
            )
    out = {
        "disp_left": wta.wta(agg_l, "min"),
        "disp_right": wta.wta(agg_r, "min"),
    }
    if canonical and cfg.run_post and cfg.cross_params.do_discontinuity_adjustment:
        # the canonical post's discontinuity adjustment is row-local but
        # needs this tile's aggregated left volume; hand it out sharded
        out["agg_left"] = jnp.moveaxis(agg_l, 0, 1)  # [T, D, W]: rows leading
    return out


def _cblsm_tile(le, re, cfg, ro_ext, rows, halo, axis_name, aux=()):
    """Every CBLSM cost/aggregation variant of models/cblsm.py on a
    halo-extended row tile — all reference paths are row-local within the
    variant-aware halo of :func:`receptive_field_rows` (the arm rules and
    window sums need the *global* row coordinates, passed through)."""
    d = cfg.disp_range
    arms_l = aggregate.cross_arms(le, cfg.arms, ro_ext, rows)
    arms_r = aggregate.cross_arms(re, cfg.arms, ro_ext, rows)

    if cfg.cost == "ad":
        vol_l = volume.ad_volume(le, re, d, "left")
        vol_r = volume.ad_volume(le, re, d, "right")
    elif cfg.cost == "sad_mean":
        vol_l = volume.sad_volume(le, re, d, cfg.win_size, "left", mean=True)
        vol_r = volume.sad_volume(le, re, d, cfg.win_size, "right", mean=True)
    elif cfg.cost == "sad_mean_v4":
        vol_l = volume.sad_volume(
            le, re, d, cfg.win_size, "left", mean=True, channel_min=True
        )
        vol_r = volume.sad_volume(
            le, re, d, cfg.win_size, "right", mean=True, channel_min=True
        )
    elif cfg.cost == "local_mean":
        vol_l = aggregate.local_mean_cost(le, re, arms_l, arms_r, d)
        # the mirrored right view flips along W only — row-local, same
        # global row window (models/cblsm.py's branch with tile offsets)
        vol_r = aggregate.local_mean_cost(
            re[:, ::-1], le[:, ::-1],
            aggregate.cross_arms(re[:, ::-1], cfg.arms, ro_ext, rows),
            aggregate.cross_arms(le[:, ::-1], cfg.arms, ro_ext, rows),
            d,
        )[:, :, ::-1]
    else:
        raise ValueError(f"unknown cost {cfg.cost!r}")

    if cfg.aggregation == "rect_mean":
        agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=cfg.arms.max_length)
        agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=cfg.arms.max_length)
        for _ in range(cfg.agg_passes - 1):
            if cfg.second_pass_left_arms:
                # stacked second pass, same as models/cblsm.py (shared left
                # arms -> one [2D, T, W] rect pass, half the gather picks)
                both = jnp.concatenate([agg_l, agg_r], axis=0)
                both = aggregate.rect_mean_aggregate(both, arms_l, max_span=cfg.arms.max_length)
                agg_l, agg_r = both[:d], both[d:]
            else:
                agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l, max_span=cfg.arms.max_length)
                agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r, max_span=cfg.arms.max_length)
    elif cfg.aggregation == "rect_mean_v4":
        vl, vr, vu, vd = aggregate.cblsm_arm_volumes(
            arms_l, arms_r, d, max_steps=cfg.arms.max_length
        )
        agg_l = aggregate.rect_mean_aggregate_volume(vol_l, vl, vr, vu, vd)
        agg_r = aggregate.rect_mean_aggregate_volume(vol_r, vl, vr, vu, vd)
    elif cfg.aggregation == "cross_two_pass":
        c_arms_l = aggregate.canonical_cross_arms(le, cfg.cross_params, ro_ext, rows)
        c_arms_r = aggregate.canonical_cross_arms(re, cfg.cross_params, ro_ext, rows)
        agg_l = aggregate.cross_aggregate(vol_l, c_arms_l, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
        agg_r = aggregate.cross_aggregate(vol_r, c_arms_r, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
    elif cfg.aggregation == "none":
        agg_l, agg_r = vol_l, vol_r
    else:
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
    return {
        "disp_left": crop_row_halo(wta.wta(agg_l, "min"), halo, 0),
        "disp_right": crop_row_halo(wta.wta(agg_r, "min"), halo, 0),
    }


_TILE_CORES = {
    "sad": _sad_tile,
    "ncc": _ncc_tile,
    "asw": _asw_tile,
    "ad_census": _ad_census_tile,
    "cblsm": _cblsm_tile,
}

_POST = {
    "sad": lambda dl, dr, cfg: sad_post(dl, dr, cfg),
    "asw": lambda dl, dr, cfg: (asw_post(dl, dr, cfg), None, None),
    "ad_census": lambda dl, dr, cfg: ad_census_post(dl, dr, cfg),
    "cblsm": lambda dl, dr, cfg: cblsm_post(dl, dr, cfg),
}


def _post_sharded(name: str):
    """Row-sharded post chains (`parallel.post_shard`) — lazy import to keep
    the module import graph acyclic."""
    from stereo_match_traditional_tpu.parallel import post_shard

    return {
        "ad_census": post_shard.ad_census_post_sharded,
        "cblsm": post_shard.cblsm_post_sharded,
        "asw": post_shard.asw_post_sharded,
        "sad": post_shard.sad_post_sharded,
    }.get(name)


def _check_tiled_support(name: str, cfg) -> None:
    """Reject unknown config variants with the same errors as the direct
    pipelines.  Rounds 3-4 closed every variant gap — ncc 'shifted', asw
    'lab' (Lab pair via aux inputs), the asw grid approximation
    (global-boundary-aware blurs) and every cblsm cost/aggregation run
    on the tiled and streamed executors."""
    if name == "ncc" and cfg.variant not in ("window", "shifted"):
        raise ValueError(f"unknown ncc variant {cfg.variant!r}")
    elif name == "asw" and cfg.variant not in ("bilateral", "lab"):
        raise ValueError(f"unknown asw variant {cfg.variant!r}")
    elif name == "asw" and getattr(cfg, "approx", "none") not in ("none", "grid"):
        raise ValueError(
            f"unknown ASW approx {cfg.approx!r}; expected 'none' or 'grid'"
        )
    elif (
        name == "asw"
        and cfg.variant == "lab"
        and getattr(cfg, "approx", "none") != "none"
    ):
        # same contract as the direct pipeline (models/asw.py): the grid
        # approximation is defined for the active bilateral variant only
        raise ValueError("approx='grid' is implemented for the active "
                         "bilateral variant, not variant='lab'")
    elif name == "ad_census" and cfg.aggregation not in (
        "rect_mean", "cross_two_pass", "none"
    ):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; "
            "expected 'rect_mean', 'cross_two_pass' or 'none'"
        )


def tiled_pipeline(
    name: str, cfg, mesh: Mesh, axis_name: str = "tile", shard_post: bool = False
):
    """Build a jittable ``(left, right) -> StereoResult`` running ``name``
    tile-data-parallel over ``mesh[axis_name]``.

    Rows are padded (edge-replicate) to a tile multiple; cost/aggregation/WTA
    run per tile under `shard_map` with exact halos.  Post-processing (when
    the pipeline config enables it) runs either on the gathered full maps
    (default — cheap at Teddy size) or, with ``shard_post=True``, row-sharded
    inside the same `shard_map` (`parallel.post_shard`): speckle components
    min-merge across tiles via `ppermute`, fills/medians run on halo'd tiles
    with global-border masking.  Sharded post is exact (same float ops per
    pixel) and keeps serving-size maps (720p+) from serializing on one
    device; it is implemented for ``ad_census``, ``cblsm`` and ``asw``
    (SAD's unbounded hole-fill rays admit no exact row-halo'd form).
    """
    _check_tiled_support(name, cfg)
    core = _TILE_CORES[name]
    halo = receptive_field_rows(name, cfg)
    n = mesh.shape[axis_name]
    canonical = name == "ad_census" and getattr(cfg, "aggregation", "") == "cross_two_pass"
    post_fn = _post_sharded(name) if shard_post else None
    sad_unbounded = name == "sad" and getattr(cfg, "fill_max_search", None) is None
    if shard_post and (post_fn is None or canonical or sad_unbounded):
        if sad_unbounded:
            raise NotImplementedError(
                "shard_post for SAD needs SADConfig(fill_max_search=...): "
                "the faithful unbounded hole-fill rays (`Sad.h:365`) have "
                "no exact row-halo'd form; opt into a ray cap (exact at "
                "that cap) or use the gathered default"
            )
        raise NotImplementedError(
            "shard_post is implemented for the legacy ad_census/cblsm/asw/"
            f"sad chains, not {'canonical ad_census' if canonical else repr(name)}"
            " (the canonical region voting's 5x-arm reach has no exact "
            "row-halo'd form; use the gathered default)"
        )

    def run(left, right, *aux):
        # ``aux``: extra per-pair images sharded/halo'd like left/right —
        # the asw 'lab' variant passes (left_lab, right_lab) here
        h, w = left.shape[:2]
        h_pad = -(-h // n) * n
        t = h_pad // n

        def padded(x):
            pad = [(0, h_pad - h)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, pad, mode="edge")

        lp, rp = padded(left), padded(right)
        ap = tuple(padded(a) for a in aux)

        def spec_of(x):
            return P(axis_name, *([None] * (x.ndim - 1)))

        out_spec = P(axis_name, None)

        def tile_fn(lt, rt, *at):
            idx = lax.axis_index(axis_name)
            ro_ext = idx * t - halo  # global row of the first extended row
            le = add_row_halo(lt, halo, axis_name)
            re = add_row_halo(rt, halo, axis_name)
            ae = tuple(add_row_halo(a, halo, axis_name) for a in at)
            out = core(le, re, cfg, ro_ext, h, halo, axis_name, ae)
            if post_fn is not None and getattr(cfg, "run_post", False):
                dmap, occl, mism = post_fn(
                    out["disp_left"], out["disp_right"], cfg, axis_name,
                    row_offset=idx * t, global_rows=h,
                )
                out = dict(out, disp_final=dmap, occlusion=occl, mismatch=mism)
            return out

        sharded = jax.shard_map(
            tile_fn,
            mesh=mesh,
            in_specs=(spec_of(left), spec_of(right)) + tuple(spec_of(a) for a in aux),
            out_specs=out_spec,
            check_vma=False,
        )
        tiles = sharded(lp, rp, *ap)
        disp_l = tiles["disp_left"][:h]
        disp_r = tiles.get("disp_right")
        if disp_r is not None:
            disp_r = disp_r[:h]

        disp_final = occl = mism = None
        if "disp_final" in tiles:
            disp_final = tiles["disp_final"][:h]
            occl = tiles.get("occlusion")
            mism = tiles.get("mismatch")
            occl = occl[:h] if occl is not None else None
            mism = mism[:h] if mism is not None else None
        elif getattr(cfg, "run_post", False) and name in _POST:
            if canonical:
                # canonical (ADCensusOption) post on the gathered maps:
                # LR at lrcheck_thres -> iterative region voting (arms
                # recomputed once from the full left image — [H, W] ints,
                # trivial next to the sharded volume work) -> optional
                # row-local discontinuity adjustment on the tile-sharded
                # aggregated left volume -> median; exactly
                # models.ad_census.ad_census_post_canonical
                from stereo_match_traditional_tpu.models.ad_census import (
                    ad_census_post_canonical, irv_auto_d_chunk,
                )

                arms_l = aggregate.canonical_cross_arms(left, cfg.cross_params)
                agg_full = tiles.get("agg_left")
                agg_arg = (
                    None if agg_full is None
                    else jnp.moveaxis(agg_full[:h], 0, 1)  # [D, H, W]
                )
                disp_final, occl, mism = ad_census_post_canonical(
                    disp_l, disp_r, agg_arg, arms_l, cfg,
                    irv_d_chunk=irv_auto_d_chunk(h, w, cfg.disp_range),
                )
            else:
                disp_final, occl, mism = _POST[name](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


_TILED_CACHE = {}


def run_tiled(
    name: str,
    left,
    right,
    cfg=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = "tile",
    shard_post: bool = False,
    aux=(),
) -> StereoResult:
    """One-shot convenience wrapper around :func:`tiled_pipeline`.

    The jitted program is cached per (name, cfg, mesh, axis) — configs are
    frozen dataclasses and meshes hash by device assignment, so repeated
    calls reuse the compiled executable instead of re-tracing.
    """
    if cfg is None:
        from stereo_match_traditional_tpu.models.registry import get_pipeline

        cfg = get_pipeline(name)[1]()
    if mesh is None:
        from stereo_match_traditional_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis_names=(axis_name,))
    key = (name, cfg, mesh, axis_name, shard_post)
    fn = _TILED_CACHE.get(key)
    if fn is None:
        fn = _TILED_CACHE[key] = jax.jit(
            tiled_pipeline(name, cfg, mesh, axis_name, shard_post=shard_post)
        )
    return fn(jnp.asarray(left), jnp.asarray(right), *(jnp.asarray(a) for a in aux))


# ---------------------------------------------------------------------------
# 2-D (tile x disp) flagship: rows data-parallel, disparity tensor-parallel
# ---------------------------------------------------------------------------


def _tile_disp_driver(mesh, tile_axis, disp_axis, halo, disp_range, body):
    """Shared 2-D ``(tile, disp)`` mesh scaffolding for the *_tile_disp
    runners: row padding to a tile multiple, halo exchange, local d-slice
    rounding, the shard_map wrapper, and the output crop.

    Non-divisible disparity ranges round the local slice up; ``body``
    receives the padded-slot mask (global d >= disp_range, shape
    [d_local, 1, 1]) and must mask those entries so the two-stage WTA never
    selects them.  ``body(le, re, ro_ext, rows, d_off, pad_mask)`` returns a
    dict of [T, W] maps; the driver returns ``(run_maps, d_local)`` where
    ``run_maps(left, right)`` yields the dict cropped to the true height.
    """
    n_t = mesh.shape[tile_axis]
    n_d = mesh.shape[disp_axis]
    if n_d > disp_range:
        raise ValueError(f"disp axis ({n_d}) larger than disp_range ({disp_range})")
    d_local = -(-disp_range // n_d)

    def run_maps(left, right):
        h, w = left.shape
        h_pad = -(-h // n_t) * n_t
        t = h_pad // n_t
        lp = jnp.pad(left, ((0, h_pad - h), (0, 0)), mode="edge")
        rp = jnp.pad(right, ((0, h_pad - h), (0, 0)), mode="edge")

        def tile_fn(lt, rt):
            idx_t = lax.axis_index(tile_axis)
            idx_d = lax.axis_index(disp_axis)
            ro_ext = idx_t * t - halo
            d_off = idx_d * d_local
            le = add_row_halo(lt, halo, tile_axis)
            re = add_row_halo(rt, halo, tile_axis)
            pad = ((d_off + jnp.arange(d_local)) >= disp_range)[:, None, None]
            return body(le, re, ro_ext, h, d_off, pad)

        sharded = jax.shard_map(
            tile_fn,
            mesh=mesh,
            in_specs=(P(tile_axis, None), P(tile_axis, None)),
            out_specs=P(tile_axis, None),
            check_vma=False,
        )
        return {k: v[:h] for k, v in sharded(lp, rp).items()}

    return run_maps, d_local


def ad_census_tile_disp(
    cfg: _cfg.ADCensusConfig, mesh: Mesh, tile_axis: str = "tile", disp_axis: str = "disp"
):
    """AD-Census over a 2-D mesh: rows sharded over ``tile_axis`` (halo
    exchange) and the disparity range sharded over ``disp_axis`` (each
    device builds its d-slice of the fused volume via the clamped-column
    gather, aggregates it independently — rectangle means are per-d-slice —
    and WTA combines with a two-stage `pmin`, `parallel.wta_shard`).

    Scanline optimization couples d±1 and is not supported with a sharded
    disparity axis; keep ``cfg.scanline=None`` here or use
    :func:`tiled_pipeline` with a 1-D mesh.
    """
    if cfg.scanline is not None:
        raise NotImplementedError(
            "ad_census_tile_disp does not implement scanline optimization "
            "(the SGM recurrence couples d±1 across the sharded axis); use "
            "tiled_pipeline with a 1-D tile mesh or gspmd_pipeline"
        )
    if cfg.aggregation != "rect_mean":
        raise NotImplementedError(
            f"ad_census_tile_disp implements aggregation='rect_mean' only "
            f"(got {cfg.aggregation!r}); use tiled_pipeline or gspmd_pipeline"
        )
    halo = receptive_field_rows("ad_census", cfg)

    def body(le, re, ro_ext, rows, d_off, pad_mask):
        d_local = pad_mask.shape[0]
        vol_l = volume.ad_census_volume(
            le, re, d_local, cfg.sigma_c, cfg.sigma_s,
            cfg.census_rows, cfg.census_cols, "left", ro_ext, rows, d_offset=d_off,
        )
        vol_r = volume.ad_census_volume(
            le, re, d_local, cfg.sigma_c, cfg.sigma_s,
            cfg.census_rows, cfg.census_cols, "right", ro_ext, rows, d_offset=d_off,
        )
        arms_l = aggregate.cross_arms(le, cfg.arms, ro_ext, rows)
        arms_r = aggregate.cross_arms(re, cfg.arms, ro_ext, rows)
        for _ in range(cfg.agg_iters):
            vol_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=cfg.arms.max_length)
            vol_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=cfg.arms.max_length)
        vol_l = jnp.where(pad_mask, jnp.inf, crop_row_halo(vol_l, halo, 1))
        vol_r = jnp.where(pad_mask, jnp.inf, crop_row_halo(vol_r, halo, 1))
        return {
            "disp_left": wta_sharded(vol_l, disp_axis, "min"),
            "disp_right": wta_sharded(vol_r, disp_axis, "min"),
        }

    run_maps, _ = _tile_disp_driver(
        mesh, tile_axis, disp_axis, halo, cfg.disp_range, body
    )

    def run(left, right):
        tiles = run_maps(left, right)
        disp_l = tiles["disp_left"]
        disp_r = tiles["disp_right"]
        disp_final = occl = mism = None
        if cfg.run_post:
            disp_final, occl, mism = ad_census_post(disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def ncc_tile_disp(
    cfg: _cfg.NCCConfig, mesh: Mesh, tile_axis: str = "tile", disp_axis: str = "disp"
):
    """NCC over a 2-D ``(tile, disp)`` mesh.

    NCC is the pipeline that most wants disparity sharding — its committed
    driver runs D=200 (`NCC/NCC_main.cpp:18`), 3.3x the other pipelines'
    range.  Rows shard over ``tile_axis`` with a ``win_size`` halo; each
    device builds its local d-slice of the correlation volume
    (`ops.volume.ncc_volume` with ``d_offset``) and a two-stage argmax
    (`wta_sharded` 'max') combines across devices.  Non-divisible ranges round
    the slice up and mask the padded entries to -inf.
    """
    _check_tiled_support("ncc", cfg)
    if cfg.variant != "window":
        raise NotImplementedError(
            f"ncc_tile_disp implements variant='window' only (got "
            f"{cfg.variant!r}: the shifted variant's per-offset argmax "
            "tracker is not a disparity-sharded reduction); use "
            "tiled_pipeline or gspmd_pipeline"
        )
    halo = receptive_field_rows("ncc", cfg)

    def body(le, re, ro_ext, rows, d_off, pad_mask):
        vol, interior = volume.ncc_volume(
            le, re, pad_mask.shape[0], cfg.win_size, cfg.invalid_mode, cfg.eps,
            row_offset=ro_ext, global_rows=rows, d_offset=d_off,
        )
        vol = jnp.where(pad_mask, -jnp.inf, crop_row_halo(vol, halo, 1))
        interior = crop_row_halo(interior, halo, 0)
        disp = wta_sharded(vol, disp_axis, "max")
        return {"disp_left": jnp.where(interior, disp, 0.0)}

    run_maps, _ = _tile_disp_driver(
        mesh, tile_axis, disp_axis, halo, cfg.disp_range, body
    )

    def run(left, right):
        return StereoResult(run_maps(left, right)["disp_left"])

    return run
