"""Flagship AD-Census pipeline (`AD-CensusV1/main.cpp:13-121`)."""

from __future__ import annotations

from typing import Optional


from stereo_match_traditional_tpu.config import ADCensusConfig
from stereo_match_traditional_tpu.models.base import StereoResult
from stereo_match_traditional_tpu.ops import aggregate, post, scanline, volume, wta
from stereo_match_traditional_tpu.utils.profiling import stage_scope


def ad_census_post(disp_l, disp_r, cfg: ADCensusConfig):
    """Dormant AD-Census post chain (`main.cpp:91-94`): LeftRightConsistency
    -> RemoveSpeckles -> 8-direction FillTheHole -> MedianFilter."""
    lr = post.lr_check_consistency(
        disp_l, disp_r, cfg.lr_gate, post.INVALID, disp_range=cfg.disp_range
    )
    dmap = post.remove_speckles(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID
    )
    dmap = post.fill_holes_8dir(
        dmap, lr.occlusion, lr.mismatch, post.INVALID, max_search=cfg.disp_range
    )
    dmap = post.median_filter(dmap, cfg.median_size, border="truncate")
    return dmap, lr.occlusion, lr.mismatch


def ad_census_pipeline(
    left,
    right,
    cfg: ADCensusConfig = ADCensusConfig(),
    left_color: Optional[object] = None,
    right_color: Optional[object] = None,
    return_stages: bool = False,
) -> StereoResult:
    """Active path (`main.cpp:58-84`): fused AD+Census volumes L+R ->
    cross arms per image -> vertical-first rectangle-mean aggregation ->
    WTA per volume.  Dormant stages made first-class:

    * ``cfg.scanline``: 4-path scanline optimization of the aggregated left
      volume + WTA (`main.cpp:86-89`);
    * ``cfg.run_post``: LeftRightConsistency -> RemoveSpeckles ->
      MedianFilter (`main.cpp:91-94`);
    * ``cfg.aggregation='cross_two_pass'``: the vendored CrossAggregator's
      exact two-pass cross aggregation (`CBLSM/cross_aggregator.cpp`) with
      ``cfg.cross_params`` — arms from the color image when provided.
      This mode is the *canonical* AD-Census family (`ADCensusOption`,
      `CBLSM/adcensus_types.h:45-75`), so its dormant fields drive the
      canonical components the reference only declares:
      ``so_p1/so_p2/so_tso`` parameterize the canonical tso-scheduled
      scanline (`scanline.scanline_optimize_canonical`, applied to BOTH
      volumes when ``cfg.scanline`` is set), ``irv_ts/irv_th`` the
      iterative region voting fill, ``lrcheck_thres/do_lr_check/
      do_filling/do_discontinuity_adjustment`` the canonical post chain
      (`post.iterative_region_voting`, `post.discontinuity_adjustment`)
      when ``cfg.run_post``.
    """
    d = cfg.disp_range
    with stage_scope("cost_volume"):
        vol_l = volume.ad_census_volume(
            left, right, d, cfg.sigma_c, cfg.sigma_s, cfg.census_rows, cfg.census_cols, "left"
        )
        vol_r = volume.ad_census_volume(
            left, right, d, cfg.sigma_c, cfg.sigma_s, cfg.census_rows, cfg.census_cols, "right"
        )

    if cfg.aggregation == "rect_mean":
        with stage_scope("aggregate"):
            arms_l = aggregate.cross_arms(left, cfg.arms)
            arms_r = aggregate.cross_arms(right, cfg.arms)
            agg_l, agg_r = vol_l, vol_r
            for _ in range(cfg.agg_iters):
                agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l, max_span=cfg.arms.max_length)
                agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r, max_span=cfg.arms.max_length)
    elif cfg.aggregation == "cross_two_pass":
        with stage_scope("aggregate"):
            img_l = left_color if left_color is not None else left
            img_r = right_color if right_color is not None else right
            arms_l = aggregate.canonical_cross_arms(img_l, cfg.cross_params)
            arms_r = aggregate.canonical_cross_arms(img_r, cfg.cross_params)
            agg_l = aggregate.cross_aggregate(vol_l, arms_l, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
            agg_r = aggregate.cross_aggregate(vol_r, arms_r, cfg.cross_params.num_iters,
                                          span_cap=cfg.cross_params.cross_l1)
    elif cfg.aggregation == "none":
        agg_l, agg_r = vol_l, vol_r
    else:
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; "
            "expected 'rect_mean', 'cross_two_pass' or 'none'"
        )

    canonical = cfg.aggregation == "cross_two_pass"
    if cfg.scanline is not None:
        with stage_scope("scanline"):
            if canonical:
                cp = cfg.cross_params
                agg_l = scanline.scanline_optimize_canonical(
                    agg_l, left, right, cp.so_p1, cp.so_p2, cp.so_tso, "left"
                )
                agg_r = scanline.scanline_optimize_canonical(
                    agg_r, left, right, cp.so_p1, cp.so_p2, cp.so_tso, "right"
                )
            else:
                agg_l = scanline.scanline_optimize(agg_l, left, cfg.scanline)

    with stage_scope("wta"):
        disp_l = wta.wta(agg_l, "min")
        disp_r = wta.wta(agg_r, "min")

    disp_final = None
    occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            if canonical:
                disp_final, occl, mism = ad_census_post_canonical(
                    disp_l, disp_r, agg_l, arms_l, cfg,
                    irv_d_chunk=irv_auto_d_chunk(*disp_l.shape, cfg.disp_range),
                )
            else:
                disp_final, occl, mism = ad_census_post(disp_l, disp_r, cfg)
    result = StereoResult(disp_l, disp_r, disp_final, occl, mism)
    if return_stages:
        stages = {
            "cost_left": vol_l, "cost_right": vol_r,
            "aggregated_left": agg_l, "aggregated_right": agg_r,
        }
        if canonical:
            # the canonical post re-enters from saved stages only with the
            # left arm maps (region-voting support regions); the rule
            # that produced them is cfg.cross_params
            for k in ("left", "right", "up", "down"):
                stages[f"arms_left_{k}"] = getattr(arms_l, k)
        return result, stages
    return result


def irv_auto_d_chunk(h: int, w: int, disp_range: int,
                     budget_bytes: float = 256e6):
    """``d_chunk`` for :func:`post.iterative_region_voting` at an [h, w]
    map: ``None`` (monolithic [D, H, W] histogram) while that fits in
    2x ``budget_bytes``, else enough disparity slices for ~``budget_bytes``
    of one-hots.  Chunking is bitwise-exact (see iterative_region_voting),
    so this is a pure memory/scheduling choice — at 4K/D=256 the
    monolithic histogram is 8.5 GB and cannot run on one chip.

    The 256 MB default is sized for the FUSED pipeline, where the
    histogram shares the device with band volumes.  When the post runs as
    its own program (the staged 4K canonical pattern,
    `parallel.streamed_canonical_staged`) bigger budgets mean fewer
    prefix-sum sweeps per iteration, same bits — e.g.
    ``budget_bytes=4.3e9`` (two chunks at 4K/D=256).

    The chunk rounds DOWN to a power of two: ragged chunk counts
    interact badly with the blocked cumsum's padding (d_chunk=129 at 4K
    compiled two 9.4 GB pad temporaries and OOM'd where 128 ran).  The
    MONOLITHIC cutover stays at the fixed 512 MB regardless of budget —
    a larger budget must grow the chunks, never select the monolithic
    [D, H, W] histogram (at 4K a 4.3 GB budget once crossed the 8.5 GB
    monolithic threshold and the program compiled 23.5 GB of full-image
    pm volumes); chunks also cap at half the disparity range so chunking
    stays a strict memory reduction."""
    if disp_range * h * w * 4 <= 512e6:
        return None
    raw = max(8, min(int(budget_bytes / (h * w * 4)), disp_range // 2))
    return 1 << (raw.bit_length() - 1)


def ad_census_post_canonical(disp_l, disp_r, agg_l, arms_l, cfg: ADCensusConfig,
                             irv_d_chunk=None):
    """Canonical post chain for the `cross_two_pass` (ADCensusOption) mode:
    LR check at ``lrcheck_thres`` -> iterative region voting fill ->
    optional discontinuity adjustment -> median.  Implements the semantics
    the vendored `adcensus_types.h:72-75` fields declare; each stage is
    gated by its canonical do_* flag.

    ``irv_d_chunk`` bounds the voting histogram's memory (exact — see
    :func:`post.iterative_region_voting`); the streamed executor sets it so
    the post never materializes ``[D, H, W]`` at serving sizes."""
    cp = cfg.cross_params
    d = disp_l
    occl = mism = None
    if cp.do_lr_check:
        lr = post.lr_check_consistency(
            disp_l, disp_r, cp.lrcheck_thres, post.INVALID,
            disp_range=cfg.disp_range,
        )
        d, occl, mism = lr.disp, lr.occlusion, lr.mismatch
    if cp.do_filling:
        d = post.iterative_region_voting(
            d, arms_l, cfg.disp_range, cp.irv_ts, cp.irv_th,
            invalid_value=post.INVALID, d_chunk=irv_d_chunk,
        )
    if cp.do_discontinuity_adjustment:
        d = post.discontinuity_adjustment(d, agg_l, post.INVALID)
    d = post.median_filter(d, cfg.median_size, border="truncate")
    return d, occl, mism
