"""Adaptive-support-weight pipeline (`ASW/ASWeight.cpp:7-98`)."""

from __future__ import annotations

import jax.numpy as jnp

from stereo_match_traditional_tpu.config import ASWConfig
from stereo_match_traditional_tpu.models.base import StereoResult
from stereo_match_traditional_tpu.ops import post, volume, wta
from stereo_match_traditional_tpu.ops.kernels import (
    asw_volume_pallas,
    resolve_use_pallas,
)
from stereo_match_traditional_tpu.utils.profiling import stage_scope


def _minmax_u8(x):
    """Device-side `cv::normalize(0,255,NORM_MINMAX)` + u8 convert
    (`ASWeight.cpp:69-72`), kept float for downstream ops."""
    lo = jnp.min(x)
    hi = jnp.max(x)
    scale = jnp.where(hi > lo, 255.0 / (hi - lo), 0.0)
    return jnp.round((x - lo) * scale)


def asw_post(disp_l, disp_r, cfg: ASWConfig):
    """Active ASW post chain (`ASWeight.cpp:66-78`): LR check writing 0
    (`ASW.h:108-145`) -> min-max scale to u8 (`ASWeight.cpp:69`) ->
    `filterSpeckles(0, 40, 2)` -> `medianBlur(5)` -> `FillImageNew` ->
    `medianBlur(3)`."""
    lr = post.lr_check_simple(
        disp_l, disp_r, cfg.lr_gate, invalid_value=0.0, disp_range=cfg.disp_range
    )
    d = _minmax_u8(lr.disp)
    d = post.remove_speckles(
        d, cfg.speckle_diff, cfg.speckle_area + 1, invalid_value=0.0,
        connectivity=4,
    )
    # OpenCV filterSpeckles removes blobs of size <= maxSpeckleSize (40)
    # using 4-connectivity; remove_speckles kills size < min_area, hence
    # the +1 above.
    d = post.median_filter(d, cfg.median_first, border="replicate")
    d = post.fill_image_new(d)
    d = post.median_filter(d, cfg.median_second, border="replicate")
    return d


def asw_pipeline(
    left, right, cfg: ASWConfig = ASWConfig(), left_lab=None, right_lab=None,
    return_stages: bool = False,
) -> StereoResult:
    """Active reference path (`ASWeight.cpp:60-78`):

    25x25 bilateral-weight truncated-AD volumes L+R -> WTA -> LR check
    (writes 0, `ASW.h:108-145`) -> min-max scale to u8 (`ASWeight.cpp:69`,
    which happens *before* the speckle filter, so the speckle diff of 2
    operates on scaled values — reproduced faithfully) ->
    `filterSpeckles(0, 40, 2)` -> `medianBlur(5)` -> `FillImageNew` ->
    `medianBlur(3)`.
    """
    kw = dict(
        disp_range=cfg.disp_range,
        win_size=cfg.win_size,
        space_sigma=cfg.space_sigma,
        color_sigma=cfg.color_sigma,
        truncation=cfg.truncation,
    )
    if cfg.variant == "lab":
        if cfg.approx != "none":
            raise ValueError("approx='grid' is implemented for the active "
                             "bilateral variant, not variant='lab'")
        # dormant Yoon-Kweon Lab-weight variant (`ASW/ASW.h:49-175`); the
        # driver would convert the color pair with cvtColor(CV_BGR2Lab)
        # (`ASWeight.cpp:33-34`, see utils.io.rgb_to_lab_u8)
        if left_lab is None or right_lab is None:
            raise ValueError("variant='lab' needs left_lab/right_lab images")
        with stage_scope("cost_volume"):
            vol_l = volume.asw_lab_volume(
                left, right, left_lab, right_lab, faithful_lut=cfg.lab_faithful_lut, **kw
            )
            # right view by the exact shift identity costR(q,d) = costL(q+d,d)
            # (volume.right_volume_from_left; the per-(p,d) cost truncation at
            # `ASW.h:171-173` commutes with the shift, so it holds here too)
            vol_r = volume.right_volume_from_left(vol_l)
        with stage_scope("wta"):
            disp_l = wta.wta(vol_l, "min")
            disp_r = wta.wta(vol_r, "min")
        with stage_scope("post"):
            disp_final = asw_post(disp_l, disp_r, cfg) if cfg.run_post else None
        result = StereoResult(disp_l, disp_r, disp_final)
        if return_stages:
            return result, {"cost_left": vol_l, "cost_right": vol_r}
        return result

    with stage_scope("cost_volume"):
        if cfg.approx == "grid":
            # opt-in constant-time approximation (non-parity; see
            # volume.asw_volume_approx_grid)
            vol_l = volume.asw_volume_approx_grid(
                left, right, bins=cfg.approx_bins, **kw
            )
        elif cfg.approx != "none":
            raise ValueError(
                f"unknown ASW approx {cfg.approx!r}; expected 'none' or 'grid'"
            )
        elif resolve_use_pallas(cfg.use_pallas):
            vol_l = asw_volume_pallas(left, right, view="left", **kw)
        else:
            vol_l = volume.asw_volume(left, right, **kw)
        # Right view (`ASW/ASW.h:382-431`) by the exact shift identity
        # costR(q,d) = costL(q+d,d) — one gather instead of a second full
        # cost-volume pass (see volume.right_volume_from_left).
        vol_r = volume.right_volume_from_left(vol_l)
    with stage_scope("wta"):
        disp_l = wta.wta(vol_l, "min")
        disp_r = wta.wta(vol_r, "min")

    disp_final = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final = asw_post(disp_l, disp_r, cfg)
    result = StereoResult(disp_l, disp_r, disp_final)
    if return_stages:
        return result, {"cost_left": vol_l, "cost_right": vol_r}
    return result
