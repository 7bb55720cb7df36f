"""Pipeline registry — the framework's "model zoo"."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from stereo_match_traditional_tpu import config as _cfg
from stereo_match_traditional_tpu.models.ad_census import ad_census_pipeline
from stereo_match_traditional_tpu.models.asw import asw_pipeline
from stereo_match_traditional_tpu.models.cblsm import cblsm_pipeline
from stereo_match_traditional_tpu.models.ncc import ncc_pipeline
from stereo_match_traditional_tpu.models.sad import sad_pipeline

PIPELINES: Dict[str, Tuple[Callable, Type]] = {
    "sad": (sad_pipeline, _cfg.SADConfig),
    "ncc": (ncc_pipeline, _cfg.NCCConfig),
    "asw": (asw_pipeline, _cfg.ASWConfig),
    "ad_census": (ad_census_pipeline, _cfg.ADCensusConfig),
    "cblsm": (cblsm_pipeline, _cfg.CBLSMConfig),
}


def get_pipeline(name: str):
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    return PIPELINES[name]


def finish_from_volumes(name: str, vol_l, vol_r, cfg, arms_left=None):
    """Re-enter a pipeline at the WTA stage from saved stage volumes
    (SURVEY.md §5 "any stage re-entrant").

    ``vol_l``/``vol_r`` are the ``aggregated_left``/``aggregated_right``
    (or ``cost_*`` for pipelines without aggregation) arrays a
    ``return_stages=True`` run produced — e.g. reloaded with
    `utils.checkpoint.load_array` after a failure — and the result matches
    the original run's disparity maps bit-for-bit.

    The canonical ad_census mode (``aggregation='cross_two_pass'`` with
    ``run_post``) additionally needs ``arms_left`` — the left arm maps its
    region-voting post fills from, saved by ``return_stages`` /
    ``--save-stages`` as ``arms_left_{left,right,up,down}``.  Pass an
    `ops.aggregate.Arms`, a 4-tuple in that field order, or a dict with
    those keys.
    """
    import jax.numpy as jnp

    from stereo_match_traditional_tpu.models.ad_census import (
        ad_census_post,
    )
    from stereo_match_traditional_tpu.models.base import StereoResult
    from stereo_match_traditional_tpu.models.cblsm import cblsm_post
    from stereo_match_traditional_tpu.models.sad import sad_post
    from stereo_match_traditional_tpu.ops import volume as _volume, wta

    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    vol_l = jnp.asarray(vol_l)
    vol_r = None if vol_r is None else jnp.asarray(vol_r)

    if name == "sad":
        disp_l = wta.optimal_disparity(vol_l, cfg.uniqueness_eps, cfg.subpixel)
        disp_r = None if vol_r is None else wta.wta(vol_r, "min")
        if cfg.run_post:
            fin, occl, mism = sad_post(disp_l, disp_r, cfg)
            return StereoResult(disp_l, disp_r, fin, occl, mism)
        return StereoResult(disp_l, disp_r)
    if name == "ncc":
        h, w = vol_l.shape[1:]
        interior = _volume.ncc_interior_mask(h, w, cfg.win_size)
        disp = jnp.where(interior, wta.wta(vol_l, "max"), 0.0)
        return StereoResult(disp)
    # asw / ad_census / cblsm: plain dual WTA + their post chains
    if vol_r is None:
        raise ValueError(
            f"finish_from_volumes({name!r}) needs both views' volumes "
            "(the reference driver computes left AND right maps); only "
            "'sad'/'ncc' re-enter from a left volume alone"
        )
    disp_l = wta.wta(vol_l, "min")
    disp_r = wta.wta(vol_r, "min")
    if name == "asw":
        from stereo_match_traditional_tpu.models.asw import asw_post

        fin = asw_post(disp_l, disp_r, cfg) if cfg.run_post else None
        return StereoResult(disp_l, disp_r, fin)
    if (
        name == "ad_census"
        and cfg.run_post
        and cfg.aggregation == "cross_two_pass"
    ):
        from stereo_match_traditional_tpu.models.ad_census import (
            ad_census_post_canonical, irv_auto_d_chunk,
        )
        from stereo_match_traditional_tpu.ops.aggregate import Arms

        if arms_left is None:
            raise ValueError(
                "finish_from_volumes: the canonical (cross_two_pass) post "
                "chain needs the left arm maps — pass arms_left= (saved by "
                "--save-stages / return_stages as arms_left_{left,right,"
                "up,down}), or finish with run_post=False"
            )
        if isinstance(arms_left, dict):
            arms = Arms(*(jnp.asarray(arms_left[k])
                          for k in ("left", "right", "up", "down")))
        elif isinstance(arms_left, Arms):
            arms = arms_left
        else:
            arms = Arms(*(jnp.asarray(a) for a in arms_left))
        fin, occl, mism = ad_census_post_canonical(
            disp_l, disp_r, vol_l, arms, cfg,
            irv_d_chunk=irv_auto_d_chunk(*disp_l.shape, cfg.disp_range),
        )
        return StereoResult(disp_l, disp_r, fin, occl, mism)
    post_fn = ad_census_post if name == "ad_census" else cblsm_post
    if cfg.run_post:
        fin, occl, mism = post_fn(disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, fin, occl, mism)
    return StereoResult(disp_l, disp_r)
