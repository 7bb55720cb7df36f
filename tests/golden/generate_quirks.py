"""Regenerate the quirk-flag goldens (tests/golden/quirks_seed42.npz).

Run from the repo root after a *deliberate* behavior change:

    python tests/golden/generate_quirks.py

Each case freezes one catalogued reference quirk flag
so a regression in a non-default path trips the golden net, not just the
unit tests.
"""

import os

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from stereo_match_traditional_tpu import config as cfgs  # noqa: E402
from stereo_match_traditional_tpu.models import get_pipeline  # noqa: E402
from stereo_match_traditional_tpu.utils import io as io_utils  # noqa: E402
from stereo_match_traditional_tpu.utils.synthetic import make_pair  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quirks_seed42.npz")


def quirk_cases():
    """(name, pipeline, cfg, extra_kwargs) — shared with the golden test."""
    sl = cfgs.ScanlineConfig
    return [
        # vertical-pass l2 reads costLastPath[d+1] (ScanlineOptimizer.h:238)
        ("adc_vertical_l2", "ad_census",
         cfgs.ADCensusConfig(disp_range=10, scanline=sl(faithful_vertical_l2=True)), {}),
        # vertical P2 adapts to the column-start pixel (ScanlineOptimizer.h:210,232)
        ("adc_vertical_p2", "ad_census",
         cfgs.ADCensusConfig(disp_range=10, scanline=sl(faithful_vertical_p2=True)), {}),
        # the 0xff invalid sentinel wins the NCC argmax (NCC.h:59,88)
        ("ncc_sentinel", "ncc",
         cfgs.NCCConfig(disp_range=10, win_size=3, invalid_mode="sentinel"), {}),
        # right volume's second pass with its OWN arms (CBLSM.cpp:150 un-quirked)
        ("cblsm_own_arms", "cblsm",
         cfgs.CBLSMConfig(disp_range=10, second_pass_left_arms=False), {}),
        # canonical two-pass cross aggregation (vendored CrossAggregator)
        ("adc_cross_two_pass", "ad_census",
         cfgs.ADCensusConfig(disp_range=10, aggregation="cross_two_pass"), {}),
    ]


def lab_cases():
    """Dormant Lab-weight ASW variant, both LUT modes (ASW.h:49-175)."""
    Lc, Rc, _ = make_pair(48, 64, 10, seed=42, color=True)
    lab_l = io_utils.rgb_to_lab_u8(Lc)
    lab_r = io_utils.rgb_to_lab_u8(Rc)
    gray_l = io_utils.rgb_to_gray_u8(Lc)
    gray_r = io_utils.rgb_to_gray_u8(Rc)
    kw = dict(left_lab=jnp.asarray(lab_l), right_lab=jnp.asarray(lab_r))
    return [
        ("asw_lab", "asw",
         cfgs.ASWConfig(disp_range=10, win_size=2, variant="lab"), kw, gray_l, gray_r),
        ("asw_lab_faithful_lut", "asw",
         cfgs.ASWConfig(disp_range=10, win_size=2, variant="lab",
                        lab_faithful_lut=True), kw, gray_l, gray_r),
    ]


def main():
    L, R, _ = make_pair(48, 64, 10, seed=42)
    arrays = {}
    for name, pipe, cfg, kw in quirk_cases():
        fn, _ = get_pipeline(pipe)
        res = fn(jnp.asarray(L), jnp.asarray(R), cfg, **kw)
        for field in res._fields:
            v = getattr(res, field)
            if v is not None:
                arrays[f"{name}/{field}"] = np.asarray(v)
    for name, pipe, cfg, kw, gl, gr in lab_cases():
        fn, _ = get_pipeline(pipe)
        res = fn(jnp.asarray(gl), jnp.asarray(gr), cfg, **kw)
        for field in res._fields:
            v = getattr(res, field)
            if v is not None:
                arrays[f"{name}/{field}"] = np.asarray(v)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {len(arrays)} arrays -> {OUT}")


if __name__ == "__main__":
    main()
