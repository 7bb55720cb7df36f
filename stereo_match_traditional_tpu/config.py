"""Per-pipeline configuration dataclasses.

Every constant defaults to the value hard-coded in the corresponding
reference driver (see SURVEY.md §2.7).  The reference has exactly one config
object (`CBLSM/adcensus_types.h:45-75`, constructed but unused at
`CBLSM/CBLSM.cpp:39`); here every pipeline gets a first-class config.

Quirk flags: the reference contains several catalogued bugs (racy OpenMP
reductions, `col=_row` in `CrossArm.cpp:265`, the NCC 0xff sentinel winning
argmax at `NCC/NCC.h:59,88`, the vertical-scan `l2` index at
`ScanlineOptimizer.h:238`).  Per SURVEY.md §7 we match *intended* semantics by
default; flags below let you flip individual quirks back on where they are
deterministic and representable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SADConfig:
    """SAD block matching (`SAD/SADmain.cpp:24-99`).

    Window is ``(2*(winsize+1)+1)^2`` = 9x9 for the default ``winsize=3``
    (`SAD/Sad.h:109,119`); images are replicate-padded by ``winsize+1``
    (`SAD/SADmain.cpp:47-48`).
    """

    max_disparity: int = 60          # SADmain.cpp:33
    winsize: int = 3                 # SADmain.cpp:34 (radius = winsize+1)
    uniqueness_eps: float = 0.01     # Sad.h:66
    lr_gate: float = 5.0             # Sad.h:192
    speckle_diff: float = 1.0        # SADmain.cpp:69
    speckle_area: int = 80           # SADmain.cpp:69
    subpixel: bool = False           # Sad.h:81-84 computes then discards
    compute_right: bool = False      # SADmain.cpp:67 (commented out)
    run_post: bool = False           # SADmain.cpp:68-79 (commented out)
    fill_max_search: Optional[int] = None  # opt-in hole-fill ray cap.  The
                                     # reference's SAD rays are UNBOUNDED
                                     # (`Sad.h:365`, unlike the dispRange cap
                                     # of `PostProcessing.h:169`); None keeps
                                     # that faithful default.  A cap changes
                                     # results only for pixels whose nearest
                                     # ray candidates sit >= cap steps away,
                                     # and is what makes the sharded post
                                     # exact (cap <= per-pass halo budget,
                                     # parallel.post_shard.sad_post_sharded)

    @property
    def radius(self) -> int:
        return self.winsize + 1


@dataclasses.dataclass(frozen=True)
class NCCConfig:
    """NCC window matching (`NCC/NCC_main.cpp:8-60`).

    ``invalid_mode='ignore'`` fixes the reference quirk where the 0xff
    invalid sentinel wins the similarity argmax near the left border
    (`NCC/NCC.h:59,88`); ``'sentinel'`` reproduces it.
    """

    disp_range: int = 200            # NCC_main.cpp:18
    win_size: int = 10               # NCC_main.cpp:17 (radius; window 21x21)
    invalid_mode: str = "ignore"     # 'ignore' | 'sentinel'
    eps: float = 1e-12               # guard for zero-variance windows
    variant: str = "window"          # 'window' (active, NCC.h:69-95) |
                                     # 'shifted' (dormant alt impl, NCC.h:117-272)
    alt_max_offset: int = 79         # NCC.h:121
    alt_kernel: int = 5              # NCC.h:122 (11x11 truncated window)
    alt_add_constant: bool = False   # NCC.h:128-131
    alt_depth_scale: int = 3         # NCC.h:262 (display scaling)


@dataclasses.dataclass(frozen=True)
class ASWConfig:
    """Adaptive-support-weight bilateral matching (`ASW/ASWeight.cpp:7-98`).

    The support window is ``2*win_size+3`` = 25x25 for ``win_size=11``
    (`ASW/ASWeight.cpp:43,50`); the inner cost radius is ``win_size+1``
    (`ASW/ASW.h:333`).
    """

    disp_range: int = 60             # ASWeight.cpp:44
    win_size: int = 11               # ASWeight.cpp:43 (window = 2*win_size+3)
    space_sigma: float = 50.0        # ASWeight.cpp:45
    color_sigma: float = 30.0        # ASWeight.cpp:46
    truncation: float = 40.0         # ASWeight.cpp:47 (T)
    lr_gate: float = 5.0             # ASW.h:115
    speckle_area: int = 40           # ASWeight.cpp:73 filterSpeckles(0,40,2)
    speckle_diff: float = 2.0        # ASWeight.cpp:73
    median_first: int = 5            # ASWeight.cpp:74
    median_second: int = 3           # ASWeight.cpp:78
    run_post: bool = True            # ASWeight.cpp:66-78 (active)
    use_pallas: Optional[bool] = None  # None = auto (the Triton kernel,
                                     # ops/kernels/asw_pallas, on the GPU;
                                     # the jnp scan elsewhere); True off
                                     # the GPU raises
    approx: str = "none"             # 'none' (exact, reference parity) |
                                     # 'grid' (opt-in intensity-binned
                                     # bilateral grid, non-parity — see
                                     # volume.asw_volume_approx_grid)
    approx_bins: int = 12            # intensity centers for approx='grid'
    variant: str = "bilateral"       # 'bilateral' (active) | 'lab' (dormant
                                     # Yoon-Kweon Lab weights, ASW.h:49-175;
                                     # requires Lab images at call time)
    lab_faithful_lut: bool = False   # reproduce the int((L+A+B)/3) LUT quirk

    @property
    def radius(self) -> int:
        """Support-window radius (`ASW/ASW.h:333` ``wins = winSize+1``)."""
        return self.win_size + 1


@dataclasses.dataclass(frozen=True)
class ScanlineConfig:
    """4-path scanline optimizer (`AD-CensusV1/ScanlineOptimizer.h:104-253`).

    ``faithful_vertical_l2`` reproduces the reference vertical-pass quirk
    where ``l2`` reads ``costLastPath[d+1]`` (`ScanlineOptimizer.h:238`),
    losing the d-1 transition on vertical paths.  Default False = canonical
    SGM on all four paths.

    ``penalty_scale`` (opt-in, NON-PARITY — same template as the ASW
    ``approx='grid'`` flag): the reference's P1=10/P2=150
    (`AD-CensusV1/main.cpp:28-29`) are calibrated for its 8-bit/D=60
    workload and over-smooth at serving disparity ranges.  ``None``
    (default) keeps the exact reference penalties; ``'auto'`` scales both
    by ``60 / disp_range`` (the reference calibration point,
    `main.cpp:24`); a float multiplies
    both directly.  Matches the adaptive-P2 *intent* of
    `ScanlineOptimizer.h:171` extended to the range dimension.
    """

    p1: float = 10.0                 # main.cpp:28
    p2: float = 150.0                # main.cpp:29 (adaptive: max(p1, p2/(|dI|+1)))
    faithful_vertical_l2: bool = False
    faithful_vertical_p2: bool = False  # ScanLineUpDown never updates grayLast
                                     # (ScanlineOptimizer.h:210,232): vertical
                                     # P2 adapts to the *column-start* pixel
    penalty_scale: Optional[object] = None  # None (parity) | 'auto' | float

    def effective_penalties(self, disp_range: int) -> Tuple[float, float]:
        """(P1, P2) after the opt-in ``penalty_scale`` — the single place
        every executor (direct, sharded, streamed) resolves the knob so
        they cannot drift."""
        if self.penalty_scale is None:
            scale = 1.0
        elif self.penalty_scale == "auto":
            scale = 60.0 / float(disp_range)   # reference D, main.cpp:24
        else:
            scale = float(self.penalty_scale)
        return self.p1 * scale, self.p2 * scale


@dataclasses.dataclass(frozen=True)
class CrossArmConfig:
    """Cross-arm growth (`AD-CensusV1/CrossArm.cpp:147-598`,
    `CBLSM/CBLSM.h:536-966`).

    Arm extends while the max channel diff vs. the *center* pixel stays
    within ``tao1`` for offsets <= ``sec_length`` and within ``tao2`` beyond,
    capped at ``max_length``; a failed first step still yields arm 1 when the
    pixel is >=2 away from the border (`CrossArm.cpp:186-196`).
    """

    tao1: int = 30                   # AD-CensusV1/main.cpp:27 (CBLSM: 25)
    tao2: int = 6                    # CrossArm.cpp:170 (hard-coded)
    max_length: int = 34             # CrossArm.cpp:171 / CBLSM.cpp:31
    sec_length: int = 17             # CrossArm.cpp:168 / CBLSM.cpp:32


@dataclasses.dataclass(frozen=True)
class CrossAggregatorParams:
    """Canonical two-pass cross aggregation, mirroring ``ADCensusOption``
    (`CBLSM/adcensus_types.h:45-75`) and the vendored ``CrossAggregator``
    (`CBLSM/cross_aggregator.cpp:76-394`)."""

    min_disparity: int = 0           # adcensus_types.h:67
    max_disparity: int = 64
    lambda_ad: float = 10.0          # adcensus_types.h:69
    lambda_census: float = 30.0
    cross_l1: int = 34               # adcensus_types.h:70
    cross_l2: int = 17
    cross_t1: int = 20               # adcensus_types.h:71
    cross_t2: int = 6
    so_p1: float = 1.0               # adcensus_types.h:72
    so_p2: float = 3.0
    so_tso: int = 15
    irv_ts: int = 20
    irv_th: float = 0.4
    lrcheck_thres: float = 1.0       # adcensus_types.h:73
    do_lr_check: bool = True
    do_filling: bool = True
    do_discontinuity_adjustment: bool = False
    num_iters: int = 4               # CBLSM.cpp:142 crossAggre.Aggregate(4)


@dataclasses.dataclass(frozen=True)
class ADCensusConfig:
    """Flagship AD-Census pipeline (`AD-CensusV1/main.cpp:13-121`).

    Active reference path: fused AD+Census cost -> cross-arm rectangle-mean
    aggregation (vertical-first) on left and right volumes -> WTA.  The
    dormant stages (scanline `main.cpp:86-89`, post `main.cpp:91-94`) are
    first-class here, off by default to mirror the committed driver.
    """

    disp_range: int = 60             # main.cpp:24
    sigma_c: float = 10.0            # main.cpp:26 (AD lambda)
    sigma_s: float = 30.0            # main.cpp:25 (census lambda)
    census_rows: int = 9             # AD-Census.h:167 (r in -4..4)
    census_cols: int = 7             # AD-Census.h:169 (c in -3..3)
    arms: CrossArmConfig = CrossArmConfig(tao1=30)   # main.cpp:27
    aggregation: str = "rect_mean"   # 'rect_mean' | 'cross_two_pass' | 'none'
    agg_iters: int = 1               # rect_mean passes per volume
    scanline: Optional[ScanlineConfig] = None        # main.cpp:86-89 dormant
    lr_gate: float = 2.0             # main.cpp:30
    speckle_diff: float = 1.0        # main.cpp:93
    speckle_area: int = 30           # main.cpp:93
    median_size: int = 3             # main.cpp:94
    run_post: bool = False           # main.cpp:91-94 dormant
    cross_params: CrossAggregatorParams = CrossAggregatorParams()


@dataclasses.dataclass(frozen=True)
class CBLSMConfig:
    """Cross-based local stereo matching (`CBLSM/CBLSM.cpp:13-213`).

    Active path: AD cost L+R -> rect-mean aggregation twice per volume
    (`CBLSM.cpp:146-150`) -> WTA.  ``second_pass_left_arms`` reproduces the
    reference quirk where the *right* volume's second pass reuses the left
    image's arms (`CBLSM.cpp:150`); default True = faithful (deterministic
    and cheap to match exactly).
    """

    disp_range: int = 60             # CBLSM.cpp:29
    win_size: int = 1                # CBLSM.cpp:28
    cost: str = "ad"                 # 'ad' (active, CBLSM.h:327-381) |
                                     # 'sad_mean' (dormant ComputeDispLeft/Right,
                                     # CBLSM.h:409-489) | 'sad_mean_v4' (dormant
                                     # color min-channel, CBLSM.h:494-532;
                                     # needs color inputs) | 'local_mean'
                                     # (dormant costAggregation, CBLSM.h:1048-1085)
    aggregation: str = "rect_mean"   # 'rect_mean' (active costAggregationV5) |
                                     # 'rect_mean_v4' (dormant disparity-
                                     # conditioned arm volumes, CBLSM.h:1128-1176)
                                     # | 'cross_two_pass' (vendored
                                     # CrossAggregator, CBLSM.cpp:138-143) |
                                     # 'none'
    cross_params: CrossAggregatorParams = CrossAggregatorParams()
    arms: CrossArmConfig = CrossArmConfig(tao1=25)   # CBLSM.cpp:30-32
    arm_prefilter_median: int = 3    # CBLSM.cpp:24-25 medianBlur(3)... arms
                                     # are computed on the *unfiltered* gray
                                     # (`CBLSM.cpp:64-67` uses imageL);
                                     # armImage L/R are computed then unused.
    agg_passes: int = 2              # CBLSM.cpp:146-150
    second_pass_left_arms: bool = True   # CBLSM.cpp:150 quirk
    lr_gate: float = 5.0             # CBLSM.cpp:155
    speckle_diff: float = 1.0        # CBLSM.cpp:161
    speckle_area: int = 50           # CBLSM.cpp:161
    median_size: int = 3             # CBLSM.cpp:162
    run_post: bool = False           # CBLSM.cpp:160-162 dormant


#: Reference-driver Teddy image geometry (Middlebury quarter size,
#: `SAD/SADmain.cpp:27-28` et al.): 450 wide x 375 tall.
TEDDY_SHAPE: Tuple[int, int] = (375, 450)


def disp_override_kw(cfg_cls, disp):
    """kwargs overriding the disparity-range field of ``cfg_cls``.

    The field name varies per pipeline (``disp_range`` everywhere except
    SAD's ``max_disparity``, `SAD/SADmain.cpp:33`); every CLI/bench/demo
    entry point shares this probe instead of re-implementing it.  Returns
    ``{}`` when ``disp`` is None.
    """
    if disp is None:
        return {}
    return {
        f: disp
        for f in ("disp_range", "max_disparity")
        if f in cfg_cls.__dataclass_fields__
    }
