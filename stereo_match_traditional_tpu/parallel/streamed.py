"""Single-chip memory-bounded streaming over row bands.

The reference allocates every volume densely and is capped by host RAM
(`AD-CensusV1/main.cpp:35-44` mallocs 6 full float volumes).  On one
device the dense [D, H, W] volume also caps the image size: 4K at D=256 is
8.5 GB per volume, and a pipeline keeps several such intermediates live.
This runner reuses the row-tile cores of :mod:`parallel.tiled` (same exact halos from
`receptive_field_rows`) but iterates the bands *sequentially inside one
XLA program* (`lax.map`) instead of sharding them over devices, so only
one band's intermediates are ever live.  That makes single-chip 4K/D=256
runs possible.

The legacy 4-path scanline optimizer streams too: its horizontal passes
are row-local, and the vertical recurrences carry
exactly ``(last aggregated row [D, W], its min [W])`` across bands — the
same carry `ops.scanline._scan_unrolled` returns.  Two band sweeps run
inside one XLA program: a backward `lax.scan` re-deriving each band's
aggregated volume and collecting the bottom-up pass's incoming carries
(only those [D, W] boundary rows are kept — never a full volume), then a
forward `lax.scan` that re-derives the volume once more, runs the two
horizontal passes plus both vertical band continuations, sums the four
directional volumes and WTAs.  The aggregation is computed twice per
band — the memory-for-FLOPs trade that makes scanline possible at sizes
where the dense [D, H, W] volume (8.5 GB at 4K/D=256) cannot exist.
The vertical band chains are bit-identical to the monolithic pass (the
recurrence is evaluated step-for-step in the same order; a d-constant
zero carry reproduces the path seed exactly), so streamed == direct up
to the band-local SAT tie-flip envelope below.

The canonical (cross_two_pass / ADCensusOption) family streams too: the
tso-scheduled penalties' D-deep matched-image stack
``g2 = shifted_stack(match, D)`` is column-shift-local, so a band's
slice ``[D, T+2, W]`` is computable from the band's matched rows — the
same footprint as the band cost volume.  The canonical scanline runs on
BOTH volumes (`models.ad_census_pipeline`), so the backward sweep chains
two bottom-up carries (left and right view) and the forward sweep runs
eight directional band passes (2 horizontal + 2 vertical continuations
per view), averaging as the monolithic pass does.  The canonical post
(LR at lrcheck_thres, iterative region voting over arms recomputed once
from the full left image, median) runs on the gathered maps exactly as
`parallel.tiled` does; the optional discontinuity adjustment — which
needs the aggregated left volume at the voted disparities — runs as a
third band sweep (the adjustment is row-local, `post.py`), re-deriving
each band's aggregated volume once more.

Equality: band-local SAT cumsums accumulate in a different order than the
full-image ones, so results match the untiled pipeline up to argmin tie
flips on near-exact cost ties (same envelope as the tiled invariance
tests); SAD is exact (no resharded reduction feeds its argmin).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from stereo_match_traditional_tpu.models.base import StereoResult
from stereo_match_traditional_tpu.ops import wta
from stereo_match_traditional_tpu.ops.scanline import (
    _canonical_pass,
    _directional_pass,
    canonical_pass_banded,
    canonical_scale,
    directional_pass_banded,
    rev_materialized,
)
from stereo_match_traditional_tpu.parallel.halo import crop_row_halo
from stereo_match_traditional_tpu.parallel.tiled import (
    _ad_census_band_volumes,
    _check_tiled_support,
    _POST,
    _TILE_CORES,
    receptive_field_rows,
)


def _device_memory_bytes(dev=None) -> float:
    """Memory JAX may allocate on ``dev`` (device 0 by default): the
    ``bytes_limit`` of ``memory_stats()``.  The CPU backend reports none,
    so there it is half the physical host memory; any other device that
    reports no limit is an error, not a guess."""
    dev = dev if dev is not None else jax.devices()[0]
    stats = dev.memory_stats()
    if stats and stats.get("bytes_limit"):
        return float(stats["bytes_limit"])
    if dev.platform == "cpu":
        import os

        return 0.5 * float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    raise RuntimeError(
        f"{dev.device_kind} ({dev.platform}) reports no memory limit in "
        "memory_stats(); pass row_tile= (or memory_bytes= to auto_row_tile) "
        "explicitly"
    )


def auto_row_tile(name: str, cfg, h: int, w: int, memory_bytes=None) -> int:
    """Pick the largest row band whose modeled live set fits the device —
    bigger bands amortize the halo recompute, so the optimum is the
    memory boundary.

    The model counts band-sized ``[t + 2*halo, D, W]`` float32 buffers
    live at once: ~6 for the legacy streamed scanline (the two sweeps'
    scan inputs and double-buffered outputs), ~4 per band row plus a
    ~9x(2*halo) fixed part for the canonical scanline (both views'
    aggregated and cost bands across the two sweeps, and the halo'd
    cross-aggregation working set), ~4 for the plain banded paths
    (`lax.map` double buffering and aggregation internals), against 70%
    (77% canonical) of device memory.  Its slopes were fitted to compiled
    programs of one earlier accelerator and are not tuned to this one; a
    caller can check the pick with ``lower(...).compile().memory_analysis()``
    before running it.
    """
    d = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", 1))
    halo = receptive_field_rows(name, cfg)
    canonical = name == "ad_census" and getattr(cfg, "aggregation", "") == "cross_two_pass"
    has_scanline = name == "ad_census" and getattr(cfg, "scanline", None) is not None
    frac = 0.77 if (has_scanline and canonical) else 0.70
    budget = frac * (memory_bytes if memory_bytes else _device_memory_bytes())
    row_bytes = d * w * 4.0
    rows_budget = budget / row_bytes          # total live rows affordable
    if has_scanline and canonical:
        t = (rows_budget - 9 * 2 * halo) / 4.0
    elif has_scanline:
        t = (rows_budget - 6 * 2 * halo) / 6.0
    else:
        t = (rows_budget - 4 * 2 * halo) / 4.0
    t = int(t // 8 * 8)
    if t < 16:
        raise ValueError(
            f"auto row_tile found no feasible band for {name!r} at "
            f"[{h}, {w}] D={d} (halo {halo}, ~{row_bytes / 1e6:.0f} MB per "
            "volume row); the workload exceeds single-chip streaming — "
            "shard it with tiled_pipeline/gspmd_pipeline instead"
        )
    return min(t, h)


def streamed_pipeline(name: str, cfg, row_tile=None):
    """Build a jittable ``(left, right) -> StereoResult`` running ``name``
    over sequential row bands of ``row_tile`` rows (plus exact halos).

    Peak live memory ~ one band's cost volume
    (``D x (row_tile + 2*halo) x W`` floats, double-buffered by XLA)
    instead of the full ``D x H x W`` volume.  ``row_tile=None`` picks the
    band height from the live-buffer model (:func:`auto_row_tile`) at
    trace time.

    The canonical FULL family also has a two-program form,
    :func:`streamed_canonical_staged` (this executor without ``run_post``,
    then the canonical post as a second jit on the maps — the same math
    with a program boundary in between).
    """
    _check_tiled_support(name, cfg)
    canonical = name == "ad_census" and cfg.aggregation == "cross_two_pass"
    if getattr(cfg, "scanline", None) is not None:
        if name != "ad_census":
            raise NotImplementedError(
                f"streamed scanline is implemented for ad_census, not {name!r}"
            )
        if canonical:
            return _ad_census_canonical_streamed(cfg, row_tile)
        return _ad_census_scanline_streamed(cfg, row_tile)
    core = _TILE_CORES[name]
    halo = receptive_field_rows(name, cfg)

    def run(left, right, *aux):
        # ``aux``: extra per-pair images banded like left/right (asw 'lab')
        h = left.shape[0]
        t = row_tile or auto_row_tile(name, cfg, h, left.shape[1])
        nb = -(-h // t)
        hp = nb * t

        def padded(x):
            pad = [(halo, hp - h + halo)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, pad, mode="edge")

        lp, rp = padded(left), padded(right)
        ap = tuple(padded(a) for a in aux)

        def band(b):
            le = lax.dynamic_slice_in_dim(lp, b * t, t + 2 * halo, 0)
            re = lax.dynamic_slice_in_dim(rp, b * t, t + 2 * halo, 0)
            ae = tuple(
                lax.dynamic_slice_in_dim(a, b * t, t + 2 * halo, 0) for a in ap
            )
            return core(le, re, cfg, b * t - halo, h, halo, None, ae)

        tiles = lax.map(band, jnp.arange(nb))

        def unband(x):
            return None if x is None else x.reshape((hp,) + x.shape[2:])[:h]

        disp_l = unband(tiles["disp_left"])
        disp_r = unband(tiles.get("disp_right"))

        disp_final = occl = mism = None
        if getattr(cfg, "run_post", False) and name in _POST:
            if canonical:
                disp_final, occl, mism = _canonical_post_streamed(
                    disp_l, disp_r, left, right, cfg, t
                )
            else:
                disp_final, occl, mism = _POST[name](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def streamed_canonical_staged(cfg, row_tile=None):
    """Two-program canonical executor for memory-bound scales.

    Program A = the streamed cross_two_pass + tso scanline + dual WTA
    (``streamed_pipeline`` with the post disabled); program B = the
    canonical post on the produced maps (:func:`_canonical_post_streamed`:
    rounded LR check, memory-aware d-chunked iterative region voting,
    optional discontinuity-adjustment band sweep, truncate median).
    Identical math to ``streamed_pipeline(cfg)`` with ``run_post=True`` —
    the split only moves a program boundary (the checkpoint re-entry
    surface), and each program is scheduled alone.  Returns a PYTHON
    callable dispatching two jitted programs; it is not itself jittable.
    """
    import dataclasses

    if getattr(cfg, "aggregation", "") != "cross_two_pass" or cfg.scanline is None:
        raise ValueError(
            "streamed_canonical_staged is the canonical (cross_two_pass + "
            "scanline) executor; use streamed_pipeline for other configs"
        )
    fn_a = jax.jit(streamed_pipeline(
        "ad_census", dataclasses.replace(cfg, run_post=False), row_tile))

    @jax.jit
    def fn_b(dl, dr, left, right):
        t = row_tile or auto_row_tile(
            "ad_census", cfg, left.shape[0], left.shape[1])
        return _canonical_post_streamed(dl, dr, left, right, cfg, t)

    def run(left, right):
        res = fn_a(left, right)
        fin, occl, mism = fn_b(res.disp_left, res.disp_right, left, right)
        return StereoResult(res.disp_left, res.disp_right, fin, occl, mism)

    return run


def _canonical_post_streamed(disp_l, disp_r, left, right, cfg, row_tile):
    """Canonical (ADCensusOption) post on the gathered maps, as
    `parallel.tiled` runs it: LR check at ``lrcheck_thres`` -> iterative
    region voting over arms recomputed once from the full left image
    ([H, W] ints, trivial next to the volume work) -> optional
    discontinuity adjustment -> median.  The adjustment needs the
    aggregated left volume at the voted disparities, which cannot be
    materialized at streaming sizes — it runs as a third band sweep
    (:func:`_discontinuity_adjustment_streamed`)."""
    from stereo_match_traditional_tpu.models.ad_census import (
        ad_census_post_canonical, irv_auto_d_chunk,
    )
    from stereo_match_traditional_tpu.ops import aggregate, post

    cp = cfg.cross_params
    arms_l = aggregate.canonical_cross_arms(left, cp)
    # Bound the IRV histogram (exact chunking, see
    # post.iterative_region_voting) — the full [D, H, W] histogram is
    # 8.5 GB at 4K/D=256 and was the one full-image volume left in the
    # streamed canonical path.  The budget is a quarter of device memory:
    # larger chunks mean fewer histogram sweeps.
    h, w = disp_l.shape
    dc = irv_auto_d_chunk(h, w, cfg.disp_range,
                          budget_bytes=0.25 * _device_memory_bytes())
    if not cp.do_discontinuity_adjustment:
        return ad_census_post_canonical(disp_l, disp_r, None, arms_l, cfg,
                                        irv_d_chunk=dc)
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
            invalid_value=post.INVALID, d_chunk=dc,
        )
    d = _discontinuity_adjustment_streamed(d, left, right, cfg, row_tile)
    d = post.median_filter(d, cfg.median_size, border="truncate")
    return d, occl, mism


def _discontinuity_adjustment_streamed(dmap, left, right, cfg, row_tile):
    """`post.discontinuity_adjustment` over sequential row bands: the
    adjustment is row-local (it consults a pixel's own aggregated costs at
    its own and its horizontal neighbors' disparities), so each band
    re-derives its aggregated left volume once and adjusts its rows —
    exact, never materializing the full [D, H, W] volume."""
    from stereo_match_traditional_tpu.ops import post

    if left.ndim != 2 or right.ndim != 2:
        raise ValueError(
            "streamed discontinuity adjustment takes grayscale [H, W] "
            f"inputs (got {left.ndim}-D); see _ad_census_canonical_streamed"
        )
    halo = receptive_field_rows("ad_census", cfg)
    t = row_tile
    h, w = dmap.shape
    nb = -(-h // t)
    hp = nb * t
    lp = jnp.pad(left, ((halo, hp - h + halo), (0, 0)), mode="edge")
    rp = jnp.pad(right, ((halo, hp - h + halo), (0, 0)), mode="edge")
    dp = jnp.pad(dmap, ((0, hp - h), (0, 0)), mode="edge")

    def band(b):
        le = lax.dynamic_slice_in_dim(lp, b * t, t + 2 * halo, 0)
        re = lax.dynamic_slice_in_dim(rp, b * t, t + 2 * halo, 0)
        agg_l, _ = _ad_census_band_volumes(le, re, cfg, b * t - halo, h)
        agg_l = crop_row_halo(agg_l, halo, 1)           # [D, t, W]
        db = lax.dynamic_slice_in_dim(dp, b * t, t, 0)  # [t, W]
        return post.discontinuity_adjustment(db, agg_l, post.INVALID)

    bands = lax.map(band, jnp.arange(nb))
    return bands.reshape(hp, w)[:h]


def _ad_census_canonical_streamed(cfg, row_tile: int):
    """Canonical AD-Census (cross_two_pass + tso-scheduled scanline on BOTH
    volumes + canonical post, `models.ad_census_pipeline`'s ADCensusOption
    mode) over sequential row bands on one chip — the canonical twin of
    :func:`_ad_census_scanline_streamed`.

    Same two-sweep band-carry design; per band and per view the penalties
    come from `ops.scanline.canonical_scale` evaluated on the band's gray
    rows plus a one-row halo and the band slice of the matched-image stack
    ``g2`` (`CBLSM/adcensus_types.h:72` semantics via
    `scanline.scanline_optimize_canonical`).  Addition order matches the
    monolithic pass — ``(lr + rl) + (ud + du)`` then ``* 0.25`` — so
    streamed == direct up to the band-local SAT tie-flip envelope.
    """
    cp = cfg.cross_params
    p1, p2, tso = cp.so_p1, cp.so_p2, float(cp.so_tso)
    halo = receptive_field_rows("ad_census", cfg)
    d = cfg.disp_range

    def run(left, right):
        if left.ndim != 2 or right.ndim != 2:
            raise ValueError(
                "the canonical streamed executor takes grayscale [H, W] "
                f"inputs (got {left.ndim}-D); color guidance is not "
                "plumbed through the band sweeps — convert with "
                "utils.io.rgb_to_gray_u8 or use the direct/tiled executors"
            )
        h, w = left.shape[:2]
        t = row_tile or auto_row_tile("ad_census", cfg, h, w)
        nb = -(-h // t)
        hp = nb * t
        pad = ((halo, hp - h + halo), (0, 0))
        lp = jnp.pad(left, pad, mode="edge")
        rp = jnp.pad(right, pad, mode="edge")

        def band_parts(b):
            """((agg, g, g2) per view) of band ``b``; ``g``/``g2`` carry a
            one-row halo (rows b*t-1 .. b*t+t) for the vertical penalties."""
            le = lax.dynamic_slice_in_dim(lp, b * t, t + 2 * halo, 0)
            re = lax.dynamic_slice_in_dim(rp, b * t, t + 2 * halo, 0)
            agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, b * t - halo, h)
            agg_l = crop_row_halo(agg_l, halo, 1)       # [D, t, W]
            agg_r = crop_row_halo(agg_r, halo, 1)
            gl = le[halo - 1:halo + t + 1].astype(jnp.float32)   # [t+2, W]
            gr = re[halo - 1:halo + t + 1].astype(jnp.float32)
            from stereo_match_traditional_tpu.ops.volume import shifted_stack

            g2l = shifted_stack(gr, d, "left")          # [D, t+2, W]
            g2r = shifted_stack(gl, d, "right")
            return (agg_l, gl, g2l), (agg_r, gr, g2r)

        def vert_inputs(agg, g, g2, up: bool):
            """(cost, scale) of one vertical band pass, [t, D, W] each (band
            rows reversed for the bottom-up pass).  The path-neighbor row
            (r-1 down, r+1 up) comes from the one-row halo."""
            lo, hi = (2, t + 2) if up else (0, t)
            sc = canonical_scale(
                g[1:t + 1], g[lo:hi],
                jnp.transpose(g2[:, 1:t + 1], (1, 0, 2)),
                jnp.transpose(g2[:, lo:hi], (1, 0, 2)),
                tso,
            )
            cost = jnp.transpose(agg, (1, 0, 2))        # [t, D, W]
            # bottom-up inputs reversed via the materializing helper
            # (scanline.rev_materialized)
            return rev_materialized(cost, sc) if up else (cost, sc)

        def horiz_band(agg, g, g2):
            """Sum of the two (row-local) horizontal passes, [t, D, W]."""
            c_wdt = jnp.transpose(agg, (2, 0, 1))       # [W, D, t]
            g1_wt = g[1:t + 1].T
            g2_wdt = jnp.transpose(g2[:, 1:t + 1], (2, 0, 1))
            lr_ = _canonical_pass(c_wdt, g1_wt, g2_wdt, p1, p2, tso)
            rl_ = _canonical_pass(
                *rev_materialized(c_wdt, g1_wt, g2_wdt), p1, p2, tso
            )
            return jnp.transpose(lr_ + rl_[::-1], (2, 1, 0))

        def reset_rows(b):
            return ((b * t + jnp.arange(t)) == h - 1)[::-1]

        zc = (jnp.zeros((d, w), jnp.float32), jnp.zeros((w,), jnp.float32))

        # Sweep 1 (backward over bands): chain BOTH views' bottom-up passes,
        # emitting each band's incoming carries.
        def sweep_up(carry, b_rev):
            cl, cr = carry
            b = nb - 1 - b_rev
            view_l, view_r = band_parts(b)
            rs = reset_rows(b)
            _, ncl = canonical_pass_banded(
                *vert_inputs(*view_l, up=True), cl, rs, p1, p2
            )
            _, ncr = canonical_pass_banded(
                *vert_inputs(*view_r, up=True), cr, rs, p1, p2
            )
            return (ncl, ncr), carry

        _, up_in_rev = lax.scan(sweep_up, (zc, zc), jnp.arange(nb))
        up_in = jax.tree_util.tree_map(lambda a: a[::-1], up_in_rev)

        # Sweep 2 (forward): re-derive the band volumes, run 2 horizontal +
        # 2 vertical band passes per view, average, WTA both views.
        def sweep_down(carry, xs):
            b, (ul, ur) = xs
            rs = reset_rows(b)
            view_l, view_r = band_parts(b)
            new_carry = []
            disps = []
            for view, dn_c, up_c in ((view_l, carry[0], ul), (view_r, carry[1], ur)):
                down, dn_out = canonical_pass_banded(
                    *vert_inputs(*view, up=False), dn_c, None, p1, p2
                )
                up, _ = canonical_pass_banded(
                    *vert_inputs(*view, up=True), up_c, rs, p1, p2
                )
                # the up-pass output flip is barriered too, out of the
                # down+horiz+wta consumer (see scanline.rev_materialized)
                total = (horiz_band(*view)
                         + (down + rev_materialized(up)[0])) * 0.25
                disps.append(wta.wta(jnp.transpose(total, (1, 0, 2)), "min"))
                new_carry.append(dn_out)
            return tuple(new_carry), tuple(disps)

        _, (dls, drs) = lax.scan(sweep_down, (zc, zc), (jnp.arange(nb), up_in))
        disp_l = dls.reshape(hp, w)[:h]
        disp_r = drs.reshape(hp, w)[:h]
        disp_final = occl = mism = None
        if cfg.run_post:
            disp_final, occl, mism = _canonical_post_streamed(
                disp_l, disp_r, left, right, cfg, t
            )
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def _ad_census_scanline_streamed(cfg, row_tile: int):
    """Full AD-Census — cost, aggregation, legacy 4-path scanline
    (`ScanlineOptimizer.h:104-253` semantics incl. both vertical quirk
    flags), WTA, optional post — over sequential row bands on one chip.

    See the module docstring for the two-sweep band-carry design.  Only
    ``O(nb * D * W)`` boundary carries and the ``[H, W]`` maps are ever
    materialized beyond one band's working set.
    """
    sl = cfg.scanline
    p1, p2_init = sl.effective_penalties(cfg.disp_range)
    vert_dm1 = not sl.faithful_vertical_l2
    vert_first = sl.faithful_vertical_p2
    halo = receptive_field_rows("ad_census", cfg)
    d = cfg.disp_range

    def p2_of(g_cur, g_ref):
        return jnp.maximum(p1, p2_init / (jnp.abs(g_cur - g_ref) + 1.0))

    def run(left, right):
        h, w = left.shape[:2]
        t = row_tile or auto_row_tile("ad_census", cfg, h, w)
        nb = -(-h // t)
        hp = nb * t
        pad = [(halo, hp - h + halo)] + [(0, 0)] * (left.ndim - 1)
        lp = jnp.pad(left, pad, mode="edge")
        rp = jnp.pad(right, pad, mode="edge")
        # path-start gray rows for the faithful_vertical_p2 ('first') quirk
        gf = lp[halo].astype(jnp.float32)          # global row 0
        gl = lp[halo + h - 1].astype(jnp.float32)  # global row h-1

        def band_parts(b):
            le = lax.dynamic_slice_in_dim(lp, b * t, t + 2 * halo, 0)
            re = lax.dynamic_slice_in_dim(rp, b * t, t + 2 * halo, 0)
            agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, b * t - halo, h)
            agg_l = crop_row_halo(agg_l, halo, 1)   # [D, t, W]
            agg_r = crop_row_halo(agg_r, halo, 1)
            g = le[halo:halo + t].astype(jnp.float32)           # band rows
            gp = le[halo - 1:halo + t - 1].astype(jnp.float32)  # row above
            gn = le[halo + 1:halo + t + 1].astype(jnp.float32)  # row below
            return agg_l, agg_r, g, gp, gn

        def up_inputs(b, agg_l, g, gn):
            """(cost, p2, reset) of the bottom-up pass, band rows reversed.

            The up-path 'prev' of global row r is row r+1 (gn from the
            halo); reset marks the true last image row so the padded tail
            rows (present only when h is not a band multiple) cannot leak
            into the real path — the step swaps in the exact identity
            carry there.
            """
            # reversed scan operands go through the materializing barrier
            # (scanline.rev_materialized), which keeps `reverse` out of the
            # banded scan's input fusion
            c_t = jnp.transpose(agg_l, (1, 0, 2))               # [t, D, W]
            p2_t = p2_of(g, gl[None] if vert_first else gn)
            rows_g = b * t + jnp.arange(t)
            return rev_materialized(c_t, p2_t, rows_g == h - 1)

        zc = (jnp.zeros((d, w), jnp.float32), jnp.zeros((w,), jnp.float32))

        # Sweep 1 (backward over bands): chain the bottom-up vertical pass,
        # emitting each band's INCOMING carry.  agg_r and the band outputs
        # are unused here and dead-code-eliminated by XLA — only the carry
        # chain's steps execute.
        def sweep_up(carry, b_rev):
            b = nb - 1 - b_rev
            agg_l, _, g, _, gn = band_parts(b)
            c_up, p2_up, reset_up = up_inputs(b, agg_l, g, gn)
            _, new_carry = directional_pass_banded(
                c_up, p2_up, carry, reset_up, p1, vert_dm1
            )
            return new_carry, carry

        _, up_in_rev = lax.scan(sweep_up, zc, jnp.arange(nb))
        up_in = jax.tree_util.tree_map(lambda a: a[::-1], up_in_rev)

        # Sweep 2 (forward): re-derive the band volume, run the two
        # horizontal passes (row-local) + both vertical continuations,
        # sum the four directional volumes, WTA both views.
        def sweep_down(carry, xs):
            b, up_c = xs
            agg_l, agg_r, g, gp, gn = band_parts(b)
            c_wdt = jnp.transpose(agg_l, (2, 0, 1))             # [W, D, t]
            g_wt = g.T
            lr_, _ = _directional_pass(c_wdt, g_wt, p1, p2_init, True)
            rl_, _ = _directional_pass(
                *rev_materialized(c_wdt, g_wt), p1, p2_init, True
            )  # barrier: see up_inputs
            horiz = jnp.transpose(lr_ + rl_[::-1], (2, 1, 0))   # [t, D, W]
            c_dn = jnp.transpose(agg_l, (1, 0, 2))              # [t, D, W]
            p2_dn = p2_of(g, gf[None] if vert_first else gp)
            down, carry = directional_pass_banded(
                c_dn, p2_dn, carry, None, p1, vert_dm1
            )
            c_up, p2_up, reset_up = up_inputs(b, agg_l, g, gn)
            up, _ = directional_pass_banded(
                c_up, p2_up, up_c, reset_up, p1, vert_dm1
            )
            # the up-result reverse is barriered as in the canonical twin
            total = horiz + down + rev_materialized(up)[0]      # [t, D, W]
            disp_l = wta.wta(jnp.transpose(total, (1, 0, 2)), "min")
            disp_r = wta.wta(agg_r, "min")
            return carry, (disp_l, disp_r)

        _, (dls, drs) = lax.scan(sweep_down, zc, (jnp.arange(nb), up_in))
        disp_l = dls.reshape(hp, w)[:h]
        disp_r = drs.reshape(hp, w)[:h]
        disp_final = occl = mism = None
        if cfg.run_post:
            disp_final, occl, mism = _POST["ad_census"](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


_STREAMED_CACHE = {}


def run_streamed(
    name: str, left, right, cfg=None, row_tile=None, aux=()
) -> StereoResult:
    """One-shot convenience wrapper (compiled program cached per config).
    ``row_tile=None`` auto-sizes the band (:func:`auto_row_tile`)."""
    if cfg is None:
        from stereo_match_traditional_tpu.models.registry import get_pipeline

        cfg = get_pipeline(name)[1]()
    key = (name, cfg, row_tile)
    fn = _STREAMED_CACHE.get(key)
    if fn is None:
        fn = _STREAMED_CACHE[key] = jax.jit(streamed_pipeline(name, cfg, row_tile))
    return fn(jnp.asarray(left), jnp.asarray(right), *(jnp.asarray(a) for a in aux))
