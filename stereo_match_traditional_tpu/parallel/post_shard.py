"""Row-sharded post-processing (SURVEY.md §5
"long-context / sequence parallelism").

`tiled_pipeline` historically gathered full disparity maps and ran L4
replicated — cheap at Teddy size, but at serving sizes (720p, D=128) a
replicated 20+ ms post chain erases the tile-DP gains.  This module runs
the whole chain inside `shard_map`:

* LR checks are row-local — direct per-tile.
* Speckle removal is a global connected-components problem: each tile
  floods locally with GLOBAL labels on a 1-row-halo extension (reusing
  `ops.post._speckle_sweep_fn`), then the fixpoint loop min-merges edge
  labels with its neighbors via `ppermute` each sweep — a component
  spanning k tiles converges in <= k exchanges; convergence is detected
  with a `psum` of the change flags.  Component areas are global
  histograms combined with `psum`.
* Hole filling chains three passes, each reading the previous pass's
  fills up to ``max_search-1`` rows away — every pass runs on its own
  fresh ``(max_search-1)``-row halo with the exact interior re-exchanged
  between passes (`fill_holes_8dir_sharded`), with rows beyond the global
  image masked invalid, so ray and border semantics match the untiled
  run exactly.  Medians run on a radius halo the same way.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from stereo_match_traditional_tpu.ops import post
from stereo_match_traditional_tpu.ops.post import (
    INVALID,
    _speckle_sweep_fn,
)


def _edge_from_prev(x_row, axis_name, fill):
    """Receive the neighbor-above's row (tile i gets tile i-1's row)."""
    from stereo_match_traditional_tpu.parallel.halo import _shift_down

    return _shift_down(x_row, axis_name, jnp.asarray(fill, x_row.dtype))


def _edge_from_next(x_row, axis_name, fill):
    """Receive the neighbor-below's row (tile i gets tile i+1's row)."""
    from stereo_match_traditional_tpu.parallel.halo import _shift_up

    return _shift_up(x_row, axis_name, jnp.asarray(fill, x_row.dtype))


def remove_speckles_sharded(
    disp: jax.Array,
    diff_insame: float,
    min_speckle_area: int,
    axis_name: str,
    row_offset,
    global_rows: int,
    invalid_value: float = INVALID,
    background: Optional[float] = None,
    max_iters: Optional[int] = None,
    connectivity: int = 8,
    plain_sweeps: int = 24,
) -> jax.Array:
    """Exact sharded `ops.post.remove_speckles` for a [T, W] row tile
    inside `shard_map`.

    ``row_offset`` is the tile's first global row (traced or static);
    rows at or beyond ``global_rows`` (the bottom tile's padding) are
    treated as invalid so padded runs can't glue components together.

    Labels are *global* flat indices.  Like the unsharded op, plain
    sweeping alone is unsound — a component whose min-label path crosses
    many run junctions (serpentine/staircase shapes) needs a sweep per
    junction, far beyond any fixed cap — so after 24 plain sweeps (real
    maps converge in <=20) a second phase adds a pointer jump
    (``label <- label[label]``) per sweep, resolving chains through an
    `all_gather` of the interior labels (1.5 MB at 720p); chain depth at
    least halves per jump, so ``max_iters=None`` derives a sound
    O(log(H*W)) phase-2 cap.
    """
    t, w = disp.shape
    plain_iters = plain_sweeps
    if max_iters is None:
        max_iters = plain_iters + 16 + 4 * max(1, (global_rows * w - 1).bit_length())
    d = disp.astype(jnp.float32)
    row_ids = row_offset + jnp.arange(t, dtype=jnp.int32)
    in_image = (row_ids < global_rows)[:, None]
    valid = jnp.isfinite(d) & (d != invalid_value) & in_image

    # 1-row halo of disparities/validity for cross-boundary connectivity.
    d_top = _edge_from_prev(d[-1:], axis_name, jnp.nan)
    d_bot = _edge_from_next(d[:1], axis_name, jnp.nan)
    v_top = _edge_from_prev(valid[-1:], axis_name, False)
    v_bot = _edge_from_next(valid[:1], axis_name, False)
    d_ext = jnp.concatenate([d_top, d, d_bot], axis=0)          # [T+2, W]
    v_ext = jnp.concatenate([v_top, valid, v_bot], axis=0)

    big = jnp.int32(global_rows * w)
    rows_ext = (row_offset - 1) + jnp.arange(t + 2, dtype=jnp.int32)
    idx_ext = rows_ext[:, None] * w + jnp.arange(w, dtype=jnp.int32)[None, :]
    labels0 = jnp.where(v_ext, idx_ext, big)

    sweep = _speckle_sweep_fn(d_ext, v_ext, diff_insame, connectivity, big)

    def _sweep_merge(labels):
        new = sweep(labels)
        # min-merge halo rows with the neighbors' freshly propagated
        # versions of the same global rows
        top = jnp.minimum(new[:1], _edge_from_prev(new[t : t + 1], axis_name, big))
        bot = jnp.minimum(new[t + 1 :], _edge_from_next(new[1:2], axis_name, big))
        return jnp.concatenate([top, new[1 : t + 1], bot], axis=0)

    def step(state):
        labels, _, it = state
        new = _sweep_merge(labels)
        changed = lax.psum(jnp.any(new != labels).astype(jnp.int32), axis_name)
        return new, changed > 0, it + 1

    def step_jump(state):
        labels, _, it = state
        new = _sweep_merge(labels)
        # pointer jump through the global label table: label[p] names a
        # pixel of p's own component (induction over sweeps), so following
        # it stays in-component and only decreases labels.  The interior
        # tiles concatenate in row order, so position r*w+c of the gather
        # IS global flat id r*w+c; ids >= big (bottom padding) never occur
        # as labels and the `big` sentinel maps to itself via the append.
        full = lax.all_gather(new[1 : t + 1], axis_name, axis=0, tiled=True)
        flat = jnp.concatenate([full.reshape(-1)[: global_rows * w], big[None]])
        new = jnp.minimum(new, flat[jnp.minimum(new, big)])
        changed = lax.psum(jnp.any(new != labels).astype(jnp.int32), axis_name)
        return new, changed > 0, it + 1

    # Phase 1: plain sweeps (no gather cost; real maps converge here).
    labels_ext, chg, it = lax.while_loop(
        lambda s: s[1] & (s[2] < min(plain_iters, max_iters)),
        step, (labels0, jnp.bool_(True), jnp.int32(0)),
    )
    # Phase 2: sweep + jump until the fixpoint (sound O(log) cap).
    labels_ext, _, _ = lax.while_loop(
        lambda s: s[1] & (s[2] < max_iters),
        step_jump, (labels_ext, chg, it),
    )
    labels = labels_ext[1 : t + 1]

    flat = jnp.where(valid, labels, big).reshape(-1)
    counts = jnp.zeros(global_rows * w + 1, jnp.int32).at[flat].add(
        valid.reshape(-1).astype(jnp.int32)
    )
    counts = lax.psum(counts, axis_name)
    area = counts[flat].reshape(t, w)
    kill = valid & (area < min_speckle_area)
    if background is not None:
        seed = (valid & (d != background)).reshape(-1).astype(jnp.int32)
        seeds = jnp.zeros(global_rows * w + 1, jnp.int32).at[flat].add(seed)
        seeds = lax.psum(seeds, axis_name)
        kill = kill & (seeds[flat].reshape(t, w) > 0)
    return jnp.where(kill, invalid_value, d)


def _mask_outside_rows(x, row_offset, global_rows, fill):
    rows = row_offset + jnp.arange(x.shape[0], dtype=jnp.int32)
    ok = ((rows >= 0) & (rows < global_rows))[:, None]
    return jnp.where(ok, x, jnp.asarray(fill, x.dtype))


def fill_holes_8dir_sharded(
    disp: jax.Array,
    occlusion: jax.Array,
    mismatch: jax.Array,
    axis_name: str,
    row_offset,
    global_rows: int,
    invalid_value: float = INVALID,
    max_search: int = None,
) -> jax.Array:
    """Exact sharded `ops.post.fill_holes_8dir` on [T, W] row tiles.

    Each of the three passes reads the *previous pass's* fills up to
    ``max_search - 1`` rows away, so the reach compounds across passes — a
    single up-front halo would need ``3*(max_search-1)`` rows to stay
    exact.  Instead every pass runs on a fresh ``(max_search-1)``-row halo
    and only the exact interior is kept and re-exchanged, so each pass's
    inputs are bit-identical to the untiled run's.  ``max_search=None``
    (the SAD chain's unbounded rays, `Sad.h:365`) has no halo'd form —
    use the gathered path.
    """
    if max_search is None:
        raise NotImplementedError(
            "unbounded hole-fill rays (max_search=None) have no exact "
            "row-halo'd form; run the gathered post chain instead"
        )
    from stereo_match_traditional_tpu.parallel.halo import add_row_halo

    t = disp.shape[0]
    max_axis = max(max_search - 1, 0)
    max_diag = int(round(max_axis * 0.70710678))
    halo = max_axis
    ro_ext = row_offset - halo

    d = jnp.where(disp == invalid_value, jnp.inf, disp.astype(jnp.float32))
    # (target mask, second_smallest): occlusions take the 2nd-smallest ray
    # candidate, mismatches the median, then remaining invalids the median
    # (`PostProcessing.h:172-190`)
    passes = [(occlusion, True), (mismatch, False), (None, False)]
    for tgt, second in passes:
        d_e = add_row_halo(d, halo, axis_name)
        # halo rows replicated past the global image behave like the
        # border: invalid, never candidates, never targets
        d_e = _mask_outside_rows(d_e, ro_ext, global_rows, jnp.inf)
        if tgt is None:
            te = ~jnp.isfinite(d_e)
            te = te & _mask_outside_rows(
                jnp.ones_like(te), ro_ext, global_rows, False
            )
        else:
            tgt_e = add_row_halo(tgt, halo, axis_name)
            tgt_e = _mask_outside_rows(tgt_e, ro_ext, global_rows, False)
            te = tgt_e & ~jnp.isfinite(d_e)
        d_e = post._fill_from_candidates(d_e, te, second, max_axis, max_diag)
        d = d_e[halo : halo + t]
    return jnp.where(jnp.isfinite(d), d, invalid_value)


def ad_census_post_sharded(
    disp_l: jax.Array,
    disp_r: jax.Array,
    cfg,
    axis_name: str,
    row_offset,
    global_rows: int,
):
    """The full AD-Census dormant post chain (`main.cpp:91-94` semantics as
    `models.ad_census.ad_census_post`) on [T, W] row tiles inside
    `shard_map`: LR consistency (row-local) -> sharded speckle removal ->
    per-pass-halo'd 8-direction hole fill -> halo'd truncate-border
    median."""
    from stereo_match_traditional_tpu.parallel.halo import add_row_halo

    t = disp_l.shape[0]
    lr = post.lr_check_consistency(
        disp_l, disp_r, cfg.lr_gate, post.INVALID, disp_range=cfg.disp_range
    )
    d = remove_speckles_sharded(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
        row_offset, global_rows, invalid_value=post.INVALID,
    )
    d = fill_holes_8dir_sharded(
        d, lr.occlusion, lr.mismatch, axis_name, row_offset, global_rows,
        invalid_value=post.INVALID, max_search=cfg.disp_range,
    )
    halo = cfg.median_size // 2
    ro_ext = row_offset - halo
    d_e = add_row_halo(d, halo, axis_name)
    d_e = _mask_outside_rows(d_e, ro_ext, global_rows, post.INVALID)
    d_e = post.median_filter(
        d_e, cfg.median_size, border="truncate",
        row_offset=ro_ext, global_rows=global_rows,
    )
    return d_e[halo : halo + t], lr.occlusion, lr.mismatch


def sad_post_sharded(
    disp_l: jax.Array,
    disp_r: jax.Array,
    cfg,
    axis_name: str,
    row_offset,
    global_rows: int,
):
    """`models.sad.sad_post` (`SADmain.cpp:68-79` semantics) on [T, W] row
    tiles: LR cross-check with occlusion/mismatch classes (row-local,
    `Sad.h:184-222`) -> sharded speckle removal with the zero-background
    seed rule (`Sad.h:265`) -> per-pass-halo'd 8-direction hole fill ->
    halo'd truncate-border median.

    Requires ``cfg.fill_max_search`` (the opt-in ray cap): the reference's
    SAD rays are unbounded (`Sad.h:365`) and admit no exact row-halo'd
    form, so `tiled_pipeline('sad', ..., shard_post=True)` rejects the
    faithful ``None`` default — with a cap the sharded chain is exact
    (bit-equal to `sad_post` at the same cap)."""
    from stereo_match_traditional_tpu.parallel.halo import add_row_halo

    if cfg.fill_max_search is None:
        raise NotImplementedError(
            "sad_post_sharded needs SADConfig(fill_max_search=...): the "
            "faithful unbounded hole-fill rays (`Sad.h:365`) have no exact "
            "row-halo'd form; use the gathered default or opt into a cap"
        )
    t = disp_l.shape[0]
    lr = post.lr_check_simple(
        disp_l, disp_r, cfg.lr_gate, post.INVALID, disp_range=cfg.max_disparity
    )
    d = remove_speckles_sharded(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
        row_offset, global_rows, invalid_value=post.INVALID,
        background=0.0,  # Sad.h:265 skips zero-disparity seeds
    )
    d = fill_holes_8dir_sharded(
        d, lr.occlusion, lr.mismatch, axis_name, row_offset, global_rows,
        invalid_value=post.INVALID, max_search=cfg.fill_max_search,
    )
    halo = 1  # sad_post's fixed median_filter(d, 3)
    ro_ext = row_offset - halo
    d_e = add_row_halo(d, halo, axis_name)
    d_e = _mask_outside_rows(d_e, ro_ext, global_rows, post.INVALID)
    d_e = post.median_filter(
        d_e, 3, border="truncate", row_offset=ro_ext, global_rows=global_rows
    )
    return d_e[halo : halo + t], lr.occlusion, lr.mismatch


def cblsm_post_sharded(
    disp_l: jax.Array,
    disp_r: jax.Array,
    cfg,
    axis_name: str,
    row_offset,
    global_rows: int,
):
    """`models.cblsm.cblsm_post` (LR -> speckles -> median) sharded."""
    from stereo_match_traditional_tpu.parallel.halo import add_row_halo

    t = disp_l.shape[0]
    lr = post.lr_check_consistency(
        disp_l, disp_r, cfg.lr_gate, post.INVALID, disp_range=cfg.disp_range
    )
    d = remove_speckles_sharded(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
        row_offset, global_rows, invalid_value=post.INVALID,
    )
    halo = cfg.median_size // 2
    ro_ext = row_offset - halo
    d_e = add_row_halo(d, halo, axis_name)
    d_e = _mask_outside_rows(d_e, ro_ext, global_rows, post.INVALID)
    d_e = post.median_filter(
        d_e, cfg.median_size, border="truncate",
        row_offset=ro_ext, global_rows=global_rows,
    )
    return d_e[halo : halo + t], lr.occlusion, lr.mismatch


def asw_post_sharded(
    disp_l: jax.Array,
    disp_r: jax.Array,
    cfg,
    axis_name: str,
    row_offset,
    global_rows: int,
):
    """`models.asw.asw_post` (`ASWeight.cpp:66-78`) on [T, W] row tiles:
    LR check writing 0 (row-local) -> global min-max u8 scale via
    pmin/pmax -> sharded 4-connectivity speckle filter -> medianBlur(5) ->
    `FillImageNew` (purely horizontal, row-local) -> medianBlur(3), the
    medians on a 3-row halo with shrinking-halo accounting (median5 output
    is exact on all but the outer 2 halo rows; median3 then consumes the
    remaining 1).

    OpenCV's BORDER_REPLICATE replicates the *current stage's* edge row,
    so between vertical-window stages every out-of-image row (top halo
    rows and the bottom tile's padding) is re-pointed at the processed
    global edge row with a clamped row gather — a stale replicate (e.g.
    pre-speckle values in the bottom padding, or a halo row that ran the
    median on a different window than the true edge row) would otherwise
    leak into the next median's window.

    The 8-direction hole fill of the SAD chain has *unbounded* ray reach
    (`Sad.h:365`), so `sad_post` has no exact row-halo'd form and keeps the
    gathered path.
    """
    t = disp_l.shape[0]
    lr = post.lr_check_simple(
        disp_l, disp_r, cfg.lr_gate, invalid_value=0.0, disp_range=cfg.disp_range
    )

    def _replicate_edges(x, first_row):
        # out-of-image rows take the in-image edge row's current value
        rows = first_row + jnp.arange(x.shape[0], dtype=jnp.int32)
        src = jnp.clip(rows, 0, global_rows - 1) - first_row
        return jnp.take(x, src, axis=0)

    # global cv::normalize(0,255,NORM_MINMAX) (`ASWeight.cpp:69`).  The
    # bottom tile's out-of-image padding rows hold values computed from
    # edge-replicated image rows (different window support than any real
    # row) and are only re-pointed at the true edge row *after* the speckle
    # stage — mask them out of the extrema or the scale silently differs
    # from the untiled run whenever a padding row attains the min/max.
    d = lr.disp
    rows = row_offset + jnp.arange(t, dtype=jnp.int32)
    in_image = (rows < global_rows)[:, None]
    lo = lax.pmin(jnp.min(jnp.where(in_image, d, jnp.inf)), axis_name)
    hi = lax.pmax(jnp.max(jnp.where(in_image, d, -jnp.inf)), axis_name)
    scale = jnp.where(hi > lo, 255.0 / (hi - lo), 0.0)
    d = jnp.round((d - lo) * scale)

    # filterSpeckles(0, 40, 2) semantics as in `models.asw.asw_post`
    d = remove_speckles_sharded(
        d, cfg.speckle_diff, cfg.speckle_area + 1, axis_name,
        row_offset, global_rows, invalid_value=0.0, connectivity=4,
    )
    d = _replicate_edges(d, row_offset)  # bottom padding: post-speckle edge

    halo = cfg.median_first // 2 + cfg.median_second // 2
    ro_ext = row_offset - halo
    from stereo_match_traditional_tpu.parallel.halo import add_row_halo

    d_e = add_row_halo(d, halo, axis_name)
    d_e = post.median_filter(d_e, cfg.median_first, border="replicate")
    d_e = _replicate_edges(d_e, ro_ext)  # median5'd edge, not halo's window
    d_e = post.fill_image_new(d_e)
    d_e = post.median_filter(d_e, cfg.median_second, border="replicate")
    return d_e[halo : halo + t], None, None
