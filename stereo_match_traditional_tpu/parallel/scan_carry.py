"""Sharded 4-direction scanline optimization (the sequence-parallel slot,
SURVEY.md §5 "long-context / sequence parallelism").

The reference's recurrence (`AD-CensusV1/ScanlineOptimizer.h:130-253`) runs
serially along each row/column.  Under row tiling the two *horizontal*
passes are embarrassingly parallel (each device owns whole rows), while the
two *vertical* passes would serialize across tiles.  Instead of handing
scan carries around a `ppermute` ring (which serializes the slice), the
volume is resharded with one `all_to_all` so each device owns whole
*columns*, the vertical passes run fully parallel over full-height columns,
and a second `all_to_all` restores row tiling.  Both reshards are single
collectives between devices; the
math is identical to the unsharded scan — no carry approximation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from stereo_match_traditional_tpu.config import ScanlineConfig
from stereo_match_traditional_tpu.ops.scanline import _canonical_pass, _directional_pass


def scanline_optimize_sharded(
    cost: jax.Array,
    gray: jax.Array,
    cfg: ScanlineConfig,
    axis_name: str,
    true_rows: int = None,
) -> jax.Array:
    """4-path scanline on a row-sharded volume inside shard_map.

    ``cost``: local ``[D, H_tile, W]`` (full width); ``gray``: ``[H_tile, W]``.
    ``true_rows`` is the unpadded global row count — when the image was
    padded to a multiple of the tile count, the vertical passes run on the
    real rows only (so the bottom-up scan starts at the true last row,
    matching the unsharded semantics) and the padded rows are re-appended as
    zeros before resharding back.
    """
    p1, p2 = cfg.effective_penalties(cost.shape[0])
    vert_dm1 = not cfg.faithful_vertical_l2
    vert_p2 = "first" if cfg.faithful_vertical_p2 else "prev"
    n = lax.axis_size(axis_name)
    d, h_t, w = cost.shape
    h_pad_total = h_t * n
    if true_rows is None:
        true_rows = h_pad_total

    # --- horizontal passes: rows are local, scan over W ------------------
    c_wdh = jnp.transpose(cost, (2, 0, 1))            # [W, D, H_t]
    g_wh = gray.astype(jnp.float32).T                 # [W, H_t]
    lr, _ = _directional_pass(c_wdh, g_wh, p1, p2, True)
    rl, _ = _directional_pass(c_wdh[::-1], g_wh[::-1], p1, p2, True)
    horiz = jnp.transpose(lr + rl[::-1], (1, 2, 0))   # [D, H_t, W]

    # --- vertical passes: reshard rows -> columns, scan over H -----------
    pad_w = (-w) % n
    cost_p = jnp.pad(cost, ((0, 0), (0, 0), (0, pad_w)))
    gray_p = jnp.pad(gray.astype(jnp.float32), ((0, 0), (0, pad_w)))
    # [D, H_t, Wp] -> [D, H, Wp/n]: every device gets all rows of its columns
    cost_c = lax.all_to_all(cost_p, axis_name, split_axis=2, concat_axis=1, tiled=True)
    gray_c = lax.all_to_all(gray_p, axis_name, split_axis=1, concat_axis=0, tiled=True)
    cost_c = cost_c[:, :true_rows]
    gray_c = gray_c[:true_rows]

    c_hdw = jnp.transpose(cost_c, (1, 0, 2))          # [H, D, W_t]
    ud, _ = _directional_pass(c_hdw, gray_c, p1, p2, vert_dm1, p2_ref=vert_p2)
    du, _ = _directional_pass(c_hdw[::-1], gray_c[::-1], p1, p2, vert_dm1, p2_ref=vert_p2)
    vert = jnp.transpose(ud + du[::-1], (1, 0, 2))    # [D, H, W_t]

    vert = jnp.pad(vert, ((0, 0), (0, h_pad_total - true_rows), (0, 0)))
    # [D, H, Wp/n] -> [D, H_t, Wp] and drop the width padding
    vert = lax.all_to_all(vert, axis_name, split_axis=1, concat_axis=2, tiled=True)
    return horiz + vert[:, :, :w]


def scanline_canonical_sharded(
    cost: jax.Array,
    base: jax.Array,
    match: jax.Array,
    p1: float,
    p2: float,
    tso: float,
    view: str,
    axis_name: str,
    true_rows: int = None,
) -> jax.Array:
    """Canonical tso-scheduled 4-path scanline on a row-sharded volume
    (`ops.scanline.scanline_optimize_canonical` under shard_map — the
    cross_two_pass / ADCensusOption family on the explicit-halo executor).

    Same reshard strategy as :func:`scanline_optimize_sharded`: horizontal
    passes are row-local; for the vertical passes the volume AND the
    per-disparity matched-image stack ``g2`` reshard rows -> columns with
    one ``all_to_all`` each (``g2`` is D-deep, so the canonical reshard
    moves ~2x the legacy bytes — the penalty schedule consults the matched
    image at every (pixel, d), `adcensus_types.h:72`).

    ``cost``: local [D, H_t, W]; ``base``/``match``: the local gray tile
    rows of the path-base and matched images (left/right for
    ``view='left'``).  ``g2`` is rebuilt per tile row-locally
    (`shifted_stack` shifts along W, which every tile owns in full).
    """
    from stereo_match_traditional_tpu.ops.volume import shifted_stack

    n = lax.axis_size(axis_name)
    d, h_t, w = cost.shape
    h_pad_total = h_t * n
    if true_rows is None:
        true_rows = h_pad_total
    g1 = base.astype(jnp.float32)
    g2 = shifted_stack(match.astype(jnp.float32), d, view)   # [D, H_t, W]

    # --- horizontal passes: rows local, scan over W -----------------------
    c_wdh = jnp.transpose(cost, (2, 0, 1))                   # [W, D, H_t]
    g1_wh = g1.T
    g2_wdh = jnp.transpose(g2, (2, 0, 1))
    lr = _canonical_pass(c_wdh, g1_wh, g2_wdh, p1, p2, tso)
    rl = _canonical_pass(c_wdh[::-1], g1_wh[::-1], g2_wdh[::-1], p1, p2, tso)
    horiz = jnp.transpose(lr + rl[::-1], (1, 2, 0))          # [D, H_t, W]

    # --- vertical passes: reshard rows -> columns -------------------------
    pad_w = (-w) % n
    cost_p = jnp.pad(cost, ((0, 0), (0, 0), (0, pad_w)))
    g1_p = jnp.pad(g1, ((0, 0), (0, pad_w)))
    g2_p = jnp.pad(g2, ((0, 0), (0, 0), (0, pad_w)))
    cost_c = lax.all_to_all(cost_p, axis_name, split_axis=2, concat_axis=1, tiled=True)
    g1_c = lax.all_to_all(g1_p, axis_name, split_axis=1, concat_axis=0, tiled=True)
    g2_c = lax.all_to_all(g2_p, axis_name, split_axis=2, concat_axis=1, tiled=True)
    cost_c = cost_c[:, :true_rows]
    g1_c = g1_c[:true_rows]
    g2_c = g2_c[:, :true_rows]

    c_hdw = jnp.transpose(cost_c, (1, 0, 2))                 # [H, D, W_t]
    g2_hdw = jnp.transpose(g2_c, (1, 0, 2))
    ud = _canonical_pass(c_hdw, g1_c, g2_hdw, p1, p2, tso)
    du = _canonical_pass(c_hdw[::-1], g1_c[::-1], g2_hdw[::-1], p1, p2, tso)
    vert = jnp.transpose(ud + du[::-1], (1, 0, 2))           # [D, H, W_t]

    vert = jnp.pad(vert, ((0, 0), (0, h_pad_total - true_rows), (0, 0)))
    vert = lax.all_to_all(vert, axis_name, split_axis=1, concat_axis=2, tiled=True)
    return (horiz + vert[:, :, :w]) * 0.25
