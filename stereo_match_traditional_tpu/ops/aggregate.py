"""Cost aggregation (layer L2): cross arms, rectangle-mean, two-pass cross.

The reference grows arms with per-pixel while-loops (`CrossArm.cpp:147-598`,
`CBLSM/CBLSM.h:536-966`, `cross_aggregator.cpp:135-269`) and aggregates with
O(arm^2) per-pixel rectangle loops (`CrossArm.cpp:60-145`,
`CBLSM.h:1179-1272`, `cross_aggregator.cpp:327-394`).  Here:

* arm growth = leading-ones count over a stack of <=34 masked threshold
  predicates (fully vectorized, SURVEY.md §2.6);
* rectangle-mean = summed-area table + 4 gathers, O(1)/pixel;
* two-pass cross = 1-D prefix sums + 2 gathers per pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from stereo_match_traditional_tpu.config import CrossArmConfig, CrossAggregatorParams


class Arms(NamedTuple):
    """Per-pixel cross-arm lengths, int32 [H, W] each."""

    left: jax.Array
    right: jax.Array
    up: jax.Array
    down: jax.Array


# ---------------------------------------------------------------------------
# arm growth (reference style: center-vs-pixel diff, two-threshold schedule)
# ---------------------------------------------------------------------------


def _max_channel_diff(a: jax.Array, b: jax.Array, color: bool) -> jax.Array:
    d = jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))
    if color:
        d = jnp.max(d, axis=-1)
    return d


def _directional_shifts(img: jax.Array, n: int, axis: int, sign: int) -> jax.Array:
    """values[o-1, i, j(, c)] = img shifted by o*sign along axis, edge-clamped."""
    size = img.shape[axis]
    pos = jnp.arange(size)
    offs = jnp.arange(1, n + 1)
    idx = jnp.clip(pos[None, :] + sign * offs[:, None], 0, size - 1)  # [n, size]
    out = jnp.take(img, idx, axis=axis)  # img axes with [n, size] inserted at `axis`
    return jnp.moveaxis(out, axis, 0)


def _arm_one_direction(
    img: jax.Array,
    cfg: CrossArmConfig,
    axis: int,
    sign: int,
    offset: int = 0,
    global_size: int = None,
) -> jax.Array:
    """Arm length along one direction, matching the reference loop
    (`CrossArm.cpp:147-260` pattern; parameterized as `CBLSM.h:536-750`).

    Offset o is accepted iff in-bounds and max channel diff vs the *center*
    pixel <= tao(o), where tao(o) = tao1 for o <= sec_length else tao2
    (the reference mutates a shared member when the schedule drops —
    `CrossArm.cpp:168-171` — a catalogued bug we do not reproduce).  Arm =
    number of leading accepted offsets, capped at max_length; a threshold
    failure at o=1 still yields arm 1 when the pixel is >=2 pixels from the
    border (`CrossArm.cpp:186-196`).

    ``offset``/``global_size`` give the tile's position inside the full
    image along ``axis`` so a halo-extended row tile inside `shard_map`
    applies the in-bounds and min-1 rules at the *global* borders and stays
    bit-identical to the untiled run (parallel.tiled).
    """
    n = cfg.max_length
    h_or_w = img.shape[axis]
    if global_size is None:
        global_size = h_or_w
    pos = jnp.arange(h_or_w) + offset  # global coordinates along `axis`
    inb = (
        pos[None, :] + sign * jnp.arange(1, n + 1)[:, None] >= 0
    ) & (pos[None, :] + sign * jnp.arange(1, n + 1)[:, None] <= global_size - 1)
    # broadcast in-bounds mask to [n, H, W]
    shape = [n, 1, 1]
    shape[axis + 1] = h_or_w
    inb = inb.reshape(shape)

    shifts = _directional_shifts(img, n, axis, sign)  # [n, H, W(, C)]
    diff = _max_channel_diff(shifts, img[None], color=img.ndim == 3)
    tao = jnp.where(
        jnp.arange(1, n + 1) <= cfg.sec_length, float(cfg.tao1), float(cfg.tao2)
    ).reshape(n, 1, 1)
    ok = inb & (diff <= tao)
    # Leading run of True: cumprod + sum lets XLA fuse the chain into the
    # shift producers (an argmin-for-first-False reduction would
    # materialize separately).
    leading = jnp.sum(jnp.cumprod(ok.astype(jnp.int32), axis=0), axis=0)

    # min-1 rule: first offset failed the threshold (not the border) and the
    # pixel is at least 2 from the border in this direction.
    fail1 = inb[0] & (diff[0] > tao[0])
    if sign < 0:
        border_ok = pos >= 2
    else:
        border_ok = pos <= global_size - 3
    shape2 = [1, 1]
    shape2[axis] = h_or_w
    border_ok = border_ok.reshape(shape2)
    return jnp.where((leading == 0) & fail1 & border_ok, 1, leading).astype(jnp.int32)


def cross_arms(
    img: jax.Array,
    cfg: CrossArmConfig,
    row_offset: int = 0,
    global_rows: int = None,
) -> Arms:
    """All four arms for one image (gray [H,W] or color [H,W,3]).

    Matches `ComputeLeft/Right/Top/ButtonArmLength` (`CrossArm.cpp:147-598`)
    and the parameterized `ArmLengthL/R/Up/Down` (`CBLSM.h:536-966`), with
    the `col=_row` right-arm bug (`CrossArm.cpp:265`) fixed per SURVEY §7.

    ``row_offset``/``global_rows`` position a row tile inside the full image
    (tile-DP, parallel.tiled) so the vertical arms respect global borders.
    """
    return Arms(
        left=_arm_one_direction(img, cfg, 1, -1),
        right=_arm_one_direction(img, cfg, 1, +1),
        up=_arm_one_direction(img, cfg, 0, -1, row_offset, global_rows),
        down=_arm_one_direction(img, cfg, 0, +1, row_offset, global_rows),
    )


# ---------------------------------------------------------------------------
# arm growth (canonical: vendored CrossAggregator rules)
# ---------------------------------------------------------------------------


def _canonical_arm_one_direction(
    img: jax.Array,
    params: CrossAggregatorParams,
    axis: int,
    sign: int,
    offset: int = 0,
    global_size: int = None,
) -> jax.Array:
    """Vendored-CrossAggregator arm rules (`cross_aggregator.cpp:135-269`):

    candidate n (0-based, pixel at offset n+1) extends the arm iff
      * in bounds,
      * ColorDist(candidate, center) < t1               (:169-172)
      * n > 0 implies ColorDist(candidate, previous) < t1  (:174-180)
      * n + 1 > L2 implies ColorDist(candidate, center) < t2 (:183-187)
    capped at min(L1, 255).
    """
    n = min(params.cross_l1, 255)
    h_or_w = img.shape[axis]
    if global_size is None:
        global_size = h_or_w
    pos = jnp.arange(h_or_w) + offset
    offs = jnp.arange(1, n + 1)
    inb = (pos[None, :] + sign * offs[:, None] >= 0) & (
        pos[None, :] + sign * offs[:, None] <= global_size - 1
    )
    shape = [n, 1, 1]
    shape[axis + 1] = h_or_w
    inb = inb.reshape(shape)

    color = img.ndim == 3
    shifts = _directional_shifts(img, n, axis, sign)
    d_center = _max_channel_diff(shifts, img[None], color)
    prev = jnp.concatenate([img[None], shifts[:-1]], axis=0)
    d_prev = _max_channel_diff(shifts, prev, color)

    ok = (d_center < params.cross_t1) & inb
    ok = ok & jnp.concatenate(
        [jnp.ones_like(ok[:1]), d_prev[1:] < params.cross_t1], axis=0
    )
    beyond_l2 = (offs[:, None, None] > params.cross_l2).reshape(n, 1, 1)
    ok = ok & (~beyond_l2 | (d_center < params.cross_t2))
    # cumprod+sum fuses best in-context (see _arm_one_direction's
    # negative-result note on the argmin alternative)
    return jnp.sum(jnp.cumprod(ok.astype(jnp.int32), axis=0), axis=0).astype(jnp.int32)


def canonical_cross_arms(
    img: jax.Array,
    params: CrossAggregatorParams,
    row_offset: int = 0,
    global_rows: int = None,
) -> Arms:
    """Arms per the vendored Ethan-Li CrossAggregator (`cross_aggregator.cpp:76-86`)."""
    return Arms(
        left=_canonical_arm_one_direction(img, params, 1, -1),
        right=_canonical_arm_one_direction(img, params, 1, +1),
        up=_canonical_arm_one_direction(img, params, 0, -1, row_offset, global_rows),
        down=_canonical_arm_one_direction(img, params, 0, +1, row_offset, global_rows),
    )


# ---------------------------------------------------------------------------
# rectangle-mean aggregation via summed-area tables
# ---------------------------------------------------------------------------


# Above this length the dense [n, n] triangle's O(n^2) MACs dominate
# (n=3841 is 23k flops/element at precision HIGHEST); switch to a two-level
# block decomposition: dense triangles inside blocks + a cumsum of block
# sums broadcast back.  At Teddy/720p widths the dense triangle stays, so
# the summation order changes (last ulp) at 4K-class widths only.  Both
# constants were chosen on an earlier accelerator (ROADMAP design item 3).
_CUMSUM_DENSE_MAX = 2048
_CUMSUM_BLOCK = 256


def _mxu_cumsum(x: jax.Array, axis: int) -> jax.Array:
    """Inclusive cumsum along ``axis`` (-1 or -2) as a triangular matmul.

    ``jnp.cumsum``'s log-shift lowering re-reads the operand ~log2(n)
    times; one [n, n] upper-triangular contraction streams it once.
    Precision HIGHEST (float32, never TF32 or bf16) — accumulation order
    differs from cumsum at the last ulp only.  Whether the matrix form
    pays on the GPU is ROADMAP speed item 3.

    Lengths above ``_CUMSUM_DENSE_MAX`` (4K widths) use the two-level
    blocked form — O(block) instead of O(n) MACs per element.
    """
    n = x.shape[axis]
    ax = axis if axis >= 0 else axis + x.ndim
    if x.ndim >= 2 and ax == x.ndim - 2:
        # reduce to the -1 case on swapped axes only for the blocked path;
        # dense stays as a single einsum (no transpose copies)
        if n > _CUMSUM_DENSE_MAX:
            return jnp.swapaxes(_mxu_cumsum(jnp.swapaxes(x, -1, -2), -1), -1, -2)
        tri = jnp.triu(jnp.ones((n, n), x.dtype))
        return jnp.einsum(
            "hi,...hw->...iw", tri, x, precision=jax.lax.Precision.HIGHEST
        )
    if ax != x.ndim - 1:
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    if n <= _CUMSUM_DENSE_MAX:
        tri = jnp.triu(jnp.ones((n, n), x.dtype))       # [i', i]: i' <= i
        return jnp.matmul(x, tri, precision=jax.lax.Precision.HIGHEST)
    b = _CUMSUM_BLOCK
    nb = -(-n // b)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nb * b - n)])
    xb = xp.reshape(x.shape[:-1] + (nb, b))
    tri = jnp.triu(jnp.ones((b, b), x.dtype))
    intra = jnp.matmul(xb, tri, precision=jax.lax.Precision.HIGHEST)
    off = _mxu_cumsum(intra[..., -1], -1)               # inclusive block sums
    off = jnp.pad(off, [(0, 0)] * (x.ndim - 1) + [(1, 0)])[..., :-1]
    out = intra + off[..., None]
    return out.reshape(x.shape[:-1] + (nb * b,))[..., :n]


def _sat(x: jax.Array) -> jax.Array:
    """Summed-area table with a zero border: S[..., i, j] = sum x[..., :i, :j].

    Rectangle sums are differences of f32 cumulants (~3e5 at the tail of a
    Teddy-sized AD-Census slice, ulp ~0.03) — a precision/throughput trade
    vs the reference's direct per-window summation, bounded by the
    bad-pixel-rate parity budget (SURVEY.md §4); revisit with compensated
    sums if volumes grow to unnormalized SAD magnitudes at 4K sizes.

    The cumsums run as triangular matmuls (:func:`_mxu_cumsum`).
    Summation order differs from cumsum in the last-ulp rounding, inside
    the stated SAT precision budget.
    """
    c = _mxu_cumsum(_mxu_cumsum(x, -1), -2)
    c = jnp.pad(c, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    return c


def _rect_gather(sat: jax.Array, i0, i1, j0, j1) -> jax.Array:
    """Inclusive rectangle sums from a SAT via 4 gathers; index arrays [H,W]."""
    return (
        sat[..., i1 + 1, j1 + 1]
        - sat[..., i0, j1 + 1]
        - sat[..., i1 + 1, j0]
        + sat[..., i0, j0]
    )


# Gather-source chunking for the rect corner picks (requires a static arm
# cap): above _GATHER_CHUNK_MIN_BYTES the picks run per haloed chunk of
# the SAT, targeting _GATHER_CHUNK_TARGET_BYTES per chunk but keeping the
# band >= 2x the halo (a band below the halo re-reads the source many
# times over) and never exceeding _GATHER_FAST_SRC_BYTES.  The sizes were
# chosen on an earlier accelerator's on-chip memory; whether chunking pays
# on the GPU is ROADMAP design item 3.
_GATHER_FAST_SRC_BYTES = 100 * 1024 * 1024
_GATHER_CHUNK_MIN_BYTES = 32 * 1024 * 1024
_GATHER_CHUNK_TARGET_BYTES = 24 * 1024 * 1024


def _rect_sums_shared_bounds(
    vol: jax.Array, i0, i1, j0, j1, max_span: Optional[int] = None
) -> jax.Array:
    """Inclusive rectangle sums of every d-slice with bounds shared across
    the disparity axis (arms depend on the pixel only).

    Gather layout: the [D, Hp, Wp] SAT is viewed as ``[(Hp*Wp), D]`` so
    every gathered element is a contiguous D-row instead of D x H x W
    scalar picks; the SAT cumsums themselves stay in [D, H, W].

    ``max_span``: static bound on the arm lengths.  When given and the flat
    SAT exceeds ``_GATHER_CHUNK_MIN_BYTES``, the four corner gathers run
    per row-chunk against a ``max_span``-haloed slice of the *global* SAT
    — bit-identical picks (chunk sizing at the constants above).
    """
    d = vol.shape[0]
    sat = _sat(vol)                                        # [D, Hp, Wp]
    hp, wp = sat.shape[-2:]
    out_shape = i0.shape
    h = out_shape[0]

    if max_span is not None and 4 * d * hp * wp > _GATHER_CHUNK_MIN_BYTES:
        halo = 2 * max_span + 1
        w_out = out_shape[1]
        # target ~24 MB chunks, floored so the band stays >= 2x the halo
        # (bounds halo re-reads) and capped at _GATHER_FAST_SRC_BYTES
        row_target = min(_GATHER_FAST_SRC_BYTES,
                         max(_GATHER_CHUNK_TARGET_BYTES, 4 * d * wp * 3 * halo))
        col_target = min(_GATHER_FAST_SRC_BYTES,
                         max(_GATHER_CHUNK_TARGET_BYTES, 4 * d * hp * 3 * halo))
        row_budget = row_target // (4 * d * wp) - halo
        col_budget = col_target // (4 * d * hp) - halo
        if row_budget >= 8 or row_budget >= col_budget:
            # chunk output rows; source = haloed row window of the SAT
            band = max(8, row_budget)
            outs = []
            for r0 in range(0, h, band):
                r1 = min(r0 + band, h)
                lo = max(0, r0 - max_span)
                hi = min(hp, r1 + max_span + 1)
                flat = sat[:, lo:hi].reshape(d, (hi - lo) * wp).T
                sl = slice(r0, r1)
                li0, li1 = i0[sl] - lo, i1[sl] + 1 - lo
                lj0, lj1 = j0[sl], j1[sl] + 1

                def g(ii, jj):
                    return flat[(ii * wp + jj).reshape(-1)]

                tot = g(li1, lj1) - g(li0, lj1) - g(li1, lj0) + g(li0, lj0)
                outs.append(tot.reshape((r1 - r0,) + out_shape[1:] + (d,)))
            return jnp.moveaxis(jnp.concatenate(outs, axis=0), -1, 0)
        # wide-and-short shapes (streamed 4K bands: 347 rows x 3841 cols x
        # D=256 — a single haloed row window is 276 MB): chunk output
        # COLUMNS instead; the column halo (max arm) amplifies reads far
        # less than re-reading halo rows per D-split
        cw = max(8, col_budget)
        outs = []
        for c0 in range(0, w_out, cw):
            c1 = min(c0 + cw, w_out)
            lo = max(0, c0 - max_span)
            hi = min(wp, c1 + max_span + 1)
            flat = sat[:, :, lo:hi].reshape(d, hp * (hi - lo)).T
            sl = (slice(None), slice(c0, c1))
            li0, li1 = i0[sl], i1[sl] + 1
            lj0, lj1 = j0[sl] - lo, j1[sl] + 1 - lo

            def g(ii, jj):
                return flat[(ii * (hi - lo) + jj).reshape(-1)]

            tot = g(li1, lj1) - g(li0, lj1) - g(li1, lj0) + g(li0, lj0)
            outs.append(tot.reshape((out_shape[0], c1 - c0, d)))
        return jnp.moveaxis(jnp.concatenate(outs, axis=1), -1, 0)

    flat = sat.reshape(d, hp * wp).T                       # [(Hp*Wp), D]

    # four separate gathers: one fused gather over the concatenated corner
    # indices interleaves far-apart corners and defeats coalescing
    def g(ii, jj):
        return flat[(ii * wp + jj).reshape(-1)]            # [H*W, D]

    out = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    return jnp.moveaxis(out.reshape(out_shape + (d,)), -1, 0)


# Pixel-major rect corner picks: SAT and picks in [H, W, D] with the
# disparity axis padded to a multiple of _RECT_PM_PAD, so the flat gather
# source is a FREE reshape and row chunks are FREE slices.  It was no
# faster than the d-major path at reference disparity ranges on an earlier
# accelerator, so _RECT_PM_AUTO stays False and layout='pixel_major'
# remains for cross-checks (ROADMAP design item 7).
_RECT_PM_AUTO = False
_RECT_PM_PAD = 64


def _rect_sums_pm(
    vol: jax.Array, i0, i1, j0, j1, max_span: Optional[int] = None,
    pad_to: int = _RECT_PM_PAD,
) -> jax.Array:
    """:func:`_rect_sums_shared_bounds` in pixel-major layout.

    ``vol`` [D, H, W] transposes ONCE to [H, W, Dp] (D zero-padded to a
    ``pad_to`` multiple — padded SAT columns are all zero and are sliced
    off after the picks); the SAT runs as the same HIGHEST-precision
    triangular contractions (cols then rows, the `_sat` order) on the pm
    layout, so values can differ from the d-major path in the final ulp
    of the SAT cancellation only.  Picks fetch contiguous D-rows from a
    free ``[(H+1)*(W+1), Dp]`` reshape; row chunks (same ~24 MB target /
    2x-halo floor / 100 MB cap rules) are free leading-axis slices.
    """
    d, h, w = vol.shape
    dp = -(-d // pad_to) * pad_to
    x = jnp.moveaxis(vol, 0, -1)                       # [H, W, D]
    if dp != d:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, dp - d)))
    c = jnp.pad(
        _cumsum_axis0(_mxu_cumsum(x, -2)), ((1, 0), (1, 0), (0, 0))
    )                                                  # [H+1, W+1, Dp]
    hp, wp = h + 1, -(-(w + 1) // 8) * 8
    # flat stride padded to a multiple of 8 — see _hsum_pm's STRIDE PAD note
    if wp != w + 1:
        c = jnp.pad(c, ((0, 0), (0, wp - (w + 1)), (0, 0)))
    if max_span is not None and 4 * dp * hp * wp > _GATHER_CHUNK_MIN_BYTES:
        halo = 2 * max_span + 1
        target = min(_GATHER_FAST_SRC_BYTES,
                     max(_GATHER_CHUNK_TARGET_BYTES, 4 * dp * wp * 3 * halo))
        band = max(8, target // (4 * dp * wp) - halo)
        outs = []
        for r0 in range(0, h, band):
            r1 = min(r0 + band, h)
            lo = max(0, r0 - max_span)
            hi = min(hp, r1 + max_span + 1)
            flat = c[lo:hi].reshape((hi - lo) * wp, dp)
            sl = slice(r0, r1)
            li0, li1 = i0[sl] - lo, i1[sl] + 1 - lo
            lj0, lj1 = j0[sl], j1[sl] + 1

            def g(ii, jj):
                return flat[(ii * wp + jj).reshape(-1)]

            tot = g(li1, lj1) - g(li0, lj1) - g(li1, lj0) + g(li0, lj0)
            outs.append(tot.reshape(r1 - r0, w, dp))
        out = jnp.concatenate(outs, axis=0)
    else:
        flat = c.reshape(hp * wp, dp)

        def g(ii, jj):
            return flat[(ii * wp + jj).reshape(-1)]

        out = (
            g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
        ).reshape(h, w, dp)
    return jnp.moveaxis(out[..., :d], -1, 0)


def rect_mean_aggregate(
    vol: jax.Array, arms: Arms, inclusive: bool = True,
    max_span: Optional[int] = None, layout: str = "auto",
) -> jax.Array:
    """Per-pixel arm-rectangle mean over each disparity slice.

    inclusive=True matches the active paths `AggregationVertical`
    (`CrossArm.cpp:60-102`, bounds -L..R x -up..down inclusive) and
    `costAggregationV5` (`CBLSM.h:1179-1224`); inclusive=False matches the
    dormant `Aggregation`/`costAggregationV4` exclusive-upper variants
    (`CrossArm.cpp:104-145`, `CBLSM.h:1128-1176`).  Arms never exceed the
    image by construction, so no clamping is required (and the reference's
    unclamped reads are in-bounds for correctly computed arms).

    O(1) per pixel: one SAT per slice + 4 gathers, instead of the
    reference's O(arm^2) inner loops.

    ``max_span``: static arm-length cap (``CrossArmConfig.max_length``)
    enabling the row-chunked gather source at serving sizes — bit-identical
    (see :func:`_rect_sums_shared_bounds`).

    ``layout``: ``'dmajor'`` (the documented [D, H, W] SAT + contiguous-
    D-row picks), ``'pixel_major'`` (:func:`_rect_sums_pm`), or ``'auto'``
    (currently d-major unless ``_RECT_PM_AUTO``; the pm variant differs in
    the last ulp of the SAT cancellation only).
    """
    h, w = vol.shape[-2], vol.shape[-1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    if inclusive:
        i0, i1 = ii - arms.up, ii + arms.down
        j0, j1 = jj - arms.left, jj + arms.right
        count = (arms.up + arms.down + 1) * (arms.left + arms.right + 1)
    else:
        i0, i1 = ii - arms.up, ii + arms.down - 1
        j0, j1 = jj - arms.left, jj + arms.right - 1
        count = (arms.up + arms.down) * (arms.left + arms.right)
    i0 = jnp.clip(i0, 0, h - 1)
    i1 = jnp.clip(i1, 0, h - 1)
    j0 = jnp.clip(j0, 0, w - 1)
    j1 = jnp.clip(j1, 0, w - 1)
    use_pm = layout == "pixel_major" or (layout == "auto" and _RECT_PM_AUTO)
    if use_pm and vol.ndim == 3:
        total = _rect_sums_pm(vol, i0, i1, j0, j1, max_span)
    else:
        total = _rect_sums_shared_bounds(vol, i0, i1, j0, j1, max_span)
    mean = total / jnp.maximum(count, 1).astype(vol.dtype)
    # empty exclusive regions at borders (e.g. up=down=0 at row 0) clip to a
    # spurious strip; the reference divides 0/0 there — keep the centre cost
    return jnp.where(count > 0, mean, vol)


# ---------------------------------------------------------------------------
# two-pass cross aggregation (canonical)
# ---------------------------------------------------------------------------


def _banded_pick(cs, off, o_lo: int, o_hi: int, axis: int, out_len: int):
    """``out[..., p, ...] = cs[..., p + off, ...]`` along ``axis``, where the
    per-element offset ``off`` (int array broadcastable to the output shape)
    is statically known to lie in ``[o_lo, o_hi]``.

    Realized as an unrolled chain of static shifts + selects instead of a
    per-element gather — the same trade as `post._banded_select_cols`.
    Bit-identical picks.

    Use it for 2-D [H, W] maps; on [D, H, W] volumes XLA does not fuse the
    ~70-step chain, so every step reads and writes the whole volume, which
    the contiguous-D-row gathers avoid.
    """
    m = cs.shape[axis]
    pad_lo = max(0, -o_lo)
    pad_hi = max(0, out_len - 1 + o_hi - (m - 1))
    pad = [(0, 0)] * cs.ndim
    pad[axis] = (pad_lo, pad_hi)
    csp = jnp.pad(cs, pad)

    def sh(o):
        sl = [slice(None)] * cs.ndim
        sl[axis] = slice(o + pad_lo, o + pad_lo + out_len)
        return csp[tuple(sl)]

    out = sh(o_lo)
    for o in range(o_lo + 1, o_hi + 1):
        out = jnp.where(off == o, sh(o), out)
    return out


def _hsum(
    x: jax.Array, left: jax.Array, right: jax.Array, max_arm: Optional[int] = None
) -> jax.Array:
    """sum_{t=-left..right} x[..., i, j+t] via a row prefix sum + 2 picks
    (`cross_aggregator.cpp:362-364`).

    ``max_arm``: static bound on the arm lengths (the growth rules cap at
    `CrossArmConfig.max_length` / `CrossAggregatorParams.cross_l1`).  When
    given, the prefix-sum picks are banded shift+select chains
    (:func:`_banded_pick`); when None, for [D, H, W] volumes the gather runs
    on a ``[(H*(W+1)), D]`` transposed view of the prefix sums — contiguous
    D-rows per pick (arm spans don't depend on d); see
    `_rect_sums_shared_bounds`.
    """
    w = x.shape[-1]
    cs = jnp.pad(_mxu_cumsum(x, -1), [(0, 0)] * (x.ndim - 1) + [(1, 0)])
    jj = jnp.arange(w)[None, :]
    hi = jnp.clip(jj + right + 1, 0, w)
    lo = jnp.clip(jj - left, 0, w)
    if max_arm is not None:
        hi_v = _banded_pick(cs, hi - jj, 1, max_arm + 1, -1, w)
        lo_v = _banded_pick(cs, lo - jj, -max_arm, 0, -1, w)
        return hi_v - lo_v
    if x.ndim == 2:
        return jnp.take_along_axis(cs, hi, -1) - jnp.take_along_axis(cs, lo, -1)
    d, h = x.shape[0], x.shape[1]
    if 4 * d * h * (w + 1) > _GATHER_FAST_SRC_BYTES:
        # row-chunked gather source (spans are row-local, so the picks are
        # exact; chunk size at _GATHER_FAST_SRC_BYTES).  Note XLA may still
        # retile the cumsum matmul when the consumer changes (last-ulp
        # scheduling drift).
        band = max(8, _GATHER_FAST_SRC_BYTES // (4 * d * (w + 1)))
        outs = []
        for r0 in range(0, h, band):
            r1 = min(r0 + band, h)
            flat = cs[:, r0:r1].reshape(d, (r1 - r0) * (w + 1)).T
            ii = jnp.arange(r1 - r0)[:, None]
            out = (
                flat[(ii * (w + 1) + hi[r0:r1]).reshape(-1)]
                - flat[(ii * (w + 1) + lo[r0:r1]).reshape(-1)]
            )
            outs.append(out.reshape(r1 - r0, w, d))
        return jnp.moveaxis(jnp.concatenate(outs, axis=0), -1, 0)
    flat = cs.reshape(d, h * (w + 1)).T                    # [(H*(W+1)), D]
    ii = jnp.arange(h)[:, None]
    out = flat[(ii * (w + 1) + hi).reshape(-1)] - flat[(ii * (w + 1) + lo).reshape(-1)]
    return jnp.moveaxis(out.reshape(h, w, d), -1, 0)


def _cumsum_axis0(x: jax.Array) -> jax.Array:
    """Inclusive cumsum along axis 0 as triangular matrix contractions —
    the leading-axis twin of :func:`_mxu_cumsum` (pixel-major volumes put
    rows first, so neither -1 nor -2 is the scan axis).  Same two-level
    blocking above ``_CUMSUM_DENSE_MAX``; precision HIGHEST."""
    n = x.shape[0]
    if n <= _CUMSUM_DENSE_MAX:
        tri = jnp.triu(jnp.ones((n, n), x.dtype))
        return jnp.einsum("qi,q...->i...", tri, x, precision=jax.lax.Precision.HIGHEST)
    b = _CUMSUM_BLOCK
    nb = -(-n // b)
    xp = jnp.pad(x, [(0, nb * b - n)] + [(0, 0)] * (x.ndim - 1))
    xb = xp.reshape((nb, b) + x.shape[1:])
    tri = jnp.triu(jnp.ones((b, b), x.dtype))
    intra = jnp.einsum("qi,nq...->ni...", tri, xb, precision=jax.lax.Precision.HIGHEST)
    off = _cumsum_axis0(intra[:, -1])
    off = jnp.pad(off, [(1, 0)] + [(0, 0)] * (off.ndim - 1))[:-1]
    out = intra + off[:, None]
    return out.reshape((nb * b,) + x.shape[1:])[:n]


# Pixel-major ([H, W, D]) volume span sums: at serving disparity ranges
# (D >= 128) the [D, H, W] gather path's per-chunk [D, rows, W] ->
# [(rows*W), D] transposes dominate — at a 4K canonical band they move
# ~4 GB per pass.  Pixel-major keeps D minor end to end: the flat gather
# source is a FREE reshape, row chunks are FREE slices, and every pick
# still fetches one contiguous D-row.
_CROSS_PM_MIN_D = 128


def _hsum_pm(x: jax.Array, left: jax.Array, right: jax.Array) -> jax.Array:
    """:func:`_hsum` on a pixel-major volume: x [H, W, D], arms [H, W] ->
    [H, W, D].  Prefix sums along W (``_mxu_cumsum(-2)``), picks from the
    free ``[(H*(W+1)), D]`` reshape, row-chunked at ``_GATHER_FAST_SRC_BYTES``
    with FREE slices (no transposes anywhere — the point of this path).

    STRIDE PAD: the prefix tensor's middle axis pads to a multiple of 8
    before the ``[rows, stride, D] -> [rows*stride, D]`` chunk reshapes.
    An earlier compiler executed the chunked gathers incorrectly with the
    natural odd stride W+1 at 4K widths; the pad is bit-identical (the
    padded tail rows are never indexed, hi <= W < stride).  Whether the
    GPU needs it is ROADMAP design item 2."""
    h, w, d = x.shape
    cs = jnp.pad(_mxu_cumsum(x, -2), ((0, 0), (1, 0), (0, 0)))  # [H, W+1, D]
    stride = -(-(w + 1) // 8) * 8
    if stride != w + 1:
        cs = jnp.pad(cs, ((0, 0), (0, stride - (w + 1)), (0, 0)))
    jj = jnp.arange(w)[None, :]
    hi = jnp.clip(jj + right + 1, 0, w)
    lo = jnp.clip(jj - left, 0, w)
    band = max(8, _GATHER_FAST_SRC_BYTES // (4 * d * stride))
    outs = []
    for r0 in range(0, h, band):
        r1 = min(r0 + band, h)
        flat = cs[r0:r1].reshape((r1 - r0) * stride, d)
        ii = jnp.arange(r1 - r0)[:, None]
        out = (
            flat[(ii * stride + hi[r0:r1]).reshape(-1)]
            - flat[(ii * stride + lo[r0:r1]).reshape(-1)]
        )
        outs.append(out.reshape(r1 - r0, w, d))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def _vsum_pm(
    x: jax.Array, up: jax.Array, down: jax.Array, max_arm: int
) -> jax.Array:
    """:func:`_vsum` on a pixel-major volume: span sums along rows.  The
    row-bound picks are row-local (arms are capped at ``max_arm``), so row
    chunks slice a ``max_arm``-haloed window of the prefix tensor — again
    a FREE leading-axis slice.  The flat stride pads to a multiple of 8
    for general (odd-W) inputs — see :func:`_hsum_pm`'s STRIDE PAD note."""
    h, w, d = x.shape
    cs = jnp.pad(_cumsum_axis0(x), ((1, 0), (0, 0), (0, 0)))    # [H+1, W, D]
    stride = -(-w // 8) * 8
    if stride != w:
        cs = jnp.pad(cs, ((0, 0), (0, stride - w), (0, 0)))
    ii = jnp.arange(h)[:, None]
    jj = jnp.arange(w)[None, :]
    hi = jnp.clip(ii + down + 1, 0, h)
    lo = jnp.clip(ii - up, 0, h)
    band = max(8, _GATHER_FAST_SRC_BYTES // (4 * d * stride) - (2 * max_arm + 1))
    outs = []
    for r0 in range(0, h, band):
        r1 = min(r0 + band, h)
        s0 = max(0, r0 - max_arm)
        s1 = min(h + 1, r1 + max_arm + 1)
        flat = cs[s0:s1].reshape((s1 - s0) * stride, d)
        out = (
            flat[((hi[r0:r1] - s0) * stride + jj).reshape(-1)]
            - flat[((lo[r0:r1] - s0) * stride + jj).reshape(-1)]
        )
        outs.append(out.reshape(r1 - r0, w, d))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def _vsum(
    x: jax.Array, up: jax.Array, down: jax.Array, max_arm: Optional[int] = None
) -> jax.Array:
    """sum_{t=-up..down} x[..., i+t, j] (`cross_aggregator.cpp:367-369`).

    The banded path picks along the row axis directly (no transposes);
    the gather path transposes to reuse `_hsum`'s contiguous-D-row layout.
    """
    if max_arm is not None:
        h = x.shape[-2]
        cs = jnp.pad(
            _mxu_cumsum(x, -2), [(0, 0)] * (x.ndim - 2) + [(1, 0), (0, 0)]
        )
        ii = jnp.arange(h)[:, None]
        hi = jnp.clip(ii + down + 1, 0, h)
        lo = jnp.clip(ii - up, 0, h)
        hi_v = _banded_pick(cs, hi - ii, 1, max_arm + 1, -2, h)
        lo_v = _banded_pick(cs, lo - ii, -max_arm, 0, -2, h)
        return hi_v - lo_v
    xt = jnp.swapaxes(x, -1, -2)
    return jnp.swapaxes(_hsum(xt, up.T, down.T), -1, -2)


# Dense 0/1 band tensors cost 4*H*W*(H+W) bytes; above this cap the gather
# path wins on memory (e.g. 720p would need ~7 GB of bands).
_MM_BAND_LIMIT_BYTES = 800 * 1024 * 1024


def _hsum_mm(x_pm: jax.Array, band_h: jax.Array) -> jax.Array:
    """Arm-span row sums as a batched matmul: ``out[h,w,d] =
    sum_q band_h[h,w,q] * x[h,q,d]`` with the 0/1 band built from the arms."""
    return jnp.einsum(
        "hwq,hqd->hwd", band_h, x_pm, precision=jax.lax.Precision.HIGHEST
    )


def _vsum_mm(x_pm: jax.Array, band_v: jax.Array) -> jax.Array:
    """Arm-span column sums: ``out[h,w,d] = sum_q band_v[h,w,q] * x[q,w,d]``."""
    return jnp.einsum(
        "hwq,qwd->hwd", band_v, x_pm, precision=jax.lax.Precision.HIGHEST
    )


def _arm_bands(arms: Arms) -> Tuple[jax.Array, jax.Array]:
    """0/1 band tensors for :func:`_hsum_mm` / :func:`_vsum_mm`:
    ``band_h[h,w,q] = 1 iff w-left <= q <= w+right`` (q over columns) and
    ``band_v[h,w,q] = 1 iff h-up <= q <= h+down`` (q over rows)."""
    h, w = arms.left.shape
    qc = jnp.arange(w)[None, None, :]
    jj = jnp.arange(w)[None, :, None]
    band_h = (
        (qc >= jj - arms.left[:, :, None]) & (qc <= jj + arms.right[:, :, None])
    ).astype(jnp.float32)
    qr = jnp.arange(h)[None, None, :]
    ii = jnp.arange(h)[:, None, None]
    band_v = (
        (qr >= ii - arms.up[:, :, None]) & (qr <= ii + arms.down[:, :, None])
    ).astype(jnp.float32)
    return band_h, band_v


def cross_aggregate(
    vol: jax.Array,
    arms: Arms,
    num_iters: int = 4,
    horizontal_first: bool = True,
    max_arm: Optional[int] = None,
    method: str = "auto",
    span_cap: Optional[int] = None,
) -> jax.Array:
    """Iterative two-pass cross aggregation (`cross_aggregator.cpp:89-118,
    327-394`): each iteration sums along one axis inside each pixel's arm
    span, then along the other axis inside the arm span of the *first-pass*
    result, normalizes by the matching support-pixel count
    (`cross_aggregator.cpp:271-325`), and flips the pass order.

    ``method``:

    * ``'matmul'`` — each arm-span sum is a batched matmul against a
      dense 0/1 band tensor built once from the arms, in a pixel-major
      ``[H, W, D]`` layout.  The prefix-sum gather path pays ~3 full-volume
      layout movements per pass (compiled HLO shows a transpose on every
      gather result plus a ``[H*W, D]`` copy per pass, inserted by layout
      assignment); the matmul path replaces picks + copies with dense
      matrix work and *direct* span sums (no SAT cancellation; WTA tie
      flips differ from the gather path on ~0.02% of pixels).
    * ``'gather'`` — row/column prefix sums + contiguous-D-row picks
      (:func:`_hsum` / :func:`_vsum`) in the documented ``[D, H, W]``
      layout.  Always honored verbatim (the exactness cross-check escape
      hatch — never silently rerouted).
    * ``'pixel_major'`` — the serving-range ``[H, W, D]`` passes
      (:func:`_hsum_pm` / :func:`_vsum_pm`): zero per-pass layout moves.
    * ``'auto'`` — matmul for ``[D, H, W]`` volumes while the band tensors
      fit ``_MM_BAND_LIMIT_BYTES``; else pixel-major for
      ``D >= _CROSS_PM_MIN_D``; gather otherwise (at 720p the dense
      bands would need ~7 GB).

    ``max_arm``: static arm-length cap (`CrossAggregatorParams.cross_l1`
    for canonical arms) that switches the gather path's span sums to the
    banded select chain — bit-identical to plain gathers (see
    :func:`_hsum`).  NOTE: on volumes this is *slower* (see
    :func:`_banded_pick`) and it also disables the 'auto' matmul path; it
    exists for exactness cross-checks, not speed — leave it None in
    production calls (every pipeline does).

    ``span_cap``: static bound on the arm lengths used ONLY to size the
    pixel-major path's row-chunk halos (exact — picks clip identically);
    unlike ``max_arm`` it changes no pick strategy.  The pixel-major path
    engages for ``D >= _CROSS_PM_MIN_D`` volumes (serving ranges), where it
    replaces the [D, H, W] gather path's ~3 full-volume layout moves per
    pass with zero (one transpose in/out total) — see
    ``_CROSS_PM_MIN_D``.  Last-ulp
    note: the prefix sums run as the same HIGHEST-precision triangular
    contractions but on transposed layouts, so results can differ from
    the [D, H, W] path in the final ulp of the SAT cancellation — inside
    the pipeline tie envelope, exercised by the equality tests.
    """
    # Explicit f32: ``vol.dtype`` is float64 when a NumPy array flows in,
    # and jnp.ones(float64) emits a truncation UserWarning on x64-less runs.
    ones = jnp.ones(vol.shape[-2:], jnp.float32)
    sup_h_first = _vsum(_hsum(ones, arms.left, arms.right), arms.up, arms.down)
    sup_v_first = _hsum(_vsum(ones, arms.up, arms.down), arms.left, arms.right)

    if method == "auto":
        h, w = vol.shape[-2:]
        use_mm = (
            vol.ndim == 3
            and max_arm is None
            and 4 * h * w * (h + w) <= _MM_BAND_LIMIT_BYTES
        )
    elif method == "matmul":
        use_mm = True
    elif method in ("gather", "pixel_major"):
        use_mm = False
    else:
        raise ValueError(
            f"method must be 'auto', 'matmul', 'gather' or 'pixel_major': {method}"
        )

    hf = horizontal_first
    use_pm = method == "pixel_major" or (
        not use_mm
        and method == "auto"
        and vol.ndim == 3
        and max_arm is None
        and vol.shape[0] >= _CROSS_PM_MIN_D
    )
    if use_pm:
        if vol.ndim != 3 or max_arm is not None:
            raise ValueError(
                "method='pixel_major' needs a [D, H, W] volume and max_arm=None"
            )
        # serving disparity ranges: pixel-major passes, one transpose in
        # and one out (vs ~3 full-volume layout moves PER PASS in the
        # [D, H, W] gather path — the 100x cliff the _CROSS_PM_MIN_D
        # comment documents).  Arm cap for the vsum halo: canonical arms
        # never exceed the image, and the growth rules cap at L1; the
        # exact per-pixel bound is the arms themselves.
        out = jnp.moveaxis(vol, 0, -1)                  # [H, W, D]
        sup_h = sup_h_first[..., None]
        sup_v = sup_v_first[..., None]
        vcap = span_cap if span_cap is not None else int(vol.shape[1])
        for _ in range(num_iters):
            if hf:
                out = _vsum_pm(
                    _hsum_pm(out, arms.left, arms.right), arms.up, arms.down, vcap
                ) / sup_h
            else:
                out = _hsum_pm(
                    _vsum_pm(out, arms.up, arms.down, vcap), arms.left, arms.right
                ) / sup_v
            hf = not hf
        return jnp.moveaxis(out, -1, 0)
    if use_mm:
        band_h, band_v = _arm_bands(arms)
        out = jnp.moveaxis(vol, 0, -1)  # [H, W, D]
        sup_h = sup_h_first[..., None]
        sup_v = sup_v_first[..., None]
        for _ in range(num_iters):
            if hf:
                out = _vsum_mm(_hsum_mm(out, band_h), band_v) / sup_h
            else:
                out = _hsum_mm(_vsum_mm(out, band_v), band_h) / sup_v
            hf = not hf
        return jnp.moveaxis(out, -1, 0)

    out = vol
    for _ in range(num_iters):
        if hf:
            out = _vsum(
                _hsum(out, arms.left, arms.right, max_arm), arms.up, arms.down, max_arm
            )
            out = out / sup_h_first
        else:
            out = _hsum(
                _vsum(out, arms.up, arms.down, max_arm), arms.left, arms.right, max_arm
            )
            out = out / sup_v_first
        hf = not hf
    return out


def rect_mean_aggregate_volume(
    vol: jax.Array,
    arm_left: jax.Array,
    arm_right: jax.Array,
    arm_up: jax.Array,
    arm_down: jax.Array,
    inclusive: bool = False,
) -> jax.Array:
    """Rectangle-mean aggregation with *disparity-conditioned* arm volumes
    (`costAggregationV4`, `CBLSM.h:1128-1176`, dormant at `CBLSM.cpp:111`).

    Arms are int32 ``[D, H, W]`` (from :func:`cblsm_arm_volumes`); V4 uses
    exclusive upper bounds ``[-up, down) x [-L, R)`` (`CBLSM.h:1162-1169`).
    The reference reads out of bounds for border pixels and divides by zero
    when a region is empty; here indices clamp and empty regions keep the
    centre cost (intended semantics per SURVEY.md §7).
    """
    d, h, w = vol.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (d, h, w), 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (d, h, w), 2)
    if inclusive:
        i0, i1 = ii - arm_up, ii + arm_down
        j0, j1 = jj - arm_left, jj + arm_right
        count = (arm_up + arm_down + 1) * (arm_left + arm_right + 1)
    else:
        i0, i1 = ii - arm_up, ii + arm_down - 1
        j0, j1 = jj - arm_left, jj + arm_right - 1
        count = (arm_up + arm_down) * (arm_left + arm_right)
    i0 = jnp.clip(i0, 0, h - 1)
    i1 = jnp.clip(i1, 0, h - 1)
    j0 = jnp.clip(j0, 0, w - 1)
    j1 = jnp.clip(j1, 0, w - 1)
    sat = _sat(vol)  # [D, H+1, W+1]
    dd = jax.lax.broadcasted_iota(jnp.int32, (d, h, w), 0)

    # Per-element picks: unlike rect_mean_aggregate,
    # the v4 arms are *disparity-conditioned* — every d has different
    # corner coordinates — so the contiguous-D-row gather layout of
    # `_rect_sums_shared_bounds` cannot apply.  Dormant path
    # (CBLSM aggregation='rect_mean_v4'); correctness over speed.
    def g(i, j):
        return sat[dd, i, j]
    total = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    mean = total / jnp.maximum(count, 1).astype(vol.dtype)
    return jnp.where(count > 0, mean, vol)


def _arm_region_mean(img: jax.Array, up, down, left, right, col_shift) -> jax.Array:
    """Mean of ``img`` over rows [i-up, i+down] x cols [j-left-s, j+right-s]
    (inclusive, clamped); all bound arrays broadcast against the output."""
    h, w = img.shape
    shape = jnp.broadcast_shapes(
        up.shape, down.shape, left.shape, right.shape, jnp.shape(col_shift) or (1,)
    )
    nd = len(shape)
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, nd - 2)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, nd - 1)
    i0 = jnp.clip(ii - up, 0, h - 1)
    i1 = jnp.clip(ii + down, 0, h - 1)
    j0 = jnp.clip(jj - left - col_shift, 0, w - 1)
    j1 = jnp.clip(jj + right - col_shift, 0, w - 1)
    sat = _sat(img.astype(jnp.float32))
    total = sat[i1 + 1, j1 + 1] - sat[i0, j1 + 1] - sat[i1 + 1, j0] + sat[i0, j0]
    count = (i1 - i0 + 1) * (j1 - j0 + 1)
    return total / jnp.maximum(count, 1).astype(jnp.float32)


def local_mean_cost(
    left: jax.Array,
    right: jax.Array,
    arms_l: Arms,
    arms_r: Arms,
    disp_range: int,
) -> jax.Array:
    """On-the-fly aggregated cost (`ComputeLocalValue`/`costAggregation`,
    `CBLSM.h:969-1085`, dormant): cost(p, d) = |mean of the left image over
    p's left-image arm region - mean of the right image over p's right-image
    arm region shifted left by d|.

    The reference's plumbing is badly scrambled (it passes ``d`` into the
    ``dispRange`` parameter and indexes 2-D arm maps with a 3-D stride,
    `CBLSM.h:1076-1078`; its count is off by one per row, `CBLSM.h:1012`);
    per SURVEY.md §7 this implements the *intended* semantics — inclusive
    arm spans, exact counts, clamped borders.
    """
    zero = jnp.int32(0)
    mean_l = _arm_region_mean(
        left, arms_l.up[None], arms_l.down[None], arms_l.left[None],
        arms_l.right[None], zero,
    )  # [1, H, W]
    ds = jnp.arange(disp_range, dtype=jnp.int32)[:, None, None]
    mean_r = _arm_region_mean(
        right, arms_r.up[None], arms_r.down[None], arms_r.left[None],
        arms_r.right[None], ds,
    )  # [D, H, W]
    return jnp.abs(mean_l - mean_r)


def local_mean_cost_volume(
    left: jax.Array,
    right: jax.Array,
    arm_left: jax.Array,
    arm_right: jax.Array,
    arm_up: jax.Array,
    arm_down: jax.Array,
) -> jax.Array:
    """`costAggregationNew` (`CBLSM.h:1087-1126`, dormant): like
    :func:`local_mean_cost` but both means use the same
    disparity-conditioned support (int32 [D, H, W] arm volumes from
    :func:`cblsm_arm_volumes`); the right mean's columns shift by d."""
    d = arm_left.shape[0]
    zero = jnp.int32(0)
    mean_l = _arm_region_mean(left, arm_up, arm_down, arm_left, arm_right, zero)
    ds = jnp.arange(d, dtype=jnp.int32)[:, None, None]
    mean_r = _arm_region_mean(right, arm_up, arm_down, arm_left, arm_right, ds)
    return jnp.abs(mean_l - mean_r)


# ---------------------------------------------------------------------------
# dormant CBLSM disparity-conditioned arm volumes (`CBLSM.h:65-236`)
# ---------------------------------------------------------------------------


def cblsm_arm_volumes(
    arms_l: Arms, arms_r: Arms, disp_range: int, max_steps: int = 34
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The dormant "CBLSM idea proper": per-(pixel, d) support extents that
    intersect the left-image arms with the right-image arms shifted by d
    (`chooseArmLengthLeft/Right/Up/Down`, `CBLSM.h:65-236`,
    disabled at `CBLSM.cpp:108-111`).  Returns int32 [D, H, W] volumes
    (left, right, up, down) with the reference's exact (quirky) bounds.
    """
    d = jnp.arange(disp_range)[:, None, None].astype(jnp.int32)
    ll, lr = arms_l.left[None], arms_l.right[None]
    # right-image arms sampled at the *same* column (the reference indexes
    # ArmR* at (i, j), not (i, j-d) — `CBLSM.h:74-76`)
    rl, rr = arms_r.left[None], arms_r.right[None]

    # Left extent (`CBLSM.h:65-102`): 0 if d > RL or d > RR, else the count
    # of a in 1..LL with a <= RL - d.
    vol_l = jnp.where(
        (d > rl) | (d > rr), 0, jnp.clip(jnp.minimum(ll, rl - d), 0)
    )

    # Right extent (`CBLSM.h:104-148`): precondition d <= RL (the commented
    # j+d check is disabled, and it also forces d - RL <= 0 so the loop's
    # a >= d - RL condition always holds); count of a in 1..LR with
    # a < RR + d.
    vol_r = jnp.where(d > rl, 0, jnp.clip(jnp.minimum(lr, rr + d - 1), 0))

    # Up extent (`chooseArmLengthUp`, `CBLSM.h:151-192`): the count is
    # zeroed when LUp > RUp (the else branch resets saveValue before
    # breaking, `CBLSM.h:181-184`) or when j < d (break at the first step
    # with nothing counted, `CBLSM.h:170-173`); otherwise it counts steps
    # s=1..LUp whose right-image horizontal arms at row i-s *strictly*
    # contain column j-d (`CBLSM.h:175`: d < RL(i-s,j) and RR(i-s,j)+d > 0).
    vol_up = _cblsm_vertical_volume(arms_l, arms_r, disp_range, up=True, max_steps=max_steps)
    # Down extent (`chooseArmLengthDown`, `CBLSM.h:195-236`): overrunning
    # RDown breaks *keeping* the count (`CBLSM.h:225-228`), so the walk is
    # bounded by min(LDown, RDown); j < d zeroes it (`CBLSM.h:215-219`);
    # containment is inclusive (`CBLSM.h:220`: d <= RL(i+s,j)).
    vol_dn = _cblsm_vertical_volume(arms_l, arms_r, disp_range, up=False, max_steps=max_steps)
    return vol_l.astype(jnp.int32), vol_r.astype(jnp.int32), vol_up, vol_dn


def _cblsm_vertical_volume(
    arms_l: Arms, arms_r: Arms, disp_range: int, up: bool, max_steps: int = 34
) -> jax.Array:
    """Vertical disparity-conditioned extents; see :func:`cblsm_arm_volumes`."""
    h, w = arms_l.left.shape
    sign = -1 if up else +1
    l_arm = arms_l.up if up else arms_l.down
    r_arm = arms_r.up if up else arms_r.down

    ii = jnp.arange(h)
    offs = jnp.arange(1, max_steps + 1)
    rows = jnp.clip(ii[None, :] + sign * offs[:, None], 0, h - 1)  # [S, H]
    ptr_l = jnp.take(arms_r.left, rows, axis=0)[:, None]   # [S, 1, H, W]
    ptr_r = jnp.take(arms_r.right, rows, axis=0)[:, None]

    d = jnp.arange(disp_range)[None, :, None, None].astype(jnp.int32)  # [1,D,1,1]
    jj = jnp.arange(w)[None, None, None, :].astype(jnp.int32)
    step = offs[:, None, None, None]
    jd_valid = (jj - d) >= 0                                # [1, D, 1, W]

    if up:
        in_walk = step <= jnp.minimum(l_arm, max_steps)[None, None]
        contains = (d < ptr_l) & ((ptr_r > 0) | (d > 0))    # strict bounds
        count = jnp.sum((in_walk & contains).astype(jnp.int32), axis=0)
        count = jnp.where(l_arm[None] > r_arm[None], 0, count)
    else:
        in_walk = step <= jnp.minimum(l_arm, r_arm)[None, None]
        contains = d <= ptr_l                               # inclusive
        count = jnp.sum((in_walk & contains).astype(jnp.int32), axis=0)
    count = jnp.where(jd_valid[0], count, 0)
    return count.astype(jnp.int32)
