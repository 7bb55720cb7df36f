"""4-path scanline (SGM-style) cost optimization.

Re-designs `AD-CensusV1/ScanlineOptimizer.h:104-253` as a `jax.lax.scan`
over image columns/rows with every pixel of the perpendicular axis processed
in parallel — the serial per-pixel recurrence becomes a [H, D] vector update
per step.  The recurrence (`ScanlineOptimizer.h:173-183`):

    L(p, d) = C(p, d) + min(L(p-1, d),
                            L(p-1, d-1) + P1,
                            L(p-1, d+1) + P1,
                            min_d' L(p-1, d') + P2) - min_d' L(p-1, d')
    P2 = max(P1, P2_init / (|I(p) - I(p-1)| + 1))        (:171,232)

Sentinel-padded neighbors (`costLastPath[dispRange+2]` init 0xffff,
`ScanlineOptimizer.h:151`) become +inf pads on the d axis.  The reference's
vertical passes read ``costLastPath[d+1]`` for the ``l2`` term
(`ScanlineOptimizer.h:238`), silently dropping the d-1 transition; set
``faithful_vertical_l2=True`` to reproduce that quirk (default is canonical
SGM on all four paths).

Cross-tile (multi-chip) continuation of these scans lives in
``stereo_match_traditional_tpu.parallel.scan_carry``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereo_match_traditional_tpu.config import ScanlineConfig

_BIG = float("inf")  # python float: no device work at import time


def _scan_unrolled(step, first, xs, unroll):
    """Drive ``step(prev, prev_min, *xs_t)`` over t = 1..N-1 as a
    `lax.scan` of ``unroll``-step chunks plus a remainder tail — the shared
    scaffolding of both scanline recurrences (the chain is strictly
    sequential; unrolling only amortizes per-step scan overhead, results
    are bit-identical for any unroll).

    ``xs``: per-step operand arrays, each [N, ...] (index 0 unused —
    ``first = cost[0]`` seeds the carry).  Returns (aggregated [N, ...],
    final (prev, prev_min) carry).
    """
    carry0 = (first, jnp.min(first, axis=-2))
    n = xs[0].shape[0]
    k = max(1, unroll)
    main = ((n - 1) // k) * k

    def body(carry, chunk):
        prev, prev_min = carry
        outs = []
        for t in range(k):
            prev, prev_min = step(prev, prev_min, *(x[t] for x in chunk))
            outs.append(prev)
        return (prev, prev_min), jnp.stack(outs)

    xs_main = tuple(
        x[1 : 1 + main].reshape((main // k, k) + x.shape[1:]) for x in xs
    )
    carry, ys = jax.lax.scan(body, carry0, xs_main)
    pieces = [first[None], ys.reshape((main,) + first.shape)]
    for t in range(1 + main, n):  # remainder, at most k-1 steps
        out, out_min = step(carry[0], carry[1], *(x[t] for x in xs))
        carry = (out, out_min)
        pieces.append(out[None])
    return jnp.concatenate(pieces, axis=0), carry


def _make_step(p1: float, l2_uses_dm1: bool):
    """The SGM min-plus step ``(prev, prev_min, cost_t, p2_t) -> (out,
    out_min)`` shared by the monolithic, sharded and banded passes."""

    def step(prev, prev_min, c, p2_col):
        inf_row = jnp.full(prev.shape[:-2] + (1,) + prev.shape[-1:], _BIG)
        l1 = prev
        if l2_uses_dm1:
            l2 = jnp.concatenate([inf_row, prev[..., :-1, :]], axis=-2) + p1
        else:
            # reference vertical quirk: l2 = costLastPath[d+1] + p1 == prev[d]+p1
            l2 = prev + p1
        l3 = jnp.concatenate([prev[..., 1:, :], inf_row], axis=-2) + p1
        l4 = (prev_min + p2_col)[..., None, :]
        out = (
            c
            + jnp.minimum(jnp.minimum(l1, l2), jnp.minimum(l3, l4))
            - prev_min[..., None, :]
        )
        return out, jnp.min(out, axis=-2)

    return step


def _scan_carry_unrolled(step, carry, xs, unroll=4):
    """Like :func:`_scan_unrolled` but steps EVERY t = 0..N-1 from an
    explicit incoming carry — the band-continuation form the streamed
    executor uses.  Returns (aggregated [N, ...], final carry)."""
    n = xs[0].shape[0]
    k = max(1, unroll)
    main = (n // k) * k

    def body(c, chunk):
        prev, prev_min = c
        outs = []
        for t in range(k):
            prev, prev_min = step(prev, prev_min, *(x[t] for x in chunk))
            outs.append(prev)
        return (prev, prev_min), jnp.stack(outs)

    xs_main = tuple(x[:main].reshape((main // k, k) + x.shape[1:]) for x in xs)
    carry, ys = jax.lax.scan(body, carry, xs_main)
    pieces = []
    if main:
        pieces.append(ys.reshape((main,) + ys.shape[2:]))
    for t in range(main, n):  # remainder, at most k-1 steps
        out, out_min = step(carry[0], carry[1], *(x[t] for x in xs))
        carry = (out, out_min)
        pieces.append(out[None])
    out = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=0)
    return out, carry


def directional_pass_banded(
    cost: jax.Array,
    p2: jax.Array,
    carry: Tuple[jax.Array, jax.Array],
    reset: jax.Array,
    p1: float,
    l2_uses_dm1: bool = True,
    unroll: int = 4,
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Band continuation of one directional pass (the streamed executor's
    building block — `parallel.streamed`).

    ``cost``: [T, D, M] (T = this band's path steps); ``p2``: [T, M]
    already evaluated against the gray neighbor each step consumes (the
    caller supplies the cross-band neighbor row from its halo);
    ``carry``: (prev [D, M], prev_min [M]) handed from the neighboring
    band.  A ``(zeros, zeros)`` carry is the *exact* path seed: with a
    d-constant carry K the recurrence gives ``min(l1..l4) == prev_min``
    so ``out = cost`` bitwise — the same value the monolithic pass
    assigns to the path's first pixel.  ``reset``: [T] bool marking rows
    where the path (re)starts mid-band (the true last image row when the
    image was padded to a band multiple); the step swaps in the identity
    carry there.  ``reset=None`` skips the selects (a pass whose direction
    cannot meet a mid-band path start, e.g. top-down with row padding only
    at the bottom).  Returns (aggregated [T, D, M], outgoing carry).
    """
    base = _make_step(p1, l2_uses_dm1)
    if reset is None:
        return _scan_carry_unrolled(base, carry, (cost, p2), unroll)

    def step(prev, prev_min, c, p2_col, rs):
        prev = jnp.where(rs, jnp.zeros_like(prev), prev)
        prev_min = jnp.where(rs, jnp.zeros_like(prev_min), prev_min)
        return base(prev, prev_min, c, p2_col)

    return _scan_carry_unrolled(step, carry, (cost, p2, reset), unroll)


def _directional_pass(
    cost: jax.Array,
    gray: jax.Array,
    p1: float,
    p2_init: float,
    l2_uses_dm1: bool = True,
    unroll: int = 4,
    p2_ref: str = "prev",
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """One directional pass.

    cost: [N, ..., D, M] with axis 0 the path direction, disparity
    transitions along axis -2, and the perpendicular image axis M last
    (the contiguous axis, so each step's [D, M] slab reads whole rows).
    gray: [N, ..., M].
    Returns (aggregated, final carry) — the carry (last aggregated column
    and its min) is what a cross-tile continuation would hand to the next
    device; the sharded implementation reshards with all_to_all instead
    (parallel.scan_carry).

    ``unroll`` recurrence steps run per `lax.scan` iteration (the chain is
    strictly sequential, so this only amortizes per-step scan overhead —
    results are bit-identical for any unroll).
    """
    if p2_ref == "first":
        # reference vertical quirk: ScanLineUpDown assigns grayLast once at
        # the column start and never updates it (`ScanlineOptimizer.h:210`,
        # read at `:232`), so P2 adapts to |I(p) - I(first pixel of path)|
        prev_g = jnp.broadcast_to(gray[:1], gray.shape)
    else:
        prev_g = jnp.concatenate([gray[:1], gray[:-1]], axis=0)
    p2 = jnp.maximum(p1, p2_init / (jnp.abs(gray - prev_g) + 1.0))  # [N, ...]
    step = _make_step(p1, l2_uses_dm1)
    return _scan_unrolled(step, cost[0], (cost, p2), unroll)


def canonical_scale(g1_cur, g1_prev, g2_cur, g2_prev, tso: float) -> jax.Array:
    """The canonical tso penalty scale per (path step, d, lane).

    Penalties derive from the color differences along the path,
    D1 = |g1(p) - g1(p-r)| (base image, [N, M]) and
    D2 = |g2(p,d) - g2(p-r,d)| (matched image at the per-d match column,
    [N, D, M]):

        D1 < tso and D2 < tso  ->  scale 1.0   (P1, P2)
        exactly one >= tso     ->  scale 0.25  (P1/4, P2/4)
        both >= tso            ->  scale 0.1   (P1/10, P2/10)

    (the Mei et al. AD-Census schedule that `so_p1/so_p2/so_tso` of the
    vendored `ADCensusOption` parameterize, `CBLSM/adcensus_types.h:72`).
    The previous-step arrays are explicit so band continuations can feed
    the cross-band neighbor row from their halo (`parallel.streamed`).
    """
    over1 = (jnp.abs(g1_cur - g1_prev) >= tso)[..., None, :]
    over2 = jnp.abs(g2_cur - g2_prev) >= tso
    return jnp.where(over1 & over2, 0.1, jnp.where(over1 | over2, 0.25, 1.0))


def _make_canonical_step(p1_base: float, p2_base: float):
    """The canonical min-plus step ``(prev, prev_min, cost_t, scale_t) ->
    (out, out_min)``: per-(d, lane) penalties ``p1_base*scale`` /
    ``p2_base*scale`` (shared by the monolithic, sharded and banded
    canonical passes)."""

    def step(prev, prev_min, c, sc):
        p1c = p1_base * sc
        p2c = p2_base * sc
        inf_row = jnp.full(prev.shape[:-2] + (1,) + prev.shape[-1:], _BIG)
        l1 = prev
        l2 = jnp.concatenate([inf_row, prev[..., :-1, :]], axis=-2) + p1c
        l3 = jnp.concatenate([prev[..., 1:, :], inf_row], axis=-2) + p1c
        l4 = prev_min[..., None, :] + p2c
        out = (
            c
            + jnp.minimum(jnp.minimum(l1, l2), jnp.minimum(l3, l4))
            - prev_min[..., None, :]
        )
        return out, jnp.min(out, axis=-2)

    return step


def rev_materialized(*xs):
    """Each array reversed along axis 0, MATERIALIZED via
    ``optimization_barrier`` before any consumer.

    The barrier keeps a ``reverse`` out of the strided input fusion of
    the unrolled scan (:func:`_scan_unrolled`'s
    ``x[1:1+main].reshape(main//k, k, ...)``), where an earlier compiler
    failed at some shapes; the cost is one materialization of the
    reversed operands (bit-identical results).  Whether the GPU needs it
    is open (ROADMAP design item 2).
    """
    import jax

    return jax.lax.optimization_barrier(tuple(x[::-1] for x in xs))


def canonical_pass_banded(
    cost: jax.Array,
    scale: jax.Array,
    carry: Tuple[jax.Array, jax.Array],
    reset: jax.Array,
    p1_base: float,
    p2_base: float,
    unroll: int = 4,
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Band continuation of one canonical directional pass — the
    tso-scheduled analogue of :func:`directional_pass_banded`
    (`parallel.streamed`'s canonical building block).

    ``cost``: [T, D, M]; ``scale``: [T, D, M] the penalty scale of
    :func:`canonical_scale`, already evaluated against the neighbor each
    step consumes (cross-band neighbors come from the caller's halo);
    ``carry``/``reset`` exactly as in :func:`directional_pass_banded` — a
    ``(zeros, zeros)`` carry is the exact path seed (``min(l1..l4) ==
    prev_min == 0`` so ``out = cost`` bitwise).
    """
    base = _make_canonical_step(p1_base, p2_base)
    if reset is None:
        return _scan_carry_unrolled(base, carry, (cost, scale), unroll)

    def step(prev, prev_min, c, sc, rs):
        prev = jnp.where(rs, jnp.zeros_like(prev), prev)
        prev_min = jnp.where(rs, jnp.zeros_like(prev_min), prev_min)
        return base(prev, prev_min, c, sc)

    return _scan_carry_unrolled(step, carry, (cost, scale, reset), unroll)


def _canonical_pass(
    cost: jax.Array,
    g1: jax.Array,
    g2: jax.Array,
    p1_base: float,
    p2_base: float,
    tso: float,
    unroll: int = 4,
) -> jax.Array:
    """One directional pass with the canonical tso penalty schedule
    (:func:`canonical_scale`).

    cost: [N, D, M] (N = path axis, M on the lanes); g1: [N, M] the base
    image along the path; g2: [N, D, M] the *matched* image gathered at the
    per-d match column.
    """
    scale = canonical_scale(
        g1,
        jnp.concatenate([g1[:1], g1[:-1]], axis=0),
        g2,
        jnp.concatenate([g2[:1], g2[:-1]], axis=0),
        tso,
    )  # [N, D, M]
    step = _make_canonical_step(p1_base, p2_base)
    out, _ = _scan_unrolled(step, cost[0], (cost, scale), unroll)
    return out


def scanline_optimize_canonical(
    cost: jax.Array,
    left: jax.Array,
    right: jax.Array,
    p1: float = 1.0,
    p2: float = 3.0,
    tso: float = 15.0,
    view: str = "left",
) -> jax.Array:
    """Canonical AD-Census 4-path scanline optimizer.

    This is the component the vendored ``ADCensusOption``'s
    ``so_p1/so_p2/so_tso`` fields configure (`CBLSM/adcensus_types.h:72` —
    declaration-only in the reference; implemented here with the canonical
    Mei et al. semantics so no config field is inert).

    Unlike the committed `ScanlineOptimizer.h` (P2 from the base image
    only), the canonical penalties consult color differences in BOTH
    images at the per-disparity match column, so P1/P2 are per-(pixel, d)
    — see :func:`_canonical_pass`.  The four directional volumes are
    averaged (the canonical normalization), keeping the output on the same
    scale as the input cost.

    cost: [D, H, W] (normalized aggregated costs, ~[0, 2] after
    `cross_aggregate`); left/right: the gray images.
    """
    from stereo_match_traditional_tpu.ops.volume import shifted_stack

    d = cost.shape[0]
    base = (left if view == "left" else right).astype(jnp.float32)
    match = (right if view == "left" else left).astype(jnp.float32)
    g2 = shifted_stack(match, d, view)              # [D, H, W]

    c_wdh = jnp.transpose(cost, (2, 0, 1))          # [W, D, H]
    g1_wh = base.T                                  # [W, H]
    g2_wdh = jnp.transpose(g2, (2, 0, 1))           # [W, D, H]
    lr = _canonical_pass(c_wdh, g1_wh, g2_wdh, p1, p2, tso)
    rl = _canonical_pass(*rev_materialized(c_wdh, g1_wh, g2_wdh), p1, p2, tso)
    horiz = lr + rl[::-1]

    c_hdw = jnp.transpose(cost, (1, 0, 2))          # [H, D, W]
    g1_hw = base                                    # [H, W]
    g2_hdw = jnp.transpose(g2, (1, 0, 2))           # [H, D, W]
    ud = _canonical_pass(c_hdw, g1_hw, g2_hdw, p1, p2, tso)
    du = _canonical_pass(*rev_materialized(c_hdw, g1_hw, g2_hdw), p1, p2, tso)
    vert = ud + rev_materialized(du)[0]

    total = jnp.transpose(horiz, (1, 2, 0)) + jnp.transpose(vert, (1, 0, 2))
    return total * 0.25


def scanline_optimize(
    cost: jax.Array, gray: jax.Array, cfg: ScanlineConfig = ScanlineConfig()
) -> jax.Array:
    """Sum of the four directional volumes (`ScanlineOptimizer.h:104-128`).

    cost: [D, H, W]; gray: [H, W] (the left image drives the adaptive P2,
    `AD-CensusV1/main.cpp:88` passes ``leftptr``).
    """
    p1, p2 = cfg.effective_penalties(cost.shape[0])
    vert_dm1 = not cfg.faithful_vertical_l2
    vert_p2 = "first" if cfg.faithful_vertical_p2 else "prev"

    # Four separate scans, one per direction.
    # horizontal: scan over W; body [D, H] (rows on the contiguous axis).
    # Reversed scan operands go through rev_materialized (bit-identical).
    c_wdh = jnp.transpose(cost, (2, 0, 1))          # [W, D, H]
    g_wh = gray.astype(jnp.float32).T               # [W, H]
    lr, _ = _directional_pass(c_wdh, g_wh, p1, p2, True)
    rl, _ = _directional_pass(*rev_materialized(c_wdh, g_wh), p1, p2, True)
    horiz = lr + rl[::-1]                           # [W, D, H]

    # vertical: scan over H; body [D, W] (columns on the contiguous axis).
    c_hdw = jnp.transpose(cost, (1, 0, 2))          # [H, D, W]
    g_hw = gray.astype(jnp.float32)                 # [H, W]
    ud, _ = _directional_pass(c_hdw, g_hw, p1, p2, vert_dm1, p2_ref=vert_p2)
    du, _ = _directional_pass(
        *rev_materialized(c_hdw, g_hw), p1, p2, vert_dm1, p2_ref=vert_p2
    )
    vert = ud + du[::-1]                            # [H, D, W]

    return jnp.transpose(horiz, (1, 2, 0)) + jnp.transpose(vert, (1, 0, 2))
