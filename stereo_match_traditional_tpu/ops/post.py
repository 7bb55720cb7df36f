"""Post-processing (layer L4): LR checks, speckle removal, hole filling,
median filters, scanline fills.

The reference scatters these across four near-duplicate files
(`SAD/Sad.h:184-698`, `ASW/ASW.h:108-145,434-591`,
`AD-CensusV1/PostProcessing.h`, `CBLSM/PostProcessing.h`); this is the single
shared, pure-functional library.  Pixel lists (`occlusions`/`mismatches`
vectors) become boolean masks; sequential in-place updates become
whole-image passes (documented where that changes borderline pixels — parity
is validated at the bad-pixel-rate level per SURVEY.md §4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

INVALID = jnp.inf

_NEIGHBORS_8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


# ---------------------------------------------------------------------------
# left-right consistency
# ---------------------------------------------------------------------------


class LRResult(NamedTuple):
    disp: jax.Array
    occlusion: jax.Array  # bool [H, W]
    mismatch: jax.Array   # bool [H, W]


def _shift_fwd2(x, s, axis, fill):
    """out[j] = x[j - s] along ``axis`` (fill at the start)."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (s, 0)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, x.shape[axis])
    return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]


def _shift_bwd2(x, s, axis, fill):
    """out[j] = x[j + s] along ``axis`` (fill at the end)."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, s)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(s, s + x.shape[axis])
    return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]


def _banded_select_cols(vals, col, jj, lo, hi):
    """``vals[i, col[i, j]]`` where ``col`` is known to stay within the
    per-pixel band ``[j + lo, j + hi]`` (disparity-bounded reprojection),
    realized as an unrolled shift+select chain over the band instead of a
    per-element `take_along_axis` gather along the contiguous axis.
    Out-of-band entries return 0; every caller masks them (they only occur
    for invalid/garbage disparities whose classification is
    value-independent).
    """
    w = vals.shape[1]
    off = col - jj
    out = jnp.zeros_like(vals)
    for o in range(lo, hi + 1):
        sh = _shift_fwd2(vals, -o, 1, 0) if o <= 0 else _shift_bwd2(vals, o, 1, 0)
        out = jnp.where(off == o, sh, out)
    return out


def lr_check_simple(
    disp_left: jax.Array,
    disp_right: jax.Array,
    gate: float = 5.0,
    invalid_value: float = INVALID,
    disp_range: Optional[int] = None,
) -> LRResult:
    """Integer-index LR check (`SAD/Sad.h:184-222`, `ASW/ASW.h:108-145`).

    Compares dL(j) with dR(j - dL); |diff| > gate invalidates the pixel and
    classifies it: occlusion when dL < dR else mismatch (`Sad.h:206-212`).
    The ASW variant writes 0 instead of Invalid_Float — pass
    ``invalid_value=0``.  The reference reads out of bounds when
    j - dL < 0 (`Sad.h:204`); here the gather clamps (intended semantics).

    ``disp_range``: when the caller guarantees ``disp_left`` is finite with
    values in ``[0, disp_range)`` (every pipeline does — this check runs on
    raw WTA output), the lane gather is replaced by a banded shift+select
    (see :func:`_banded_select_cols`); results are identical for
    in-contract maps (a non-finite ``disp_left`` entry indexes via an
    overflowing int cast in the gather path, i.e. garbage either way).
    """
    h, w = disp_left.shape
    dl = disp_left.astype(jnp.float32)
    drf = disp_right.astype(jnp.float32)
    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    idx = jnp.clip(jj - dl.astype(jnp.int32), 0, w - 1)
    if disp_range is None:
        dr = jnp.take_along_axis(drf, idx, axis=1)
    else:
        dr = _banded_select_cols(drf, idx, jj, -(disp_range - 1), 0)
    bad = jnp.abs(dl - dr) > gate
    occl = bad & (dl < dr)
    mism = bad & ~occl
    return LRResult(jnp.where(bad, invalid_value, dl), occl, mism)


def lr_check_consistency(
    disp_left: jax.Array,
    disp_right: jax.Array,
    gate: float = 1.0,
    invalid_value: float = INVALID,
    disp_range: Optional[int] = None,
) -> LRResult:
    """Canonical rounded LR check (`AD-CensusV1/PostProcessing.h:72-135`).

    * pixels already invalid join the mismatch set (:90-93);
    * col_right = int(j - dL + 0.5) (:96); out of range -> invalid+mismatch;
    * |dL - dR| > gate -> invalid; classified via the reprojection
      col_rl = int(col_right + dR + 0.5): occlusion iff dL(col_rl) > dL(j)
      (:110-122), mismatch when col_rl leaves (0, W).

    ``disp_range``: banded shift+select instead of lane gathers when valid
    disparities are known to live in ``[0, disp_range)`` — see
    :func:`lr_check_simple`.  Out-of-band reprojections only arise from
    invalid/garbage disparities, whose classification the masks force
    independently of the gathered value.
    """
    h, w = disp_left.shape
    dl = disp_left.astype(jnp.float32)
    drf = disp_right.astype(jnp.float32)
    already_invalid = ~jnp.isfinite(dl) | (dl == invalid_value)

    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    col_right = jnp.trunc(jj.astype(jnp.float32) - dl + 0.5).astype(jnp.int32)
    in_range = (col_right >= 0) & (col_right < w)
    idx1 = jnp.clip(col_right, 0, w - 1)
    if disp_range is None:
        dr = jnp.take_along_axis(drf, idx1, axis=1)
    else:
        dr = _banded_select_cols(drf, idx1, jj, -(disp_range - 1), 0)
    bad = in_range & (jnp.abs(dl - dr) > gate)

    col_rl = jnp.trunc(col_right.astype(jnp.float32) + dr + 0.5).astype(jnp.int32)
    rl_in = (col_rl > 0) & (col_rl < w)
    idx2 = jnp.clip(col_rl, 0, w - 1)
    if disp_range is None:
        disp_l_rl = jnp.take_along_axis(dl, idx2, axis=1)
    else:
        disp_l_rl = _banded_select_cols(
            dl, idx2, jj, -(disp_range - 1), disp_range - 1
        )

    occl = bad & rl_in & (disp_l_rl > dl)
    mism = (bad & ~occl) | (~in_range) | already_invalid
    invalid = (bad | ~in_range) & ~already_invalid
    out = jnp.where(invalid, invalid_value, dl)
    return LRResult(out, occl & ~already_invalid, mism)


# ---------------------------------------------------------------------------
# speckle removal (connected components on device)
# ---------------------------------------------------------------------------


def remove_speckles(
    disp: jax.Array,
    diff_insame: float = 1.0,
    min_speckle_area: int = 80,
    invalid_value: float = INVALID,
    background: Optional[float] = None,
    max_iters: Optional[int] = None,
    connectivity: int = 8,
    block: Optional[int] = None,
) -> jax.Array:
    """Connected-component speckle filter (`SAD/Sad.h:251-315`,
    `AD-CensusV1/PostProcessing.h:250-311`; also covers OpenCV
    ``filterSpeckles`` as used at `ASW/ASWeight.cpp:73`).

    Pixels are connected (8-neighborhood) when both are members
    (``!= invalid_value``, `Sad.h:294`) and their disparities differ by
    <= diff_insame; components smaller than ``min_speckle_area`` become
    ``invalid_value``.  ``background`` marks the value the SAD variant
    skips as a BFS *seed* (`Sad.h:265` skips ``disp == 0``): background
    pixels still join components through neighbors and count toward the
    area, but a component containing only background pixels is never
    visited and survives.

    The BFS becomes iterative min-label flooding via segmented min-scans
    along connected runs (all four directions; diagonals on sheared views),
    iterated to the fixpoint with `lax.while_loop`.  From sweep 24 onward
    every third sweep also pointer-jumps (``label <- label[label]``, one
    element gather): a component whose min-label path crosses many run
    junctions (a serpentine needs ~segments sweeps — a tall snake
    exceeded the old fixed cap of 256 and was then *entirely* invalidated,
    every fragment undercounting the area) converges in O(log) jumps
    instead.  Real maps converge in <=20 sweeps and never pay for the
    gather.  ``max_iters=None`` derives a cap from the image size; the
    loop always exits at the fixpoint long before it on non-adversarial
    inputs.  ``connectivity=4`` restricts edges to the axis
    neighbors — OpenCV ``filterSpeckles`` semantics (the ASW driver's
    `ASWeight.cpp:73`); the reference's own BFS variants are 8-connected.

    ``block``: two-level block CCL (exact — see :func:`_merge_block_labels`):
    the sweep fixpoint runs with connectivity CUT at ``block``-multiple
    rows/columns (fewer rounds: min-label paths never cross a block), then
    the cut edges — a static ~4HW/block subset — are closed by
    hook-and-jump min propagation on the label array.  ``None`` keeps the
    single-level flood.

    On an earlier accelerator the merge phase's scatter-min hooking cost
    far more than the sweep rounds it saves, so no pipeline sets it; the
    parameter stays as an exact alternative (ROADMAP design item 7).
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    h, w = disp.shape
    if max_iters is None:
        # jumps double the resolved pointer depth every 3 sweeps; generous
        # margin over 24 + 3*log2(h*w), and never reached in practice
        max_iters = 32 + 8 * max(1, (h * w - 1).bit_length())
    d = disp.astype(jnp.float32)
    valid = jnp.isfinite(d) & (d != invalid_value)

    big = jnp.int32(h * w)
    idx = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    labels0 = jnp.where(valid, idx, big)

    if block is not None and block < max(h, w):
        conns = speckle_connectivity(d, valid, diff_insame)
        sweep = _speckle_sweep_fn(
            d, valid, diff_insame, connectivity, big, conns=conns, block=block
        )
    else:
        block = None
        sweep = _speckle_sweep_fn(d, valid, diff_insame, connectivity, big)

    def _jump(l):
        # label[p] always names a pixel of p's own component (induction
        # over sweeps), so following it once more stays in-component and
        # only decreases labels; invalid pixels hold `big` -> sentinel.
        flat = jnp.concatenate([l.reshape(-1), big[None]])
        return jnp.minimum(l, flat[l])

    def step(state):
        labels, _, it = state
        new = sweep(labels)
        # start jumping only past the sweep counts real maps ever need
        # (Teddy converges in <=20; each jump costs an element gather)
        new = jax.lax.cond(
            (it >= 24) & ((it - 24) % 3 == 0), _jump, lambda l: l, new
        )
        return new, jnp.any(new != labels), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    labels, _, _ = jax.lax.while_loop(
        cond, step, (labels0, jnp.bool_(True), jnp.int32(0))
    )

    if block is not None:
        a, b = _block_border_edges(labels, conns, connectivity, block, big)
        labels = _merge_block_labels(labels, a, b, big)

    flat_labels = jnp.where(valid, labels, big).reshape(-1)
    counts = jnp.zeros(h * w + 1, jnp.int32).at[flat_labels].add(
        valid.reshape(-1).astype(jnp.int32)
    )
    area = counts[flat_labels].reshape(h, w)
    kill = valid & (area < min_speckle_area)
    if background is not None:
        # components containing only background pixels have no BFS seed in
        # the reference and are never visited (`Sad.h:265`)
        seed = (valid & (d != background)).reshape(-1).astype(jnp.int32)
        seeds = jnp.zeros(h * w + 1, jnp.int32).at[flat_labels].add(seed)
        kill = kill & (seeds[flat_labels].reshape(h, w) > 0)
    return jnp.where(kill, invalid_value, d)


def _doubling_masks(conn, axis):
    """[(s, in-run-fwd, in-run-bwd)] for s = 1, 2, 4, ...: whether the
    pixel s before/after (along ``axis``) belongs to the same run.
    ``conn[..j..]`` says j connects to its predecessor j-1."""
    n = conn.shape[axis]
    c = jnp.cumsum((~conn).astype(jnp.int32), axis=axis)
    masks = []
    s = 1
    while s < n:
        mf = (c - _shift_fwd2(c, s, axis, -1)) == 0
        mb = (_shift_bwd2(c, s, axis, -1) - c) == 0
        masks.append((s, mf, mb))
        s *= 2
    return masks


def _run_min_total(val, masks, axis, big):
    """Min over each pixel's whole run via Hillis-Steele doubling."""
    for s, mf, mb in masks:
        cf = jnp.where(mf, _shift_fwd2(val, s, axis, big), big)
        cb = jnp.where(mb, _shift_bwd2(val, s, axis, big), big)
        val = jnp.minimum(val, jnp.minimum(cf, cb))
    return val


def speckle_connectivity(d, valid, diff_insame):
    """(conn_l, conn_u, conn_d1, conn_d2): does each pixel connect to its
    left / up / up-right / up-left neighbor (`Sad.h:294` membership +
    disparity-difference rule)."""
    h, w = d.shape

    def _shift(x, dy, dx, fill):
        xp = jnp.pad(x, ((1, 1), (1, 1)), constant_values=fill)
        return jax.lax.dynamic_slice(xp, (1 + dy, 1 + dx), (h, w))

    out = []
    for dy, dx in [(0, -1), (-1, 0), (-1, 1), (-1, -1)]:
        nd = _shift(d, dy, dx, jnp.nan)
        nv = _shift(valid, dy, dx, False)
        out.append(valid & nv & (jnp.abs(d - nd) <= diff_insame))
    return tuple(out)


def _speckle_sweep_fn(d, valid, diff_insame, connectivity, big,
                      conns=None, block=None):
    """Build the one-sweep label-propagation function for the min-label
    flood (full connected-run reach along all 4 directions per sweep).

    Hillis-Steele run-min doubling: the connectivity is FIXED across the
    fixpoint iterations, so the "neighbor 2^k away is in my run" masks are
    precomputed once outside the while loop (one break cumsum per
    direction) and every sweep inside the loop is just shift+select+min
    on contiguous slices — no per-iteration segmented scans.  (The
    associative_scan formulation re-derived the segment flags at every
    combine level of every sweep of every iteration.)

    The four directions are chained, not stacked into one padded array:
    a stack of the four views (horizontal transposed, vertical, two
    sheared diagonals) holds ~9x the elements of the [H, W] map, and
    parallel sweeps converge in more fixpoint iterations than the chained
    form below, where direction k sees direction k-1's propagation within
    the same sweep.

    Reused by the row-sharded variant (`parallel.post_shard`), where each
    tile builds its machinery from halo-extended connectivity.

    ``block``: cut every edge that crosses a ``block``-multiple row or
    column (the two-level block-CCL local phase; the cut edges are closed
    afterwards by :func:`_merge_block_labels`).
    """
    h, w = d.shape
    if conns is None:
        conns = speckle_connectivity(d, valid, diff_insame)
    conn_l, conn_u, conn_d1, conn_d2 = conns
    if block is not None:
        # edge (i,j)->(i+dy,j+dx) crosses iff the border line separates the
        # endpoints: conn_* are "connect to my (dy,dx) = left/up/up-right/
        # up-left neighbor" masks, so the cut tests the CURRENT pixel's
        # row/col (and j+1 for the up-right diagonal's column crossing)
        bi = (jnp.arange(h, dtype=jnp.int32)[:, None] % block) == 0
        bj = (jnp.arange(w, dtype=jnp.int32)[None, :] % block) == 0
        bj1 = (jnp.arange(1, w + 1, dtype=jnp.int32)[None, :] % block) == 0
        conn_l = conn_l & ~bj
        conn_u = conn_u & ~bi
        conn_d1 = conn_d1 & ~(bi | bj1)
        conn_d2 = conn_d2 & ~(bi | bj)

    masks_h = _doubling_masks(conn_l, 1)
    masks_v = _doubling_masks(conn_u, 0)
    if connectivity == 8:
        sc_d1, _ = _shear(conn_d1, True, False)
        sc_d2, _ = _shear(conn_d2, False, False)
        masks_d1 = _doubling_masks(sc_d1, 0)
        masks_d2 = _doubling_masks(sc_d2, 0)

    def sweep(labels):
        new = _run_min_total(labels, masks_h, 1, big)
        new = _run_min_total(new, masks_v, 0, big)
        if connectivity == 8:
            for masks, anti in ((masks_d1, True), (masks_d2, False)):
                ls, _ = _shear(new, anti, big)
                ls = _run_min_total(ls, masks, 0, big)
                new = _unshear(ls, h, w, anti, big)
        return new

    return sweep


def _block_border_edges(labels, conns, connectivity, block, big):
    """(a, b) endpoint-label arrays for every connectivity edge the
    ``block`` cut removed — static slices at the block-multiple rows and
    columns, so shapes are fixed at ~4HW/block regardless of content.
    Masked-out (not actually connected) slots carry ``(big, big)``, a
    no-op under min-hooking."""
    conn_l, conn_u, conn_d1, conn_d2 = conns
    bm1 = block - 1

    def pairs(pa, qb, m):
        # strided slices starting earlier/later can differ by one in count;
        # the overhang rows/cols have no in-image partner (their conn is
        # False from the pad) — truncate all three to the common shape
        n0 = min(pa.shape[0], qb.shape[0])
        n1 = min(pa.shape[1], qb.shape[1])
        pa, qb, m = pa[:n0, :n1], qb[:n0, :n1], m[:n0, :n1]
        return (
            jnp.where(m, pa, big).reshape(-1),
            jnp.where(m, qb, big).reshape(-1),
        )

    out = [
        # left neighbor (0,-1): crosses a column line (j % block == 0)
        pairs(labels[:, block::block], labels[:, bm1::block],
              conn_l[:, block::block]),
        # up neighbor (-1,0): crosses a row line
        pairs(labels[block::block, :], labels[bm1::block, :],
              conn_u[block::block, :]),
    ]
    if connectivity == 8:
        out += [
            # up-right (-1,+1): row crossing ...
            pairs(labels[block::block, :-1], labels[bm1::block, 1:],
                  conn_d1[block::block, :-1]),
            # ... and column crossing ((j+1) % block == 0)
            pairs(labels[1:, bm1::block], labels[:-1, block::block],
                  conn_d1[1:, bm1::block]),
            # up-left (-1,-1): row crossing ...
            pairs(labels[block::block, 1:], labels[bm1::block, :-1],
                  conn_d2[block::block, 1:]),
            # ... and column crossing (j % block == 0)
            pairs(labels[1:, block::block], labels[:-1, bm1::block],
                  conn_d2[1:, block::block]),
        ]
    a = jnp.concatenate([x for x, _ in out])
    b = jnp.concatenate([x for _, x in out])
    return a, b


def _merge_block_labels(labels, a, b, big):
    """Close the block-cut edges EXACTLY: hook-and-jump min propagation
    (Shiloach-Vishkin shape) on a parent array over pixel ids.

    ``P`` starts as identity and only decreases; every written value is the
    min of two labels of the same merged class, so values stay inside the
    class.  At the while fixpoint two facts force full resolution: a jump
    no-change makes ``P`` idempotent (``P <= id`` gives ``P[P[l]] <=
    P[l]``; no-change gives ``>=``), and a hook no-change then forces
    ``P[a] == P[b]`` across every edge (each root r satisfies ``P[r] = r``,
    and ``P[ra] <= min(ra, rb)`` both ways).  Hence ``P[l]`` is the minimum
    pixel id of l's GLOBAL component — bitwise the single-level flood's
    answer.  Rounds are O(log) in the block-graph diameter (each round
    hooks once and pointer-jumps twice); the cap is a safety net only.
    """
    if a.shape[0] == 0:
        return labels
    h, w = labels.shape
    hw = h * w
    p0 = jnp.arange(hw + 1, dtype=jnp.int32)
    cap = jnp.int32(16 + 2 * max(1, hw.bit_length()))

    def round_(state):
        p, _, it = state
        ra, rb = p[a], p[b]
        m = jnp.minimum(ra, rb)
        pn = p.at[ra].min(m).at[rb].min(m)
        pn = jnp.minimum(pn, pn[pn])
        pn = jnp.minimum(pn, pn[pn])
        return pn, jnp.any(pn != p), it + 1

    p, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < cap), round_,
        (p0, jnp.bool_(True), jnp.int32(0)),
    )
    return p[labels]


# ---------------------------------------------------------------------------
# nearest-valid scans (the engine behind every fill)
# ---------------------------------------------------------------------------


def _ff_op(a, b):
    av, ai, ah = a
    bv, bi, bh = b
    return (
        jnp.where(bh, bv, av),
        jnp.where(bh, bi, ai),
        ah | bh,
    )


def _nearest_valid_along_axis(
    values: jax.Array, valid: jax.Array, axis: int, reverse: bool
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(value, steps, found) of the nearest valid pixel strictly before the
    current one along +axis (reverse=False) or after it (reverse=True).

    Hillis-Steele doubling: at step 2^k each element holds the nearest
    valid within its trailing (leading, if reverse) 2^k window, so taking
    the own hit when found and the 2^k-shifted one otherwise doubles the
    window.  log2(n) rounds of contiguous shift+select, in place of the
    tuple-carrying `associative_scan` formulation (which re-derives the
    combine tree per call with awkward interleaved slices).
    """
    n = values.shape[axis]
    pos = jnp.arange(n, dtype=jnp.int32)
    shape = [1] * values.ndim
    shape[axis] = n
    pos = jnp.broadcast_to(pos.reshape(shape), values.shape)

    def _shift(x, s, fill):
        # bring the element s positions earlier along the scan direction
        if not reverse:
            return _shift_fwd2(x, s, axis, fill)
        return _shift_bwd2(x, s, axis, fill)

    v, i, h = values, jnp.where(valid, pos, 0), valid
    s = 1
    while s < n:
        vs = _shift(v, s, 0.0)
        is_ = _shift(i, s, jnp.int32(0))
        hs = _shift(h, s, False)
        v = jnp.where(h, v, vs)
        i = jnp.where(h, i, is_)
        h = h | hs
        s *= 2

    # make it exclusive: shift by one along the scan direction
    v = _shift(v, 1, 0.0)
    i = _shift(i, 1, jnp.int32(0))
    h = _shift(h, 1, False)
    steps = jnp.abs(pos - i)
    return v, steps, h


def _shear_anti(x: jax.Array, fill):
    """sheared[i, k] = x[i, k - i] (anti-diagonals j + i = const become
    columns) via the pad-reshape trick — pure relayout, no gather:
    pad each row by H columns, flatten, and re-view with row stride
    (W + H - 1); row i then starts one column later than row i-1."""
    h, w = x.shape
    xp = jnp.pad(x, ((0, 0), (0, h)), constant_values=fill)
    flat = xp.reshape(-1)[: h * (w + h - 1)]
    return flat.reshape(h, w + h - 1)


def _unshear_anti(s: jax.Array, h: int, w: int, fill) -> jax.Array:
    """Inverse of :func:`_shear_anti` (crop back to [H, W])."""
    flat = jnp.concatenate([s.reshape(-1), jnp.full((h,), fill, s.dtype)])
    return flat.reshape(h, w + h)[:, :w]


def _shear(x: jax.Array, anti: bool, fill):
    """Shear so diagonals become columns; returns (sheared, None).

    anti=True : constant (j + i) anti-diagonals -> sheared[i, k] = x[i, k - i]
    anti=False: constant (j - i) diagonals — equals the anti shear of the
    horizontally flipped image (lane reversal is a cheap vector op).
    """
    if anti:
        return _shear_anti(x, fill), None
    return _shear_anti(x[:, ::-1], fill), None


def _unshear(sheared: jax.Array, h: int, w: int, anti: bool, fill=0) -> jax.Array:
    out = _unshear_anti(sheared, h, w, jnp.asarray(fill, sheared.dtype))
    return out if anti else out[:, ::-1]


def directional_candidates(
    disp: jax.Array, valid: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """First valid disparity along each of the 8 rays from every pixel
    (`SAD/Sad.h:359-378`, `PostProcessing.h:202-220`).

    Returns (values [8, H, W] with +inf where the ray found nothing,
    steps [8, H, W] — pixel steps along the ray).  Axis rays use row/column
    scans; diagonal rays shear the image so each diagonal becomes a column,
    scan, and unshear — exact nearest-valid without per-pixel ray walks.
    """
    h, w = disp.shape
    d = disp.astype(jnp.float32)

    outs = []
    steps_out = []

    def _collect(v, s, hfound):
        outs.append(jnp.where(hfound, v, jnp.inf))
        steps_out.append(s)

    # E (+x): nearest valid after along axis 1; W (-x): before.
    v, s, f = _nearest_valid_along_axis(d, valid, 1, reverse=True)
    _collect(v, s, f)
    v, s, f = _nearest_valid_along_axis(d, valid, 1, reverse=False)
    _collect(v, s, f)
    # S (+y), N (-y)
    v, s, f = _nearest_valid_along_axis(d, valid, 0, reverse=True)
    _collect(v, s, f)
    v, s, f = _nearest_valid_along_axis(d, valid, 0, reverse=False)
    _collect(v, s, f)

    for anti in (False, True):
        dv, _ = _shear(d, anti, 0.0)
        vv, _ = _shear(valid, anti, False)
        # +diag (down the sheared column) and -diag (up)
        for reverse in (True, False):
            v, s, f = _nearest_valid_along_axis(dv, vv, 0, reverse=reverse)
            _collect(
                _unshear(jnp.where(f, v, jnp.inf), h, w, anti),
                _unshear(s, h, w, anti),
                True,
            )

    values = jnp.stack(outs)  # inf already encodes not-found for diagonals
    steps = jnp.stack(steps_out)
    return values, steps


def _fill_from_candidates(
    disp: jax.Array,
    target: jax.Array,
    second_smallest: bool,
    max_axis_steps: Optional[int],
    max_diag_steps: Optional[int],
) -> jax.Array:
    """Fill ``target`` pixels from 8-ray candidates: second-smallest for
    occlusions, median for mismatches (`PostProcessing.h:229-239`,
    `Sad.h:385-397`).  Pixels whose rays found nothing keep their value
    (`disp_collects.empty() -> continue`)."""
    valid = jnp.isfinite(disp)
    cand, steps = directional_candidates(disp, valid)
    if max_axis_steps is not None:
        limit = jnp.array(
            [max_axis_steps] * 4 + [max_diag_steps] * 4, jnp.int32
        ).reshape(8, 1, 1)
        cand = jnp.where(steps <= limit, cand, jnp.inf)
    cand = _sort_stack(cand)
    count = jnp.sum(jnp.isfinite(cand), axis=0)
    if second_smallest:
        pick_idx = jnp.where(count > 1, 1, 0)
    else:
        pick_idx = jnp.clip(count // 2, 0, 7)
    chosen = _pick_rank(cand, pick_idx)
    do_fill = target & (count > 0)
    return jnp.where(do_fill, chosen, disp)


def fill_holes_8dir(
    disp: jax.Array,
    occlusion: jax.Array,
    mismatch: jax.Array,
    invalid_value: float = INVALID,
    max_search: Optional[int] = None,
) -> jax.Array:
    """8-direction hole filling (`AD-CensusV1/PostProcessing.h:156-248`,
    `SAD/Sad.h:317-400`).

    Three passes: occlusions get the second-smallest ray candidate,
    mismatches the median, then any remaining invalid pixels get the median
    (`PostProcessing.h:172-190`).  Each pass sees the previous pass's fills
    (the reference also updates within a pass pixel-by-pixel; the
    within-pass difference only affects adjacent invalid pixels and is
    covered by the bad-pixel-rate parity budget).  ``max_search`` mirrors
    `PostProcessing.h:169` (ray capped at dispRange steps; the reference's
    ``lround(m*sin)`` walk advances diagonals ~0.707 px/step, so the
    diagonal cap scales accordingly); None = unbounded (`Sad.h:365`).

    The angle1/angle2 swap at ``y == height/2`` (`PostProcessing.h:198-200`)
    permutes the same 8 directions and is a no-op once candidates are
    sorted, so it needs no counterpart here.
    """
    max_axis = None if max_search is None else max(max_search - 1, 0)
    max_diag = None if max_search is None else int(round(max_axis * 0.70710678))

    d = jnp.where(disp == invalid_value, jnp.inf, disp.astype(jnp.float32))
    d = _fill_from_candidates(d, occlusion & ~jnp.isfinite(d), True, max_axis, max_diag)
    d = _fill_from_candidates(d, mismatch & ~jnp.isfinite(d), False, max_axis, max_diag)
    d = _fill_from_candidates(d, ~jnp.isfinite(d), False, max_axis, max_diag)
    return jnp.where(jnp.isfinite(d), d, invalid_value)


# ---------------------------------------------------------------------------
# scanline fills (`SAD/Sad.h:403-698`, `ASW/ASW.h:434-591`)
# ---------------------------------------------------------------------------


def fill_image_new(disp: jax.Array) -> jax.Array:
    """`FillImageNew` (`ASW/ASW.h:434-511`): zero-valued pixels take the
    nearest non-zero value to the left, else the nearest to the right,
    else 0.  All lookups read the pre-fill map (writes happen after
    collection in the reference too)."""
    d = disp.astype(jnp.float32)
    valid = d != 0
    lv, _, lf = _nearest_valid_along_axis(d, valid, 1, reverse=False)
    rv, _, rf = _nearest_valid_along_axis(d, valid, 1, reverse=True)
    fill = jnp.where(lf, lv, jnp.where(rf, rv, 0.0))
    return jnp.where(valid, d, fill)


def fill_image(disp: jax.Array) -> jax.Array:
    """`FillImage` (`SAD/Sad.h:403-480`): leftward-only nearest-valid fill
    for zero pixels; rays that hit the border fill 0."""
    d = disp.astype(jnp.float32)
    valid = d != 0
    lv, _, lf = _nearest_valid_along_axis(d, valid, 1, reverse=False)
    return jnp.where(valid, d, jnp.where(lf, lv, 0.0))


def fill_image_second_times(disp: jax.Array, threshold: float = 20.0) -> jax.Array:
    """`FillImageSecondTimes` (`SAD/Sad.h:483-538`): pixels <= threshold
    search rightward *starting at themselves* (`Sad.h:510` reads offset 0
    first) for the nearest nonzero value, falling back to the threshold at
    the border — so nonzero low pixels deterministically keep their own
    value and only zero pixels are filled.  (The reference's accumulating
    ``pixel_col += offset`` triangular stride at `Sad.h:513` is a
    catalogued quirk; intended one-step scan implemented.)"""
    d = disp.astype(jnp.float32)
    valid = d != 0
    rv, _, rf = _nearest_valid_along_axis(d, valid, 1, reverse=True)
    fill = jnp.where(rf, rv, threshold)
    # The reference's `<= threshold` gate is absorbed by the self-read at
    # offset 0: a nonzero low pixel always "fills" with its own value, so
    # the only pixels that can change are the zeros.
    return jnp.where(d == 0, fill, d)


def fill_image_last(disp: jax.Array) -> jax.Array:
    """`FillImageLast` (`SAD/Sad.h:621-698`, `ASW/ASW.h:514-591`): vertical
    variant — nearest non-zero above, else below, else 0."""
    d = disp.astype(jnp.float32)
    valid = d != 0
    uv, _, uf = _nearest_valid_along_axis(d, valid, 0, reverse=False)
    dv, _, df = _nearest_valid_along_axis(d, valid, 0, reverse=True)
    fill = jnp.where(uf, uv, jnp.where(df, dv, 0.0))
    return jnp.where(valid, d, fill)


# ---------------------------------------------------------------------------
# rank selection via sorting networks
# ---------------------------------------------------------------------------
#
# XLA's comparator sort on a [K, H, W] stack and take_along_axis picks are
# general-purpose kernels for what is ~50 compare-exchanges of work in a
# 3x3 median; a Batcher odd-even mergesort network is pure elementwise
# min/max and a data-dependent rank pick is a select chain.


def _batcher_pairs(n: int):
    """Compare-exchange index pairs of Batcher's odd-even mergesort."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _sort_stack(stack: jax.Array) -> jax.Array:
    """Sort along axis 0 with a sorting network (ascending)."""
    n = stack.shape[0]
    vals = [stack[k] for k in range(n)]
    for a, b in _batcher_pairs(n):
        lo = jnp.minimum(vals[a], vals[b])
        hi = jnp.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    return jnp.stack(vals)


def _pick_rank(sorted_stack: jax.Array, idx: jax.Array) -> jax.Array:
    """sorted_stack[idx[i,j], i, j] as a select chain (no gather)."""
    out = sorted_stack[0]
    for k in range(1, sorted_stack.shape[0]):
        out = jnp.where(idx == k, sorted_stack[k], out)
    return out


# ---------------------------------------------------------------------------
# median filters
# ---------------------------------------------------------------------------


def _window_stack(
    x: jax.Array,
    radius: int,
    fill,
    row_offset: int = 0,
    global_rows: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """[(2r+1)^2, H, W] stack of shifted copies + in-bounds mask.

    ``row_offset``/``global_rows`` position a halo-extended row tile inside
    the full image so the in-bounds mask reflects the *global* image
    borders (parallel.post_shard), keeping truncate-border semantics
    bit-identical to the untiled run.
    """
    h, w = x.shape
    if global_rows is None:
        global_rows = h
    xs = []
    inb = []
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_offset
    ci = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    xp = jnp.pad(x, radius, constant_values=fill)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xs.append(
                jax.lax.dynamic_slice(xp, (radius + dy, radius + dx), (h, w))
            )
            inb.append(
                (ri + dy >= 0)
                & (ri + dy < global_rows)
                & (ci + dx >= 0)
                & (ci + dx < w)
            )
    return jnp.stack(xs), jnp.stack(inb)


def median_filter(
    x: jax.Array,
    size: int,
    border: str = "truncate",
    row_offset: int = 0,
    global_rows: Optional[int] = None,
) -> jax.Array:
    """Window median.

    border='truncate' matches the reference's own median
    (`PostProcessing.h:314-344`, `SAD/Sad.h:224-249`): only in-bounds values
    participate and the median is ``sorted[count / 2]``.
    border='replicate' matches OpenCV ``medianBlur`` (`ASWeight.cpp:74,78`).
    ``row_offset``/``global_rows``: see :func:`_window_stack`.
    """
    radius = size // 2
    xf = x.astype(jnp.float32)
    if border == "replicate":
        if row_offset != 0 or global_rows is not None:
            # replicate-mode tiling needs processed-edge re-pointing between
            # stages, which only the caller can do (see
            # parallel.post_shard.asw_post_sharded) — reject rather than
            # silently replicate the tile-local edge at interior boundaries
            raise NotImplementedError(
                "median_filter(border='replicate') has no row-offset form; "
                "run it on halo-extended tiles and re-point out-of-image "
                "rows at the processed global edge (post_shard pattern)"
            )
        h, w = x.shape
        xp = jnp.pad(xf, radius, mode="edge")
        xs = [
            jax.lax.dynamic_slice(xp, (radius + dy, radius + dx), (h, w))
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
        ]
        return _sort_stack(jnp.stack(xs))[len(xs) // 2]
    stack, inb = _window_stack(xf, radius, jnp.inf, row_offset, global_rows)
    stack = jnp.where(inb, stack, jnp.inf)
    count = jnp.sum(inb, axis=0)
    s = _sort_stack(stack)
    pick = jnp.clip(count // 2, 0, s.shape[0] - 1)
    return _pick_rank(s, pick)


# ---------------------------------------------------------------------------
# Canonical AD-Census post components (the fields of the vendored
# `ADCensusOption` that the reference declares but never implements —
# `CBLSM/adcensus_types.h:72-75`; canonical Mei et al. semantics here so no
# config field is inert)
# ---------------------------------------------------------------------------


def iterative_region_voting(
    disp: jax.Array,
    arms,
    disp_range: int,
    ts: float = 20.0,
    th: float = 0.4,
    num_iters: int = 5,
    invalid_value: float = INVALID,
    max_arm: Optional[int] = None,
    d_chunk: Optional[int] = None,
) -> jax.Array:
    """Canonical iterative region voting (`irv_ts`/`irv_th`,
    `adcensus_types.h:73`).

    Each iteration every *valid* pixel votes its integer disparity into its
    cross support region (two-pass horizontal-then-vertical arm sums, the
    same region as `aggregate.cross_aggregate`); an invalid pixel is filled
    with the plurality disparity when the region holds more than ``ts``
    reliable votes and the winning bin exceeds ``th`` of them.  Newly
    filled pixels vote in later iterations.

    ``arms`` is an `aggregate.Arms` (canonical `canonical_cross_arms` in
    the canonical pipeline).  O(D) one-hot slices per iteration — each a
    prefix-sum + 2 gathers, no scatter.

    ``d_chunk`` bounds peak memory to ``d_chunk`` one-hot slices instead of
    the full ``[D, H, W]`` histogram (a serving-size necessity: 8.5 GB at
    4K/D=256).  Chunking is EXACT, not an approximation: per-bin vote
    counts are independent across ``d``; the running total is an integer
    sum that f32 holds exactly (``<= D * (2*L1+1)^2 < 2**24``); and the
    strictly-greater running argmax over ascending chunks reproduces
    ``argmax``'s first-max rule bitwise.
    """
    from stereo_match_traditional_tpu.ops.aggregate import _hsum, _vsum

    def bin_votes(dint, ds):
        onehot = (dint[None] == ds[:, None, None]).astype(jnp.float32)
        return _vsum(
            _hsum(onehot, arms.left, arms.right, max_arm), arms.up, arms.down, max_arm
        )

    if d_chunk is None or d_chunk >= disp_range:
        def histogram(dint):
            votes = bin_votes(dint, jnp.arange(disp_range, dtype=jnp.float32))
            return jnp.sum(votes, axis=0), jnp.max(votes, axis=0), jnp.argmax(votes, axis=0)
    else:
        nc = -(-disp_range // d_chunk)

        def histogram(dint):
            h, w = dint.shape
            init = (
                jnp.zeros((h, w), jnp.float32),
                jnp.full((h, w), -1.0, jnp.float32),
                jnp.zeros((h, w), jnp.int32),
            )

            def chunk(carry, c0):
                total, bestv, best = carry
                # overrun bins (>= disp_range) collect zero votes and the
                # strict > below never selects a zero over a seen >= 0 max
                ds = (c0 + jnp.arange(d_chunk)).astype(jnp.float32)
                votes = bin_votes(dint, ds)
                cv = jnp.max(votes, axis=0)
                ci = jnp.argmax(votes, axis=0).astype(jnp.int32) + c0
                upd = cv > bestv
                return (
                    total + jnp.sum(votes, axis=0),
                    jnp.where(upd, cv, bestv),
                    jnp.where(upd, ci, best),
                ), None

            (total, bestv, best), _ = jax.lax.scan(
                chunk, init, jnp.arange(nc, dtype=jnp.int32) * d_chunk
            )
            return total, bestv, best

    def one_iter(d):
        valid = d != invalid_value
        dint = jnp.where(valid, jnp.round(d), -1.0)
        total, bestv, best = histogram(dint)
        fill = (~valid) & (total > ts) & (bestv > th * total)
        return jnp.where(fill, best.astype(d.dtype), d)

    for _ in range(num_iters):
        disp = one_iter(disp)
    return disp


def discontinuity_adjustment(
    disp: jax.Array, cost_vol: jax.Array, invalid_value: float = INVALID
) -> jax.Array:
    """Canonical discontinuity adjustment (`do_discontinuity_adjustment`,
    `adcensus_types.h:74`).

    At disparity discontinuities — a horizontal neighbor differs by more
    than 1 — the pixel's disparity is replaced by whichever of the two
    neighbors' disparities has the lower matching cost at this pixel, if
    lower than its own (Mei et al. §V-D).  ``cost_vol`` is the aggregated
    [D, H, W] volume the disparities were selected from.
    """
    d_n, _, _ = cost_vol.shape
    valid = disp != invalid_value

    left_n = jnp.concatenate([disp[:, :1], disp[:, :-1]], axis=1)
    right_n = jnp.concatenate([disp[:, 1:], disp[:, -1:]], axis=1)
    left_ok = valid & (left_n != invalid_value)
    right_ok = valid & (right_n != invalid_value)
    edge = (left_ok & (jnp.abs(disp - left_n) > 1.0)) | (
        right_ok & (jnp.abs(disp - right_n) > 1.0)
    )

    dd_iota = jax.lax.broadcasted_iota(jnp.int32, cost_vol.shape, 0)

    def cost_at(d, ok):
        # masked reduction, not an axis-0 gather
        idx = jnp.clip(jnp.round(d), 0, d_n - 1).astype(jnp.int32)
        c = jnp.min(jnp.where(dd_iota == idx[None], cost_vol, jnp.inf), axis=0)
        return jnp.where(ok, c, jnp.inf)

    c_self = cost_at(disp, valid)
    c_left = cost_at(left_n, left_ok)
    c_right = cost_at(right_n, right_ok)

    best = jnp.where(c_left < c_self, left_n, disp)
    best_c = jnp.minimum(c_left, c_self)
    best = jnp.where(c_right < best_c, right_n, best)
    return jnp.where(edge, best, disp)
