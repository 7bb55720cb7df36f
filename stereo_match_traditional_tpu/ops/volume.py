"""Cost-volume construction (layer L1).

All volumes are dense ``[D, H, W]`` float32 arrays.  ``W`` is the
contiguous axis and each disparity slice is a contiguous image, so
elementwise fusion, box sums (banded matmuls) and the WTA reduction over
axis 0 read whole rows.  The reference stores ``[row, col, disp]``
(`AD-CensusV1/AD-Census.h:87`).

Border semantics: the reference copies the previous-d cost when the match
column underflows (`SAD/Sad.h:125-128`, `AD-Census.h:88-92`).  Recursively
that equals evaluating the cost at the last valid disparity ``min(d, j)``
(or ``min(d, W-1-j)`` for right-view volumes), which is what
:func:`border_fill` implements as a gather — no sequential scan needed.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

INVALID = jnp.inf

# Above this volume size border_fill switches from the axis-0 gather to the
# diagonal-pick + select path (chosen on an earlier accelerator, alongside
# aggregate._GATHER_FAST_SRC_BYTES; ROADMAP design item 3).
_BORDER_FILL_GATHER_MAX_BYTES = 200 * 1024 * 1024


# ---------------------------------------------------------------------------
# shifted stacks & border fill
# ---------------------------------------------------------------------------


def shifted_stack(
    img: jax.Array, disp_range: int, view: str = "left", d_offset: int = 0
) -> jax.Array:
    """Stack of horizontally shifted copies: ``S[d, i, j]``.

    view='left':  ``S[d, i, j] = img[i, max(j - d, 0)]``   (search leftward,
    matching `SAD/Sad.h:130` / `AD-Census.h:95`).
    view='right': ``S[d, i, j] = img[i, min(j + d, W-1)]`` (mirror search,
    `SAD/Sad.h:173` / `AD-Census.h:123`).

    ``d_offset`` shifts the disparity block — a disparity-sharded device
    builds its local slice ``d in [d_offset, d_offset + disp_range)``
    (parallel.tiled.ad_census_tile_disp).
    """
    w = img.shape[-1]
    cols = jnp.arange(w)[None, :]
    ds = jnp.arange(disp_range)[:, None] + d_offset
    if view == "left":
        idx = jnp.clip(cols - ds, 0, w - 1)  # [D, W]
    elif view == "right":
        idx = jnp.clip(cols + ds, 0, w - 1)
    else:
        raise ValueError(view)
    # img [..., H, W] -> take over last axis with [D, W] indices -> [..., H, D, W]
    out = jnp.take(img, idx, axis=-1)
    return jnp.moveaxis(out, -2, 0)


def border_fill(vol: jax.Array, view: str = "left") -> jax.Array:
    """Replace the invalid triangle with the last-valid-d cost.

    Equivalent to the reference's ``cost[d] = cost[d-1]`` copy at
    out-of-range disparities (`SAD/Sad.h:125-128`, `ASW/ASW.h:371`,
    `AD-Census.h:88-92`): ``out[d, i, j] = vol[min(d, j), i, j]`` for the
    left view and ``min(d, W-1-j)`` for the right view.

    Two regimes: small volumes use a plain axis-0 gather, which XLA fuses
    into the consumer; big volumes (above ``_BORDER_FILL_GATHER_MAX_BYTES``)
    use the fact that only the ``D-1`` edge columns can differ from the
    input, and the filled value there is always the diagonal
    ``vol[limit, i, j]``: one tiny [k, H] diagonal pick plus a single
    elementwise select.
    """
    d, h, w = vol.shape
    k = min(d - 1, w)
    if k <= 0:
        return vol
    if 4 * d * h * w <= _BORDER_FILL_GATHER_MAX_BYTES:
        # small volumes: the axis-0 gather fuses into its consumer and is
        # effectively free; the select path below would materialize a copy
        cols = jnp.arange(w)[None, :]
        dd = jnp.arange(d)[:, None]
        lim = cols if view == "left" else (w - 1 - cols)
        eff = jnp.minimum(dd, lim)  # [D, W]
        return jnp.take_along_axis(vol, eff[:, None, :], axis=0)
    ds = jnp.arange(d)[:, None, None]
    jj = jnp.arange(k)
    # min(d, limit) is d inside the valid wedge and the *diagonal*
    # vol[limit, i, j] everywhere else — one tiny [k, H] diagonal pick +
    # a single elementwise select (one volume traversal).
    if view == "left":
        diag = vol[jj, :, jj]                          # [k, H]: vol[j, :, j]
        dfull = jnp.pad(diag.T, ((0, 0), (0, w - k)))  # [H, W]; pad unused
        limit = jnp.arange(w)[None, None, :]
    else:
        lim = jj[::-1]                                 # W-1-j on the strip
        diag = vol[lim, :, jnp.arange(w - k, w)]       # [k, H]
        dfull = jnp.pad(diag.T, ((0, 0), (w - k, 0)))
        limit = (w - 1 - jnp.arange(w))[None, None, :]
    return jnp.where(ds <= limit, vol, dfull[None])


def right_volume_from_left(vol_left: jax.Array) -> jax.Array:
    """Derive the right-view volume from the left volume by the exact shift
    identity ``costR(q, d) = costL(q + d, d)``.

    Every symmetric matching cost in the reference has the form
    ``costL(p, d) = F(p, p - d)`` where ``F`` compares a window (or weighted
    window) around left pixel ``p`` with one around right pixel ``p - d``
    (`SAD/Sad.h:96-139`, `ASW/ASW.h:329-378`, `AD-Census.h:75-101`).  The
    mirror-search right volume is ``costR(q, d) = F(q + d, q)``
    (`SAD/Sad.h:141-182`, `ASW/ASW.h:382-431`, `AD-Census.h:103-129`) — the
    *same summand* at ``p = q + d``, so the right volume is a shifted read
    of the left one.  For the out-of-range triangle ``q + d > W - 1`` the
    reference copies the previous-d cost (`ASW.h:418`), i.e. evaluates at
    ``d_eff = min(d, W - 1 - q)``; that is exactly
    :func:`border_fill(view="right")` applied to the shifted volume.

    This replaces a second full cost-volume construction (for ASW, a second
    kernel run) with one gather.
    """
    d, _, w = vol_left.shape
    cols = jnp.arange(w)[None, :]
    ds = jnp.arange(d)[:, None]
    idx = jnp.minimum(cols + ds, w - 1)  # [D, W]
    shifted = jnp.take_along_axis(vol_left, idx[:, None, :], axis=2)
    return border_fill(shifted, "right")


# ---------------------------------------------------------------------------
# box sums as banded matmuls
# ---------------------------------------------------------------------------


def _band_matrix(n_in: int, n_out: int, radius: int, dtype=jnp.float32) -> jax.Array:
    """0/1 banded matrix B ``[n_in, n_out]`` with ``B[p, i] = 1`` iff
    ``i <= p <= i + 2*radius`` — a window sum as a matmul."""
    p = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n_in, n_out), 1)
    return ((p >= i) & (p <= i + 2 * radius)).astype(dtype)


def box_sum_valid(x: jax.Array, radius_r: int, radius_c: int) -> jax.Array:
    """Sum over (2rr+1)x(2rc+1) windows, 'valid' mode.

    ``x`` is ``[..., Hp, Wp]`` (already padded); output is
    ``[..., Hp-2rr, Wp-2rc]``.  Implemented as two banded matmuls instead
    of scalar window loops
    (`SAD/Sad.h:15-20` does this per-pixel with OpenCV Mat slicing).
    """
    hp, wp = x.shape[-2], x.shape[-1]
    h, w = hp - 2 * radius_r, wp - 2 * radius_c
    br = _band_matrix(hp, h, radius_r, x.dtype)
    bc = _band_matrix(wp, w, radius_c, x.dtype)
    # precision HIGHEST: a default-precision float32 matmul may round its
    # operands to TF32 or bf16 — the band side is exact 0/1, but NCC's
    # squared-intensity operands (<=16384) and even the first pass's row
    # sums are not representable there, while ncc_volume's
    # degenerate-window mask assumes exact-f32 error < 0.5.  Matches every
    # other matmul here.
    hi = jax.lax.Precision.HIGHEST
    t = jnp.einsum(
        "ph,...pq->...hq", br, x, preferred_element_type=jnp.float32, precision=hi
    )
    return jnp.einsum(
        "...hq,qw->...hw", t, bc, preferred_element_type=jnp.float32, precision=hi
    )


def box_sum_same(x: jax.Array, radius_r: int, radius_c: int) -> jax.Array:
    """Box sum with zero padding, output same shape as input."""
    pad = [(0, 0)] * (x.ndim - 2) + [(radius_r, radius_r), (radius_c, radius_c)]
    return box_sum_valid(jnp.pad(x, pad), radius_r, radius_c)


def replicate_pad(img: jax.Array, pad_r: int, pad_c: int = None) -> jax.Array:
    """Device-side `copyMakeBorder(BORDER_REPLICATE)` on the last two axes."""
    if pad_c is None:
        pad_c = pad_r
    width = [(0, 0)] * (img.ndim - 2) + [(pad_r, pad_r), (pad_c, pad_c)]
    return jnp.pad(img, width, mode="edge")


# ---------------------------------------------------------------------------
# AD cost
# ---------------------------------------------------------------------------


def ad_volume(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    view: str = "left",
    d_offset: int = 0,
) -> jax.Array:
    """Pixelwise absolute-difference volume (`AD-Census.h:75-129`,
    `CBLSM/CBLSM.h:327-381`).

    The reference's previous-d copy at the border coincides exactly with the
    clamped-column gather for a pixelwise cost, so no fill pass is needed —
    which also makes any d-slice (``d_offset`` != 0) locally computable.
    """
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    if view == "left":
        return jnp.abs(left[None] - shifted_stack(right, disp_range, "left", d_offset))
    return jnp.abs(shifted_stack(left, disp_range, "right", d_offset) - right[None])


# ---------------------------------------------------------------------------
# SAD cost
# ---------------------------------------------------------------------------


def sad_volume(
    left: jax.Array, right: jax.Array, disp_range: int, winsize: int, view: str = "left",
    mean: bool = False, channel_min: bool = False,
) -> jax.Array:
    """Windowed SAD volume (`SAD/Sad.h:96-182`; mean variant
    `CBLSM/CBLSM.h:409-489` via ``sadvalueMean`` `CBLSM.h:17-22`).

    ``winsize`` follows the reference driver convention: the actual radius is
    ``winsize + 1`` (`SAD/Sad.h:109`), i.e. a 9x9 window for winsize=3.
    Inputs are the *unpadded* images; replicate padding happens here
    (`SAD/SADmain.cpp:47-48`).

    ``channel_min=True`` is the dormant color variant `sadvalueMeanV4`
    (`CBLSM/CBLSM.h:45-63` via `ComputeDispV4` `:494-532`): the per-pixel
    error is the *minimum* channel absolute difference (intended semantics;
    the reference's uchar accumulator overflow and unused T parameter are
    catalogued quirks, not reproduced).  Inputs must then be [H, W, 3].
    """
    r = winsize + 1
    lf = left.astype(jnp.float32)
    rf = right.astype(jnp.float32)
    if channel_min:
        # pad rows/cols only; shift along the column axis (-2 for color)
        lp = jnp.pad(lf, ((r, r), (r, r), (0, 0)), mode="edge")
        rp = jnp.pad(rf, ((r, r), (r, r), (0, 0)), mode="edge")
        lp_c = jnp.moveaxis(lp, -1, 0)  # [3, Hp, Wp]
        rp_c = jnp.moveaxis(rp, -1, 0)
        if view == "left":
            stack = shifted_stack(rp_c, disp_range, "left")   # [D, 3, Hp, Wp]
            diff = jnp.min(jnp.abs(lp_c[None] - stack), axis=1)
        else:
            stack = shifted_stack(lp_c, disp_range, "right")
            diff = jnp.min(jnp.abs(stack - rp_c[None]), axis=1)
    else:
        lp = replicate_pad(lf, r)
        rp = replicate_pad(rf, r)
        if view == "left":
            stack = shifted_stack(rp, disp_range, "left")
            diff = jnp.abs(lp[None] - stack)
        else:
            stack = shifted_stack(lp, disp_range, "right")
            diff = jnp.abs(stack - rp[None])
    vol = box_sum_valid(diff, r, r)
    if mean:
        vol = vol / float((2 * r + 1) ** 2)
    return border_fill(vol, view)


# ---------------------------------------------------------------------------
# NCC cost
# ---------------------------------------------------------------------------


def ncc_interior_mask(
    h: int, w: int, win_size: int, row_offset: int = 0, global_rows: int = None
) -> jax.Array:
    """Pixels the NCC reference actually computes (loop bounds
    `NCC/NCC.h:72-75`); everything else keeps 0 disparity from `Mat::zeros`
    (`NCC_main.cpp:20`).  ``row_offset``/``global_rows`` let a row tile use
    global bounds (parallel.tiled)."""
    if global_rows is None:
        global_rows = h
    rows = jnp.arange(h) + row_offset
    cols = jnp.arange(w)
    return (
        (rows[:, None] >= win_size)
        & (rows[:, None] < global_rows - win_size)
        & (cols[None, :] >= win_size)
        & (cols[None, :] < w - win_size)
    )


def ncc_volume(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int,
    invalid_mode: str = "ignore",
    eps: float = 1e-12,
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Normalized cross-correlation volume (`NCC/NCC.h:15-95`).

    ``d_offset`` builds the local slice ``d in [d_offset, d_offset +
    disp_range)`` for a disparity-sharded device (parallel.tiled).

    Returns ``(volume, interior_mask)``.  The volume holds the correlation
    coefficient in [-1, 1] (`NCC.h:46`); invalid (d, j) entries — where the
    right window would cross the left edge (`NCC.h:81-89`) — get -2 under
    ``invalid_mode='ignore'`` so argmax never selects them, or +255 under
    ``'sentinel'`` to reproduce the reference quirk where the 0xff sentinel
    wins the similarity argmax (`NCC.h:59,88` — catalogued to fix, not copy).
    Pixels outside the interior mask are not computed by the reference
    (loop bounds `NCC.h:72-75`) and read 0 disparity from `Mat::zeros`.
    """
    w = win_size
    n = float((2 * w + 1) ** 2)
    # center at 128 (exact in f32 for u8 inputs): the one-pass
    # sum-of-products formula cancels catastrophically on raw u8 magnitudes
    # (sums ~1.7e7 where the f32 ulp is 2); centering keeps the error below
    # any real texture's variance.
    lf = left.astype(jnp.float32) - 128.0
    rf = right.astype(jnp.float32) - 128.0
    h, wd = lf.shape

    sum_l = box_sum_same(lf, w, w)
    sum_l2 = box_sum_same(lf * lf, w, w)
    sum_r = box_sum_same(rf, w, w)
    sum_r2 = box_sum_same(rf * rf, w, w)

    s_r = shifted_stack(rf, disp_range, "left", d_offset)  # [D, H, W]
    sum_lr = box_sum_same(lf[None] * s_r, w, w)            # [D, H, W]
    sum_r_d = shifted_stack(sum_r, disp_range, "left", d_offset)
    sum_r2_d = shifted_stack(sum_r2, disp_range, "left", d_offset)

    # numerator = sum((L-mL)(R-mR)) = sum(LR) - sumL*sumR/n
    num = sum_lr - sum_l[None] * sum_r_d / n
    var_l = jnp.maximum(sum_l2 - sum_l * sum_l / n, 0.0)
    var_r = jnp.maximum(sum_r2_d - sum_r_d * sum_r_d / n, 0.0)
    ncc = num / jnp.sqrt(jnp.maximum(var_l[None] * var_r, eps))
    # Zero-variance windows: the reference's double-precision NCC divides
    # 0/0 to NaN, which never wins its `<` tracker (`NCC.h:46,59`); mask
    # them to the never-wins value so flat regions keep 0 disparity instead
    # of amplified rounding noise.  Threshold 0.5: for u8 inputs the
    # smallest *nonzero* sum of squared deviations is ~1.0 (one pixel off
    # by 1), and with 128-centering the f32 rounding error is far below
    # 0.5 — so only truly flat windows are masked, while faintly textured
    # ones keep their (valid, possibly winning) NCC as in the reference.
    degenerate = (var_l[None] < 0.5) | (var_r < 0.5)
    ncc = jnp.where(degenerate, -2.0, ncc)

    cols = jnp.arange(wd)[None, None, :]
    ds = jnp.arange(disp_range)[:, None, None] + d_offset
    valid = (cols - w - ds) >= 0                          # NCC.h:81
    sentinel = 255.0 if invalid_mode == "sentinel" else -2.0
    vol = jnp.where(valid, ncc, sentinel)

    interior = ncc_interior_mask(h, wd, w, row_offset, global_rows)
    return vol, interior


def ncc_shifted_depth(
    left: jax.Array,
    right: jax.Array,
    max_offset: int = 79,
    kernel_size: int = 5,
    view: str = "left",
    add_constant: bool = False,
    depth_scale: int = 3,
    row_offset: int = 0,
    global_rows: int = None,
) -> jax.Array:
    """Dormant whole-image shifted-NCC depth map (`ncc`, `NCC/NCC.h:117-272`,
    disabled at `NCC_main.cpp:24`).

    Per offset 1..max_offset the matching image is shifted column-wise (the
    first/last ``offset`` columns keep their *unshifted* values,
    `NCC.h:150-158` — reproduced), an 11x11 border-truncated NCC is
    computed, and a per-pixel argmax tracker keeps the first strictly
    greatest offset; the output is ``offset * 3`` for display
    (`NCC.h:262`).  Faithful quirks: the pixel-count divisor is
    ``(end_y-start_y)*(end_x-start_x)`` *without* +1 (`NCC.h:188`), and the
    correlation is divided by n once more (`NCC.h:221`) — both leave the
    argmax unchanged but are kept for value parity.  ``add_constant`` adds
    10 to the right image (`NCC.h:128-131`).
    """
    k = kernel_size
    lf = left.astype(jnp.float32)
    rf = right.astype(jnp.float32)
    if add_constant:
        rf = rf + 10.0
    h, w = lf.shape
    tiled = global_rows is not None  # row_offset may be traced (axis_index)
    if global_rows is None:
        global_rows = h
    grow = jnp.arange(h) + row_offset  # global row ids (tile support)
    if tiled:
        # A halo-extended row tile carries edge-replicated rows beyond the
        # global image; the border-TRUNCATED window sums below must treat
        # those as absent (zero), and the per-pixel truncation counts must
        # use global coordinates — then a tiled run is bit-identical to
        # the untiled one (parallel.tiled `_ncc_tile` variant='shifted').
        inrow = ((grow >= 0) & (grow < global_rows))[:, None]
        lf = jnp.where(inrow, lf, 0.0)
        rf = jnp.where(inrow, rf, 0.0)

    cols = jnp.arange(w)
    offs = jnp.arange(1, max_offset + 1)[:, None]  # [O, 1]
    if view == "left":
        # tmp[o, :, x] = right[:, x - o] for x >= o else right[:, x]
        idx = jnp.where(cols[None, :] >= offs, cols[None, :] - offs, cols[None, :])
        moving = jnp.moveaxis(jnp.take(rf, idx, axis=1), 1, 0)  # [O, H, W]
        fixed = lf
    else:
        idx = jnp.where(
            cols[None, :] < w - offs, cols[None, :] + offs, cols[None, :]
        )
        moving = jnp.moveaxis(jnp.take(lf, idx, axis=1), 1, 0)
        fixed = rf

    # border-truncated window sums (zero padding == skipping out-of-range)
    s_fix = box_sum_same(fixed, k, k)
    s_fix2 = box_sum_same(fixed * fixed, k, k)
    s_mov = box_sum_same(moving, k, k)
    s_mov2 = box_sum_same(moving * moving, k, k)
    s_cross = box_sum_same(fixed[None] * moving, k, k)

    ii = grow[:, None]
    jj = jnp.arange(w)[None, :]
    rows_in = jnp.minimum(ii + k, global_rows - 1) - jnp.maximum(ii - k, 0) + 1
    cols_in = jnp.minimum(jj + k, w - 1) - jnp.maximum(jj - k, 0) + 1
    cnt = (rows_in * cols_in).astype(jnp.float32)           # true element count
    n = ((rows_in - 1) * (cols_in - 1)).astype(jnp.float32)  # quirky divisor

    mu_f = s_fix / n
    mu_m = s_mov / n
    # sum over window of (x - mu)(y - mu) with the quirky mu:
    num = s_cross - mu_f[None] * s_mov - mu_m * s_fix[None] + cnt[None] * mu_f[None] * mu_m
    var_f = s_fix2 - 2.0 * mu_f * s_fix + cnt * mu_f * mu_f
    var_m = s_mov2 - 2.0 * mu_m * s_mov + cnt[None] * mu_m * mu_m
    res = (num / n[None]) / (
        jnp.sqrt(jnp.maximum(var_f / n, 0.0))[None]
        * jnp.sqrt(jnp.maximum(var_m / n[None], 0.0))
    ) / n[None]
    res = jnp.where(jnp.isnan(res), -jnp.inf, res)  # NaN never wins `>`

    # strict-greater tracker init -2 (`NCC.h:139,254`): first max wins
    best = jnp.argmax(res, axis=0)
    best_val = jnp.max(res, axis=0)  # == res at argmax, without an axis-0 gather
    depth = (best + 1) * depth_scale
    return jnp.where(best_val > -2.0, depth, 0).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Census transform + Hamming volume
# ---------------------------------------------------------------------------


def census_transform(
    img: jax.Array,
    rows: int = 9,
    cols: int = 3 * 2 + 1,
    row_offset: int = 0,
    global_rows: int = None,
) -> Tuple[jax.Array, jax.Array]:
    """Census signature per pixel as two int32 words (hi: first 31 offsets,
    lo: remaining 32) for a rows x cols neighborhood.

    Bit semantics follow `AD-Census.h:166-192`: for each offset in row-major
    order the code shifts left and gains a 1 iff ``center > neighbor`` and
    the neighbor is inside the image (out-of-image bits stay 0,
    `AD-Census.h:173-174`).  The center offset participates (always 0).

    ``row_offset``/``global_rows`` let a row tile inside `shard_map` use
    *global* image bounds for the out-of-image bit, so a halo-exchanged
    tiled run is bit-identical to the untiled run (parallel.tiled).
    """
    if rows * cols > 63:
        raise ValueError(
            f"census window {rows}x{cols} needs {rows * cols} bits; the "
            "two-word signature holds at most 63 (31 hi + 32 lo)"
        )
    rr, rc = rows // 2, cols // 2
    h, w = img.shape
    if global_rows is None:
        global_rows = h
    x = img.astype(jnp.float32)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_offset
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    total = rows * cols
    hi = jnp.zeros((h, w), jnp.int32)
    lo = jnp.zeros((h, w), jnp.int32)
    k = 0
    for r in range(-rr, rr + 1):
        for c in range(-rc, rc + 1):
            shifted = jnp.roll(x, shift=(-r, -c), axis=(0, 1))
            inb = (
                (row_ids + r >= 0)
                & (row_ids + r < global_rows)
                & (col_ids + c >= 0)
                & (col_ids + c < w)
            )
            bit = ((x > shifted) & inb).astype(jnp.int32)
            if k < total - 32:
                hi = hi * 2 + bit
            else:
                lo = lo * 2 + bit
            k += 1
    return hi, lo


def _popcount(x: jax.Array) -> jax.Array:
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def census_volume(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    rows: int = 9,
    cols: int = 7,
    view: str = "left",
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> jax.Array:
    """Hamming-distance census volume (`AD-Census.h:142-269`).

    The reference recomputes the right-image signature per (pixel, d) with
    per-neighbor column clamping to 0 (`AD-Census.h:160,178`); here the
    signatures are computed once and gathered at the clamped match column —
    identical except inside the d > j invalid triangle (documented deviation;
    parity is checked at the bad-pixel-rate level, SURVEY.md §7).
    """
    hi_l, lo_l = census_transform(left, rows, cols, row_offset, global_rows)
    hi_r, lo_r = census_transform(right, rows, cols, row_offset, global_rows)
    if view == "left":
        hi_s = shifted_stack(hi_r, disp_range, "left", d_offset)
        lo_s = shifted_stack(lo_r, disp_range, "left", d_offset)
        ham = _popcount(hi_l[None] ^ hi_s) + _popcount(lo_l[None] ^ lo_s)
    else:
        hi_s = shifted_stack(hi_l, disp_range, "right", d_offset)
        lo_s = shifted_stack(lo_l, disp_range, "right", d_offset)
        ham = _popcount(hi_s ^ hi_r[None]) + _popcount(lo_s ^ lo_r[None])
    return ham.astype(jnp.float32)


def ad_census_volume(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    view: str = "left",
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> jax.Array:
    """Fused AD-Census cost (`AD-Census.h:271-318`):
    ``(1 - exp(-AD/sigmaC)) + (1 - exp(-census/sigmaS))``."""
    ad = ad_volume(left, right, disp_range, view, d_offset)
    cen = census_volume(
        left, right, disp_range, census_rows, census_cols, view,
        row_offset, global_rows, d_offset,
    )
    return (1.0 - jnp.exp(-ad / sigma_c)) + (1.0 - jnp.exp(-cen / sigma_s))


# ---------------------------------------------------------------------------
# ASW (adaptive support weight) cost
# ---------------------------------------------------------------------------


def _space_mask(radius: int, space_sigma: float) -> jax.Array:
    """Gaussian proximity mask over the support window
    (`ASW/ASW.h:16-35`; never normalized — the sum at `ASW.h:32` is unused)."""
    ax = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    g = jnp.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2.0 * space_sigma**2))
    return g


def asw_volume(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    view: str = "left",
) -> jax.Array:
    """Adaptive-support-weight cost volume (`ASW/ASW.h:210-257,329-431`).

    cost(p, d) = sum_o wL(p,o) * wR(p-d,o) * e(p,o,d) / sum_o wL*wR with
    w(p,o) = exp(-|I(p)-I(p+o)|^2 / 2 sigma_c^2) * exp(-|o|^2 / 2 sigma_s^2)
    and e = min(|L(p+o) - R(p+o-d)|, T) (truncation applied to the uchar
    error before weighting, `ASW.h:358-366`).  The reference looks up the
    color term in a 256-entry LUT of exactly this exponential
    (`ASW.h:41-47`) — computed directly here.

    This is the jnp reference implementation: a `lax.scan` over the
    (2R+1)^2 window offsets with fully vectorized [D, H, W] work per step.
    The Pallas kernel in ``ops.kernels.asw_pallas`` is the GPU path.

    Inputs are unpadded uint8/float grayscale; replicate padding (radius+? )
    matches `ASW/ASWeight.cpp:54-55` (pad = win_size + 1 = radius).
    """
    if view == "right":
        return asw_volume_right(
            left, right, disp_range, win_size, space_sigma, color_sigma, truncation
        )
    radius = win_size + 1
    lf = left.astype(jnp.float32)
    rf = right.astype(jnp.float32)
    h, w = lf.shape

    space = _space_mask(radius, space_sigma)
    side = 2 * radius + 1

    lp = replicate_pad(lf, radius)
    rp = replicate_pad(rf, radius)

    # A[d] = min(|L - R(. - d)|, T) on padded images; the shift stack clamps
    # at the left edge but those entries are overwritten by border_fill.
    s_rp = shifted_stack(rp, disp_range, "left")
    err = jnp.minimum(jnp.abs(lp[None] - s_rp), truncation)  # [D, Hp, Wp]

    offsets = jnp.stack(
        jnp.meshgrid(jnp.arange(side), jnp.arange(side), indexing="ij"), -1
    ).reshape(-1, 2)
    space_flat = space.reshape(-1)

    hp, wp = lp.shape

    def step(carry, xs):
        num, den = carry
        (dy, dx), sp = xs
        # windows: for output pixel p (origin at radius), offset o=(dy-R, dx-R)
        l_sh = jax.lax.dynamic_slice(lp, (dy, dx), (h, w))
        r_sh = jax.lax.dynamic_slice(rp, (dy, dx), (h, w))
        l_c = jax.lax.dynamic_slice(lp, (radius, radius), (h, w))
        r_c = jax.lax.dynamic_slice(rp, (radius, radius), (h, w))
        w_l = jnp.exp(-((l_sh - l_c) ** 2) / (2.0 * color_sigma**2)) * sp
        w_r = jnp.exp(-((r_sh - r_c) ** 2) / (2.0 * color_sigma**2)) * sp
        # wR evaluated at p - d: gather the weight map shifted by d.
        w_r_d = shifted_stack(w_r, disp_range, "left")     # [D, H, W]
        e = jax.lax.dynamic_slice(err, (0, dy, dx), (disp_range, h, w))
        wlr = w_l[None] * w_r_d
        return (num + wlr * e, den + wlr), None

    num0 = jnp.zeros((disp_range, h, w), jnp.float32)
    den0 = jnp.zeros((disp_range, h, w), jnp.float32)
    (num, den), _ = jax.lax.scan(step, (num0, den0), (offsets, space_flat))
    vol = num / jnp.maximum(den, 1e-20)
    return border_fill(vol, "left")


def asw_volume_right(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
) -> jax.Array:
    """Right-view ASW volume (`ASW/ASW.h:382-431`) by mirror symmetry:
    searching rightward from the right image equals the left-view problem on
    horizontally flipped images with (left,right) roles swapped."""
    lf = jnp.asarray(left)[:, ::-1]
    rf = jnp.asarray(right)[:, ::-1]
    vol = asw_volume(
        rf, lf, disp_range, win_size, space_sigma, color_sigma, truncation, "left"
    )
    return vol[:, :, ::-1]


def _gauss_band_matrix(n: int, radius: int, sigma: float) -> jax.Array:
    """Banded Gaussian matrix ``G[q, p] = exp(-(q-p)^2 / 2 sigma^2)`` for
    ``|q - p| <= radius``, 0 outside — a truncated 1-D Gaussian blur as an
    matmul.  Two of these factor the exact 2-D ASW space mask
    (`getGausssianMask` `ASW/ASW.h:16-35` is separable)."""
    i = jnp.arange(n)
    dqp = (i[:, None] - i[None, :]).astype(jnp.float32)
    g = jnp.exp(-(dqp * dqp) / (2.0 * sigma * sigma))
    return jnp.where(jnp.abs(dqp) <= radius, g, 0.0)


def asw_volume_approx_grid(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    bins: int = 12,
    row_offset: int = 0,
    global_rows: int = None,
) -> jax.Array:
    """APPROXIMATE left-view ASW volume via an intensity-binned bilateral
    grid (PBFIC / Durand-Dorsey style) — the classic constant-time
    bilateral trade, opt-in through ``ASWConfig(approx='grid')``.

    ``row_offset``/``global_rows`` make the truncated-Gaussian row blur
    global-boundary-aware on a halo-extended row tile:
    the full-image blur implicitly contributes *nothing* outside the
    image, so extended rows whose global coordinate falls outside
    ``[0, global_rows)`` (edge-replicated halo padding) are zeroed out of
    both the numerator and the kernel-mass blur inputs — a ``radius``-row
    halo then reproduces the untiled blur exactly (up to matmul reduction
    order over the shorter row axis).

    **Non-parity by design**: the exact cost is
    ``sum_o wL(p,o) wR(p-d,o) e / sum w`` with ~10 operations per
    (pixel, offset, d) (`ops/kernels/asw_pallas.py`).  This path
    approximates it with

        J_b(p) = blur(k_b * e_d)(p) / blur(k_b)(p),
        cost(p, d) = interp_b J_b  at  I_L(p),

    where ``k_b = exp(-(I_L - c_b)^2 / 2 sigma_c^2)`` over ``bins``
    intensity centers, ``blur`` is the exact truncated-Gaussian space mask
    as two banded matmuls, and the output linearly interpolates the
    two nearest bins (hat weights — a partition of unity).  Two
    approximations vs the reference (`ASW/ASW.h:210-257`): the *right*
    window weight ``wR`` is dropped (single-guidance grid), and the color
    weight is evaluated at ``bins`` quantized centers instead of per
    pixel.  Use the default exact path for reference parity.
    """
    if bins < 2:
        raise ValueError(
            f"asw approx='grid' needs bins >= 2 (got {bins}): the hat "
            "interpolation between intensity centers is degenerate below "
            "two bins — raise ASWConfig(approx_bins=...)"
        )
    lf = jnp.asarray(left).astype(jnp.float32)
    rf = jnp.asarray(right).astype(jnp.float32)
    h, w = lf.shape
    radius = win_size + 1
    shifted = shifted_stack(rf, disp_range, "left")
    e = jnp.minimum(jnp.abs(lf[None] - shifted), truncation)   # [D, H, W]

    gh = _gauss_band_matrix(h, radius, space_sigma)
    gw = _gauss_band_matrix(w, radius, space_sigma)
    hi = jax.lax.Precision.HIGHEST
    if global_rows is None:
        row_ok = None
    else:
        gr = row_offset + jnp.arange(h)
        row_ok = ((gr >= 0) & (gr < global_rows)).astype(jnp.float32)[:, None]

    def blur(x):
        t = jnp.einsum("hq,...qw->...hw", gh, x,
                       preferred_element_type=jnp.float32, precision=hi)
        return jnp.einsum("...hw,wk->...hk", t, gw,
                          preferred_element_type=jnp.float32, precision=hi)

    centers = jnp.linspace(0.0, 255.0, bins)
    step = 255.0 / (bins - 1)
    out = jnp.zeros_like(e)
    inv2sc = 1.0 / (2.0 * color_sigma * color_sigma)
    for b in range(bins):
        c = centers[b]
        kb = jnp.exp(-((lf - c) ** 2) * inv2sc)                # [H, W]
        if row_ok is not None:
            kb = kb * row_ok
        jb = blur(kb[None] * e) / jnp.maximum(blur(kb), 1e-20)[None]
        hat = jnp.maximum(0.0, 1.0 - jnp.abs(lf - c) / step)   # [H, W]
        out = out + hat[None] * jb
    return border_fill(out, "left")


def asw_lab_volume(
    left_gray: jax.Array,
    right_gray: jax.Array,
    left_lab: jax.Array,
    right_lab: jax.Array,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    faithful_lut: bool = False,
) -> jax.Array:
    """Dormant Yoon-Kweon-style Lab-weight ASW variant
    (`ComputeWeigtColor` `ASW/ASW.h:49-80`, `ComputeProximity` `:82-105`,
    `ComputeCost` `:148-175`; never called by the committed driver).

    Per window pixel the color weight is the mean of three per-Lab-channel
    Gaussians and the proximity weight is the spatial Gaussian; the cost is
    the weighted mean absolute gray difference, truncated at the *cost*
    level (`ASW.h:171-173` caps the normalized cost, unlike the active path
    which truncates the per-pixel error).

    ``faithful_lut=True`` reproduces the reference quirk where the mean of
    the three Gaussians (a value in (0, 1]) is cast to int and used as an
    *index* into the 256-entry color LUT (`ASW.h:76-77`) — collapsing the
    color term to ~1 everywhere; default False = intended semantics.

    The scan structure parallels :func:`asw_volume`, but deliberately so:
    the two variants differ in weight inputs (Lab planes vs gray), error
    truncation level (cost vs per-pixel, `ASW.h:171` vs `:358`), and
    epilogue — a shared driver would need three callbacks and hide the
    semantic differences this dormant path exists to document.
    """
    radius = win_size + 1
    side = 2 * radius + 1
    lg = replicate_pad(left_gray.astype(jnp.float32), radius)
    rg = replicate_pad(right_gray.astype(jnp.float32), radius)
    ll = jnp.pad(left_lab.astype(jnp.float32), ((radius,) * 2, (radius,) * 2, (0, 0)), mode="edge")
    rl = jnp.pad(right_lab.astype(jnp.float32), ((radius,) * 2, (radius,) * 2, (0, 0)), mode="edge")
    h, w = left_gray.shape

    space = _space_mask(radius, space_sigma).reshape(-1)
    offsets = jnp.stack(
        jnp.meshgrid(jnp.arange(side), jnp.arange(side), indexing="ij"), -1
    ).reshape(-1, 2)
    inv2sc = 1.0 / (2.0 * color_sigma * color_sigma)

    def channel_weight(lab_sh, lab_c):
        g3 = jnp.exp(-((lab_sh - lab_c) ** 2) * inv2sc)  # [H, W, 3]
        mean3 = jnp.mean(g3, axis=-1)
        if faithful_lut:
            idx = mean3.astype(jnp.int32).astype(jnp.float32)  # 0 or 1
            return jnp.exp(-(idx * idx) * inv2sc)
        return mean3

    err = jnp.abs(lg[None] - shifted_stack(rg, disp_range, "left"))  # [D, Hp, Wp]

    def step(carry, xs):
        num, den = carry
        (dy, dx), sp = xs
        ll_sh = jax.lax.dynamic_slice(ll, (dy, dx, 0), (h, w, 3))
        rl_sh = jax.lax.dynamic_slice(rl, (dy, dx, 0), (h, w, 3))
        ll_c = jax.lax.dynamic_slice(ll, (radius, radius, 0), (h, w, 3))
        rl_c = jax.lax.dynamic_slice(rl, (radius, radius, 0), (h, w, 3))
        w_l = channel_weight(ll_sh, ll_c) * sp
        w_r = channel_weight(rl_sh, rl_c) * sp
        w_r_d = shifted_stack(w_r, disp_range, "left")
        e = jax.lax.dynamic_slice(err, (0, dy, dx), (disp_range, h, w))
        wlr = w_l[None] * w_r_d
        return (num + wlr * e, den + wlr), None

    num0 = jnp.zeros((disp_range, h, w), jnp.float32)
    den0 = jnp.zeros((disp_range, h, w), jnp.float32)
    (num, den), _ = jax.lax.scan(step, (num0, den0), (offsets, space))
    vol = jnp.minimum(num / jnp.maximum(den, 1e-20), truncation)
    return border_fill(vol, "left")
