"""Pallas kernel (Triton route, GPU) for the adaptive-support-weight volume.

The FLOP-heaviest op of the engine (SURVEY.md §2.6: a 25x25 window x D
disparities per pixel, `ASW/ASW.h:210-257,329-431`).

Why a kernel: the plain path (`ops.volume.asw_volume`) is a `lax.scan`
over the (2R+1)^2 window offsets whose carry is two ``[D, H, W]`` float32
accumulators.  The carry crosses scan steps, so XLA keeps it in device
memory and every one of the 625 steps reads and writes both volumes.
Here each block owns one ``[DC, TH, TW]`` output block (a disparity chunk
of a row/column tile) and keeps its ``num``/``den`` accumulators in
registers across the whole window loop; device memory sees the two
images once and the volume once.

Blocks are independent: the grid is (disparity chunk, row tile, column
tile) and nothing carries from one grid step to the next.  Window offsets
are pointer offsets: for offset (dy, dx) the left tile is read at
``lp[y0 + dy :, x0 + dx :]`` and the right operand of disparity ``d`` at
column ``x + dx + (DP - 1) - d`` of the right image padded by ``r + DP - 1``
columns on the left (the shear identity: every right operand is a
horizontal shift of the one right image, so a block reads a
``[TH + 2r, TW + 2r + DC - 1]`` band, served from L1 across the loop).

Weight algebra (the reference's product, one transcendental per
(pixel, offset, d)):

    w = exp(-dL^2/2sc^2) * exp(-dR^2/2sc^2) * exp(-|o|^2/2ss^2)^2
      = exp(-(dL^2 + dR^2)/2sc^2 - |o|^2/ss^2)

(`bilateralfiterWight` multiplies the space mask into *both* the left and
right masks — `ASW/ASW.h:222-248` — hence the squared space term.)

Tile sizes are powers of two (the Triton route requires it); the image
is padded up to whole tiles and the disparity range to whole chunks, and
the padding is cropped before :func:`ops.volume.border_fill`.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from stereo_match_traditional_tpu.ops.volume import border_fill

_DC = 4     # disparities per block
_TH = 8     # rows per block
_TW = 64    # columns per block
_NUM_WARPS = 4
_NUM_STAGES = 1


def resolve_use_pallas(use_pallas: Optional[bool]) -> bool:
    """Whether the ASW volume runs through this kernel.

    ``None`` selects the kernel exactly when the default backend is the
    GPU, where it compiles through Triton.  ``True`` on another backend
    raises: the kernel has no compiled route there, and it never falls
    back to the Pallas interpreter on its own.
    """
    backend = jax.default_backend()
    if use_pallas is None:
        return backend == "gpu"
    if use_pallas and backend != "gpu":
        raise ValueError(
            f"ASWConfig(use_pallas=True) needs the GPU backend (have "
            f"{backend!r}); the ASW kernel compiles only through Triton — "
            "use use_pallas=None/False, or call asw_volume_pallas(..., "
            "interpret=True) to run it in the Pallas interpreter"
        )
    return bool(use_pallas)


def _asw_kernel(lp_ref, rp_ref, out_ref, *, radius, d_pad, inv2sc, inv_ss, trunc):
    c = pl.program_id(0)
    y0 = pl.program_id(1) * _TH
    x0 = pl.program_id(2) * _TW
    side = 2 * radius + 1
    shape = (_DC, _TH, _TW)
    dk = lax.broadcasted_iota(jnp.int32, shape, 0) + c * _DC
    rows = lax.broadcasted_iota(jnp.int32, shape, 1) + y0
    # right-image column of (x, d) at window column 0, in the padded frame
    cols = lax.broadcasted_iota(jnp.int32, shape, 2) + x0 + (d_pad - 1) - dk

    l_c = lp_ref[pl.ds(y0 + radius, _TH), pl.ds(x0 + radius, _TW)]
    r_c = rp_ref[rows + radius, cols + radius]

    def dy_body(dy, carry):
        vspace = (dy - radius) * (dy - radius)

        def dx_body(dx, carry):
            num, den = carry
            l_o = lp_ref[pl.ds(y0 + dy, _TH), pl.ds(x0 + dx, _TW)]     # [TH, TW]
            r_o = rp_ref[rows + dy, cols + dx]                          # [DC, TH, TW]
            space = (vspace + (dx - radius) * (dx - radius)).astype(jnp.float32)
            dl = l_o - l_c
            a = dl * dl * inv2sc + space * inv_ss                       # [TH, TW]
            dr = r_o - r_c
            w = jnp.exp(-(dr * dr * inv2sc + a[None]))
            e = jnp.minimum(jnp.abs(l_o[None] - r_o), trunc)
            return num + w * e, den + w

        return lax.fori_loop(0, side, dx_body, carry)

    zero = jnp.zeros(shape, jnp.float32)
    num, den = lax.fori_loop(0, side, dy_body, (zero, zero))
    out_ref[...] = num / jnp.maximum(den, 1e-20)


@functools.partial(
    jax.jit,
    static_argnames=(
        "disp_range", "win_size", "space_sigma", "color_sigma", "truncation",
        "interpret",
    ),
)
def _asw_left(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int,
    space_sigma: float,
    color_sigma: float,
    truncation: float,
    interpret: bool,
) -> jax.Array:
    radius = win_size + 1
    h, w = left.shape
    d_pad = -(-disp_range // _DC) * _DC
    hp = -(-h // _TH) * _TH
    wp = -(-w // _TW) * _TW
    # Edge padding: `radius` rows/cols of window halo (the reference's
    # replicate border, `ASW/ASWeight.cpp:54-55`) plus the tile round-up;
    # the right image also carries a d_pad-1 column left halo.  Its
    # clamped values reach only the d > x triangle, which border_fill
    # overwrites below.
    lp = jnp.pad(left.astype(jnp.float32),
                 ((radius, hp - h + radius), (radius, wp - w + radius)), "edge")
    rp = jnp.pad(right.astype(jnp.float32),
                 ((radius, hp - h + radius), (radius + d_pad - 1, wp - w + radius)),
                 "edge")
    kernel = functools.partial(
        _asw_kernel,
        radius=radius,
        d_pad=d_pad,
        inv2sc=1.0 / (2.0 * color_sigma * color_sigma),
        inv_ss=1.0 / (space_sigma * space_sigma),
        trunc=float(truncation),
    )
    vol = pl.pallas_call(
        kernel,
        grid=(d_pad // _DC, hp // _TH, wp // _TW),
        in_specs=[pl.BlockSpec(), pl.BlockSpec()],
        out_specs=pl.BlockSpec((_DC, _TH, _TW), lambda c, i, j: (c, i, j)),
        out_shape=jax.ShapeDtypeStruct((d_pad, hp, wp), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        interpret=interpret,
        name="asw_volume",
    )(lp, rp)
    return border_fill(vol[:disp_range, :h, :w], "left")


def asw_volume_pallas(
    left: jax.Array,
    right: jax.Array,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    view: str = "left",
    interpret: bool = False,
) -> jax.Array:
    """Drop-in replacement for `ops.volume.asw_volume` (`ASW/ASW.h:329-431`).

    Compiled through Triton for the GPU.  ``interpret=True`` runs the same
    kernel in the Pallas interpreter (how the CPU tests check it); on any
    other backend without ``interpret`` this raises rather than fall back.
    The right view reuses the left kernel through the mirror identity
    (`ops.volume.asw_volume_right`).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            f"asw_volume_pallas compiles only for the GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it in "
            "the Pallas interpreter"
        )
    args = (disp_range, win_size, space_sigma, color_sigma, truncation, interpret)
    if view == "right":
        vol = _asw_left(jnp.asarray(right)[:, ::-1], jnp.asarray(left)[:, ::-1], *args)
        return vol[:, :, ::-1]
    if view != "left":
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    return _asw_left(jnp.asarray(left), jnp.asarray(right), *args)
