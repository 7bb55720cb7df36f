"""Disparity selection (layer L3): WTA, uniqueness ratio, parabola subpixel.

The reference implements WTA five separate times with small variations
(`SAD/Sad.h:22-85`, `NCC/NCC.h:53-67`, `ASW/ASW.h:193-208`,
`AD-Census.h:346-380`, `CrossArm.cpp:33-57`, `CBLSM/CBLSM.h:249-407`); this
module is the single shared library.  Ties always resolve to the *first*
(lowest-d) extremum, matching the strict comparisons in every C++ loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def wta(vol: jax.Array, mode: str = "min") -> jax.Array:
    """Plain winner-take-all over the disparity axis (axis 0).

    mode='min': `AD-Census.h:346-380`, `CrossArm.cpp:33-57`,
    `CBLSM.h:383-407`, `ASW.h:193-208`.  mode='max': NCC similarity argmax
    (`NCC/NCC.h:53-67` — the `<` comparison makes it a max despite naming).
    """
    if mode == "min":
        return jnp.argmin(vol, axis=0).astype(jnp.float32)
    return jnp.argmax(vol, axis=0).astype(jnp.float32)


def optimal_disparity(
    vol: jax.Array,
    uniqueness_eps: float = 0.01,
    subpixel: bool = False,
    exclude_d0: bool = True,
) -> jax.Array:
    """WTA with uniqueness test and (optional) parabola refinement,
    matching `SAD/Sad.h:40-85` / `CBLSM/CBLSM.h:249-294`.

    Semantics reproduced:
      * the argmin scan starts at d=1 (`Sad.h:46`), so d=0 never wins —
        controlled by ``exclude_d0`` (default faithful);
      * ``secMin`` is the minimum over every cost *not equal* to the best
        cost, seeded with cost[0] (`Sad.h:44,55-64`); if
        ``secMin - min <= eps`` the pixel is rejected to 0 (`Sad.h:66-69`);
      * a best disparity at either end of the range is rejected to 0
        (`Sad.h:71-74`);
      * the parabola offset ``(c1-c2) / (2*max(1, c1+c2-2*min))``
        (`Sad.h:76-81`) is computed but *discarded* by the reference
        (`Sad.h:84`); ``subpixel=True`` keeps it.
    """
    d = vol.shape[0]
    scan = vol[1:] if exclude_d0 else vol
    best_rel = jnp.argmin(scan, axis=0)
    best = best_rel + (1 if exclude_d0 else 0)
    # every per-pixel pick below is a masked reduction, NOT a
    # take_along_axis: elementwise passes instead of axis-0 element gathers
    # over the volume
    minval = jnp.min(scan, axis=0)

    # secMin is seeded with cost[0] (`Sad.h:44`) and then takes the min over
    # every cost != best; when cost[0] happens to equal the best cost the
    # seed keeps secMin == min and the pixel is rejected.
    not_min = vol != minval[None]
    sec = jnp.min(jnp.where(not_min, vol, jnp.inf), axis=0)
    sec = jnp.minimum(vol[0], sec)

    reject = (sec - minval <= uniqueness_eps) | (best == 0) | (best == d - 1)

    dd = jax.lax.broadcasted_iota(jnp.int32, vol.shape, 0)
    c1 = jnp.min(jnp.where(dd == (best - 1)[None], vol, jnp.inf), axis=0)
    c2 = jnp.min(jnp.where(dd == (best + 1)[None], vol, jnp.inf), axis=0)
    # best±1 out of range only where reject is already true — the inf
    # placeholder never reaches the output
    denom = jnp.maximum(1.0, c1 + c2 - 2.0 * minval)
    refined = best.astype(jnp.float32) + (c1 - c2) / (2.0 * denom)

    out = refined if subpixel else best.astype(jnp.float32)
    return jnp.where(reject, 0.0, out)


def wta_with_cost(vol: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Argmin + its cost (two fused reductions, no axis-0 gather)."""
    best = jnp.argmin(vol, axis=0)
    cost = jnp.min(vol, axis=0)
    return best.astype(jnp.float32), cost


def wta_sum(vol_a: jax.Array, vol_b: jax.Array) -> jax.Array:
    """The dormant `ComputeDisp` hybrid (`CBLSM/CBLSM.h:296-325`): argmin
    over d of the elementwise *sum* of two volumes (the driver feeds the
    disparity-conditioned arm-count volume plus the cost volume)."""
    return wta(vol_a.astype(jnp.float32) + vol_b.astype(jnp.float32), "min")
