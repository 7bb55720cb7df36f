"""Halo exchange over the row-tile axis (inside shard_map).

Aggregation windows (<=25 px ASW, <=34 px arms x passes, 4 px census rows)
need boundary overlap between adjacent row tiles (SURVEY.md §2.6 item 4);
this is the `ppermute` neighbor exchange between devices that replaces the
reference's shared-memory window reads (`SAD/Sad.h:15-20` et al.).

The halo may exceed the tile height (e.g. CBLSM's two aggregation passes
need 68 rows while a 375-row image on 8 chips has 47-row tiles), so the
exchange runs ``ceil(halo / tile_rows)`` hops: hop k shifts full tiles k
devices along the ring, and the global top/bottom edges substitute a
replicated edge row — exactly the `BORDER_REPLICATE` the reference applies
to the whole image (`SAD/SADmain.cpp:47-48`), so tiled == untiled for any op
whose receptive field <= halo (the invariance test, SURVEY.md §4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_down(x: jax.Array, axis_name: str, edge_fix: jax.Array) -> jax.Array:
    """Each device receives the tile of the device *above* it (idx-1);
    device 0 receives ``edge_fix`` (the virtual tile above the image)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    if n > 1:
        recv = lax.ppermute(x, axis_name, [(i, i + 1) for i in range(n - 1)])
    else:
        recv = x
    return jnp.where(idx == 0, edge_fix, recv)


def _shift_up(x: jax.Array, axis_name: str, edge_fix: jax.Array) -> jax.Array:
    """Each device receives the tile of the device *below* it (idx+1);
    the last device receives ``edge_fix``."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    if n > 1:
        recv = lax.ppermute(x, axis_name, [(i + 1, i) for i in range(n - 1)])
    else:
        recv = x
    return jnp.where(idx == n - 1, edge_fix, recv)


def add_row_halo(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Extend a row-sharded tile with ``halo`` rows from each neighbor.

    ``x`` is the local tile ``[H_tile, ...]`` inside a shard_map over
    ``axis_name``.  Hop k delivers the tile k devices away; beyond the global
    image the virtual tiles are full-tile replications of the global edge
    row, built recursively: the virtual tile above tile 0 is
    ``repeat(row 0)``, and shifting that chain keeps every out-of-image tile
    equal to the edge-row replication (BORDER_REPLICATE semantics).
    """
    if halo <= 0:
        return x
    t = x.shape[0]
    hops = -(-halo // t)  # ceil

    rep_shape = (t,) + (1,) * (x.ndim - 1)

    above = []  # above[k] = tile k+1 devices up (or virtual edge tile)
    cur = x
    for _ in range(hops):
        edge = jnp.tile(cur[:1], rep_shape)
        cur = _shift_down(cur, axis_name, edge)
        above.append(cur)
    below = []
    cur = x
    for _ in range(hops):
        edge = jnp.tile(cur[-1:], rep_shape)
        cur = _shift_up(cur, axis_name, edge)
        below.append(cur)

    top = jnp.concatenate(above[::-1], axis=0)[-halo:]
    bottom = jnp.concatenate(below, axis=0)[:halo]
    return jnp.concatenate([top, x, bottom], axis=0)


def crop_row_halo(x: jax.Array, halo: int, axis: int = 0) -> jax.Array:
    """Drop ``halo`` rows from both ends of ``axis`` (undo add_row_halo)."""
    if halo <= 0:
        return x
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(halo, x.shape[axis] - halo)
    return x[tuple(sl)]
