"""Batched execution and a pipelined serving loop.

The reference processes exactly one hard-coded pair per run
(`SAD/SADmain.cpp:27-28` et al.).  For production serving the engine maps
any pipeline over a batch axis (one program for the whole batch) and
overlaps host decode with device compute through the native threaded pair
loader (`utils/native.PairLoader`).

`lax.map` batching (the default) runs the examples one after another
inside the program, so each keeps single-pair memory use; ``vmap`` fuses
the batch into every op and multiplies the gather sources by the batch.
Which wins on the GPU at serving sizes is ROADMAP speed item 6.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_match_traditional_tpu.models.base import StereoResult
from stereo_match_traditional_tpu.models.registry import get_pipeline


def batched_pipeline(name: str, cfg=None, method: str = "map",
                     mesh=None, axis_name: str = "batch"):
    """Jitted ``(left [B,H,W], right [B,H,W]) -> StereoResult`` with every
    result field batched along axis 0.

    ``method='map'`` (default) runs examples sequentially inside one XLA
    program (`lax.map`), so each example's SAT gathers keep single-pair
    source sizes (see `aggregate._rect_sums_shared_bounds`).
    ``method='vmap'`` fuses the batch into every op, multiplying those
    sources by the batch.

    ``mesh``: batch-data-parallel scale-out — the batch axis shards over
    ``mesh[axis_name]`` (each device runs its examples with the chosen
    method; embarrassingly parallel, zero collectives — the throughput
    complement to `parallel.tiled`'s per-pair latency sharding).  The
    batch must divide the device count; results equal the unsharded run
    bit-for-bit (per-example programs are identical)."""
    fn, cfg_cls = get_pipeline(name)
    if cfg is None:
        cfg = cfg_cls()

    def one(l, r):
        return fn(l, r, cfg)

    if method == "vmap":
        base = jax.vmap(one)
    elif method == "map":
        base = lambda ls, rs: jax.lax.map(lambda lr: one(*lr), (ls, rs))  # noqa: E731
    else:
        raise ValueError(f"method must be 'map' or 'vmap': {method}")
    if mesh is None:
        return jax.jit(base)

    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis_name]
    spec = P(axis_name)
    sharded = jax.shard_map(
        base, mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False
    )

    def run(ls, rs):
        if ls.shape[0] % n:
            raise ValueError(
                f"batch {ls.shape[0]} must divide the {axis_name} axis ({n});"
                " serve_pairs pads partial batches"
            )
        return sharded(ls, rs)

    return jax.jit(run)


def serve_pairs(
    name: str,
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
    cfg=None,
    batch_size: int = 1,
    mesh=None,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Stream disparity maps for an iterable of (left, right) uint8 pairs.

    Pads the final partial batch (results are cropped back).  Pair shapes
    must be uniform — the engine compiles one program per (batch, H, W).
    Use ``utils.native.PairLoader`` as the iterable to overlap decode with
    device compute; pass ``mesh`` to shard each batch over devices
    (batch-DP — ``batch_size`` must then divide the mesh's batch axis).
    """
    run = batched_pipeline(name, cfg, mesh=mesh)
    buf_l, buf_r = [], []

    def flush():
        n = len(buf_l)
        if n == 0:
            return
        reps = batch_size - n
        ls = np.stack(buf_l + [buf_l[-1]] * reps)
        rs = np.stack(buf_r + [buf_r[-1]] * reps)
        res = run(jnp.asarray(ls), jnp.asarray(rs))
        disp = np.asarray(
            res.disp_final if res.disp_final is not None else res.disp_left
        )
        for k in range(n):
            yield disp[k]
        buf_l.clear()
        buf_r.clear()

    for left, right in pairs:
        buf_l.append(np.asarray(left))
        buf_r.append(np.asarray(right))
        if len(buf_l) == batch_size:
            yield from flush()
    yield from flush()
