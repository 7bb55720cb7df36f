"""Per-invocation device time by differencing two loop lengths.

:func:`device_time` runs the workload N times sequentially *inside one
jitted program* (a ``fori_loop`` whose body depends on the induction
variable, so iterations cannot be CSE'd away), fetches a scalar checksum
(forcing completion), and differences two iteration counts so that the
fixed cost of a call — dispatch, the checksum's transfer, the host round
trip — cancels:

    t_iter = (T(n_hi) - T(n_lo)) / (n_hi - n_lo)
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp


def device_time(
    fn: Callable,
    args: Sequence,
    n_lo: int = 2,
    n_hi: int = 12,
    reps: int = 3,
) -> float:
    """Median seconds per invocation of ``fn(*args)`` on device.

    ``fn`` must return an array (any shape); its sum feeds the checksum.
    EVERY array leaf of every argument (through pytrees) is perturbed by
    the induction variable each iteration: anything that depends on an
    un-bumped operand is loop-invariant and XLA hoists it out of the
    timing loop entirely (a both-views pipeline whose right-image work
    entered through a later argument measured 92x too fast this way).
    Numeric arrays get ``+ (i % 3)``, bool arrays ``XOR (i % 2)``; Python
    scalars and 0-d inputs stay stable (they are configuration, and
    perturbing them would change the measured workload).
    """

    def _bumpable(x) -> bool:
        return (
            hasattr(x, "dtype")
            and getattr(x, "ndim", 0) >= 1
            and (
                jnp.issubdtype(x.dtype, jnp.number)
                or jnp.issubdtype(x.dtype, jnp.bool_)
            )
        )

    # decide from the *original* args (inside jit every scalar is a tracer,
    # indistinguishable from a real array input)
    bump_mask = jax.tree_util.tree_map(_bumpable, tuple(args))

    def looped(n_static):
        @jax.jit
        def run(a):
            def body(i, acc):
                def bump_leaf(x, do_bump):
                    if not do_bump:
                        return x
                    if jnp.issubdtype(x.dtype, jnp.bool_):
                        return x ^ (i % 2).astype(jnp.bool_)
                    return (x.astype(jnp.float32) + (i % 3).astype(jnp.float32)).astype(
                        x.dtype
                    )

                bumped = jax.tree_util.tree_map(bump_leaf, a, bump_mask)
                out = fn(*bumped)
                return acc + jnp.sum(out.astype(jnp.float32))

            return jax.lax.fori_loop(0, n_static, body, jnp.float32(0.0))

        return run

    run_lo = looped(n_lo)
    run_hi = looped(n_hi)
    args = tuple(args)
    float(run_lo(args))  # compile
    float(run_hi(args))

    def measure(r):
        t0 = time.perf_counter()
        float(r(args))
        return time.perf_counter() - t0

    deltas = []
    for _ in range(reps):
        t_lo = measure(run_lo)
        t_hi = measure(run_hi)
        deltas.append((t_hi - t_lo) / (n_hi - n_lo))
    deltas.sort()
    return max(deltas[len(deltas) // 2], 1e-9)
