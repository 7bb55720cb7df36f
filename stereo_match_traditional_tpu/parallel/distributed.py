"""Multi-process initialization (SURVEY.md §5).

The reference is a single-process CPU program; the engine's multi-process
story is JAX's standard distributed runtime with no custom transport.
This wrapper makes the one required call idempotent and builds the
``(host, chip)`` mesh the sharded pipelines expect.

Typical multi-process launch (one process per host, same program):

    from stereo_match_traditional_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = distributed.host_chip_mesh()      # Mesh[(host, chip)]
    fn = tiled_pipeline("ad_census", cfg, mesh, axis_name="chip")
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False

#: Environment variables whose presence means a multi-process launch was
#: *requested* — a failure to initialize must then surface, not degrade to
#: single-process mode (which would silently build a wrong 1-host mesh).
_COORD_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def _multi_host_requested() -> bool:
    return any(os.environ.get(k) for k in _COORD_ENV_VARS)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> str:
    """Idempotent `jax.distributed.initialize` (env-driven through
    ``JAX_COORDINATOR_ADDRESS`` when the arguments are None).

    Must be the first JAX call in the process: `jax.distributed.initialize`
    refuses to run once the XLA backend exists, so this wrapper never
    queries devices/process_count before initializing.

    Returns a status string: ``"initialized"`` (distributed runtime up),
    ``"already-initialized"`` (second call, no-op), or
    ``"single-process"`` (no coordinator configured anywhere — only
    possible when neither the arguments nor the environment request a
    multi-process run; a *requested* multi-process launch that fails
    re-raises instead of degrading silently)."""
    global _initialized
    if _initialized:
        return "already-initialized"
    requested = (
        any(a is not None for a in (coordinator_address, num_processes, process_id))
        or _multi_host_requested()
    )
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except (ValueError, RuntimeError):
        if requested:
            raise
        # Nothing asked for a distributed run: plain single-process mode.
        _initialized = True
        return "single-process"
    _initialized = True
    return "initialized"


def host_chip_mesh(axis_names=("host", "chip")) -> Mesh:
    """``(num_hosts, chips_per_host)`` mesh over all devices, ordered so the
    chip axis stays within a host (its collectives never leave the host)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_host = jax.process_count()
    per_host = len(devs) // n_host
    arr = np.array(devs).reshape(n_host, per_host)
    return Mesh(arr, tuple(axis_names))
