"""Device mesh construction.

The reference's only parallelism is (racy) OpenMP loop pragmas
(SURVEY.md §2.6); the engine's device-parallel replacements are:

* tile-DP: image rows sharded over the ``tile`` mesh axis (`shard_map`
  + halo exchange, `parallel.tiled`);
* disparity parallelism (the TP analogue): the D axis sharded over the
  ``disp`` axis with a two-stage WTA (`parallel.wta_shard`);
* sequence parallelism (the CP analogue): the scanline resharded
  between row and column tiles with all_to_all (`parallel.scan_carry`).

The mesh is a flat device list reshaped to the algorithm's axes: the
cards of a host reach each other all to all, so no axis order is
preferred.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("tile",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over the first ``n_devices`` devices.

    ``shape`` reshapes the device list for multi-axis meshes, e.g.
    ``make_mesh(8, ("tile", "disp"), (4, 2))``.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is None:
        # with an explicit shape, take exactly prod(shape) devices — using
        # every device would make the reshape below fail whenever more are
        # available than the mesh needs
        n_devices = int(np.prod(shape)) if shape is not None else len(devs)
    if n_devices > len(devs):
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"shape {tuple(shape)} does not use {n_devices} devices")
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))
