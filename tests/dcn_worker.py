"""Worker program for the two-process test (not collected by pytest).

Launched twice by ``test_distributed_dcn.py`` as
``python dcn_worker.py <rank> <port>``.  Each process owns 4 virtual CPU
devices; together they form the 2-host x 4-chip world the
`parallel.distributed` helpers target (SURVEY.md §5 "Distributed
communication backend").  The tile axis of the pipeline mesh spans both
processes, so halo exchange and the WTA collectives actually cross the
process boundary (over gloo on the CPU backend).
"""

import os
import sys

rank = int(sys.argv[1])
port = sys.argv[2]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Must be the first backend-touching call in the process.
from stereo_match_traditional_tpu.parallel import distributed  # noqa: E402

status = distributed.initialize(f"127.0.0.1:{port}", 2, rank)
assert status == "initialized", status
assert jax.process_count() == 2, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 8

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from stereo_match_traditional_tpu import config as cfgs  # noqa: E402
from stereo_match_traditional_tpu.models import get_pipeline  # noqa: E402
from stereo_match_traditional_tpu.parallel import run_tiled  # noqa: E402
from stereo_match_traditional_tpu.parallel.distributed import (  # noqa: E402
    host_chip_mesh,
)
from stereo_match_traditional_tpu.parallel.mesh import make_mesh  # noqa: E402
from stereo_match_traditional_tpu.utils.synthetic import make_pair  # noqa: E402

# The canonical (host, chip) mesh must reflect the real topology.
hc = host_chip_mesh()
assert hc.axis_names == ("host", "chip")
assert hc.shape["host"] == 2 and hc.shape["chip"] == 4, dict(hc.shape)

# Row-tile an 8-way mesh whose tile axis crosses the process boundary.
devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
mesh = make_mesh(8, ("tile",), devices=devs)

cfg = cfgs.SADConfig(max_disparity=8, winsize=1)
L, R, _ = make_pair(32, 48, 8, seed=6)
got = run_tiled("sad", L, R, cfg, mesh)

# Replicate the (globally sharded) disparity map so each process can read
# a full local copy, then compare with the independent single-device run.
replicate = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
disp = np.asarray(jax.device_get(replicate(got.disp_left).addressable_data(0)))

fn, _ = get_pipeline("sad")
want = np.asarray(fn(jnp.asarray(L), jnp.asarray(R), cfg).disp_left)

mismatch = float(np.mean(disp[:, 8:-8] != want[:, 8:-8]))
assert mismatch == 0.0, mismatch
print(f"DCN-OK rank={rank} mismatch={mismatch}", flush=True)
