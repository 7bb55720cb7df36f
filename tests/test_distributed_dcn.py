"""Two-process validation (SURVEY.md §5).

The reference is a single-process program (`SAD/SAD.vcxproj` OpenMP only);
the engine's multi-process leg is `jax.distributed` + cross-process
collectives.
This test executes that leg for real: two OS processes, a localhost
coordinator, 4 virtual CPU devices each, and a tiled pipeline whose row
tiles span the process boundary — asserting the result equals the
single-process run bit-for-bit.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "dcn_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_tiled_pipeline_matches_single_process():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # The workers force the CPU backend themselves (jax.config.update);
    # drop any inherited XLA_FLAGS so the device count is exactly 4 each.
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(rank), str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("workers timed out:\n" + "\n---\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"DCN-OK rank={rank}" in out, out
