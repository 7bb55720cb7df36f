"""Tracing / profiling utilities (SURVEY.md §5).

The reference's only observability is progress percentages printed from
inside (racy) OpenMP loops (`SAD/Sad.h:136-137`, `NCC/NCC.h:93`,
`ASW/ASW.h:376`).  Here: structured per-stage wall timings, named XLA trace
scopes that show up in `jax.profiler` / Perfetto, and a one-call profile
context.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import jax


class StageTimer:
    """Accumulates named stage wall times; prints one JSON line on report.

    Wall times include dispatch only unless the stage materializes (see
    utils.benchmark for honest device timing); this is for coarse host-side
    observability.
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return json.dumps({"stages_ms": {k: round(v * 1e3, 3) for k, v in self.times.items()}})


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Capture an XLA profiler trace (viewable in XProf/Perfetto)."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Decorator adding a named trace scope around a stage function."""

    def deco(fn):
        def wrapped(*a, **k):
            with jax.profiler.TraceAnnotation(name):
                return fn(*a, **k)

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    return deco


def stage_scope(name: str):
    """Named scope for a pipeline stage *inside* jitted code.

    `jax.named_scope` attaches the name to the HLO metadata of every op
    traced under it, so an XProf/Perfetto trace of a compiled pipeline
    shows `stereo/<stage>` groups (the device-side counterpart of
    :class:`StageTimer`'s host-side wall times; the reference's analogue
    is cout percentages inside hot loops, `SAD/Sad.h:136-137`).  Every
    model pipeline wraps its stages in these scopes.
    """
    return jax.named_scope(f"stereo/{name}")
