"""Where JAX keeps its persistent compilation cache, and how several
programs are compiled at once (:func:`compile_concurrently`).

One rule for every entry point (CLI, ``bench.py``, ``chip_smoke.py``, the
test suite): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing is set in code; otherwise the cache goes to :data:`CACHE_DIR`,
one fixed directory inside the checkout (listed in ``.gitignore``), so
every run from one checkout finds what earlier runs compiled.
"""

from __future__ import annotations

import os

#: The in-checkout cache directory used when the environment names none.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory (see the module docstring for the rule)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def compile_concurrently(jobs) -> list:
    """Compile every ``(jitted, args)`` of ``jobs`` at once and return each
    job's compile seconds.

    The programs are lowered one after another (tracing holds the GIL),
    then compiled on a thread pool (XLA releases it), so the wall time is
    about that of the slowest compile rather than the sum.  JAX keeps each
    compiled program with its jit object, so a later call, or
    ``lower(*args).compile()``, with the same arguments reuses it.
    """
    import time
    from concurrent.futures import ThreadPoolExecutor

    lowered = [fn.lower(*args) for fn, args in jobs]

    def compile_one(low):
        t0 = time.perf_counter()
        low.compile()
        return time.perf_counter() - t0

    if not lowered:
        return []
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(compile_one, lowered))
