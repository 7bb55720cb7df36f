"""Smoke run of the stereo engine on the GPU: the quickest proof it starts.

Drives the main paths once, compiled for the card, through the entry
points a user calls (``models.get_pipeline``, ``parallel.streamed_pipeline``,
``models.batch.batched_pipeline`` and the CLI's ``run``), and checks each
result by the engine's own means: bad-2.0 against the generated ground
truth of ``utils.synthetic.make_pair``, the plain jnp reference for the
ASW kernel, float64 NumPy sums for the float32 matrix products, and the
one-card run for the multi-card paths.

    python chip_smoke.py                # one card, every one-card phase
    python chip_smoke.py --four-cards   # the multi-card paths only (4 GPUs)

Each phase prints one JSON line (compile seconds, ``memory_analysis()``,
the wall time of one run after warm-up, ``peak_bytes_in_use`` and the
check's numbers).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
where N is the number of cards the phases used (1, or 4 with
``--four-cards``).
Without a GPU, or when any phase fails, the script exits non-zero and
prints no result line.  Everything runs in this one process.

The phase functions take their shapes as arguments so the CPU tests can
run them small; ``tests/test_gpu_smoke.py`` calls them at full size on
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TEDDY = (375, 450, 60)
SERVING = (720, 1280, 128)
UHD = (2160, 3840, 256)

#: bad-2.0 bounds of the five active reference paths at TEDDY.
REFERENCE_BAD2 = {"sad": 0.30, "ncc": 0.30, "asw": 0.15, "ad_census": 0.15,
                  "cblsm": 0.20}
FULL_BAD2 = 0.15
#: tie-flip envelope of the sharded/streamed executors outside the clamp
#: triangle (tests/test_parallel.py, tests/test_streamed.py)
TIE_FLIP = 5e-3


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """``name, power.limit`` of the cards, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _memory_analysis(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def _peak_bytes():
    """Largest ``peak_bytes_in_use`` over the devices (a process-wide high
    water mark), or None where the backend keeps no statistics."""
    import jax

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def measure(fn, *args):
    """Compile ``fn`` for ``args``, run it once to warm up, then time one
    run on the host clock around ``block_until_ready``.  Returns
    ``(output, stats)``."""
    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    t0 = time.perf_counter()
    lowered = jitted.lower(*args)
    lower_s = time.perf_counter() - t0
    # progress on stderr, so a run cut by its time limit shows where it was
    print(f"chip_smoke: lowered in {lower_s:.1f} s, compiling", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    print(f"chip_smoke: compiled in {compile_s:.1f} s", file=sys.stderr, flush=True)
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    run_s = time.perf_counter() - t0
    return out, {
        "lower_s": round(lower_s, 3),
        "compile_s": round(compile_s, 3),
        "memory_analysis": _memory_analysis(compiled),
        "run_s": run_s,
        "peak_bytes_in_use": _peak_bytes(),
    }


def _pair(h, w, d, seed=0):
    import jax.numpy as jnp

    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    left, right, gt = make_pair(h, w, d, seed=seed)
    return jnp.asarray(left), jnp.asarray(right), gt


def _bad2(disp, gt) -> float:
    from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate

    return bad_pixel_rate(np.asarray(disp), gt)


def _check_range(tag, disp, d, allow_nonfinite=False):
    disp = np.asarray(disp)
    finite = np.isfinite(disp)
    check(allow_nonfinite or finite.all(), f"{tag}: non-finite disparities")
    vals = disp[finite]
    check(vals.size > 0 and vals.min() >= 0 and vals.max() <= d,
          f"{tag}: disparities outside [0, {d}]")


def _mismatch(a, b, ignore_cols=0, side="left") -> float:
    """Fraction of differing pixels outside the ``ignore_cols`` clamp
    strip (left edge for left-view maps, right edge for the right view)."""
    sl = (slice(ignore_cols, None) if side == "left"
          else slice(None, -ignore_cols or None))
    return float(np.mean(np.asarray(a)[:, sl] != np.asarray(b)[:, sl]))


def _full_cfg(d):
    from stereo_match_traditional_tpu import config as cfgs

    return cfgs.ADCensusConfig(disp_range=d, scanline=cfgs.ScanlineConfig(),
                               run_post=True)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_reference_paths(shape=TEDDY, bounds=REFERENCE_BAD2,
                          names=tuple(REFERENCE_BAD2)):
    """The five active reference paths through ``models.get_pipeline``."""
    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models import get_pipeline

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    configs = {
        "sad": cfgs.SADConfig(max_disparity=d),
        "ncc": cfgs.NCCConfig(disp_range=d),
        "asw": cfgs.ASWConfig(disp_range=d),
        "ad_census": cfgs.ADCensusConfig(disp_range=d),
        "cblsm": cfgs.CBLSMConfig(disp_range=d),
    }
    for name in names:
        cfg = configs[name]
        fn, _ = get_pipeline(name)
        res, stats = measure(lambda l, r, fn=fn, cfg=cfg: fn(l, r, cfg), left, right)
        # ncc keeps its never-wins sentinel outside the interior
        _check_range(name, res.disp_left, d, allow_nonfinite=name == "ncc")
        bad2 = _bad2(res.disp_left, gt)
        check(bad2 <= bounds[name], f"{name}: bad-2.0 {bad2} > {bounds[name]}")
        yield {"phase": f"reference/{name}", "shape": [h, w, d], **stats,
               "bad2": bad2, "bad2_bound": bounds[name]}


def phase_full(shape=TEDDY, bound=FULL_BAD2):
    """``ad_census`` FULL (scanline + the whole post chain) through
    ``models.get_pipeline``; ``bound=None`` asserts only finite output in
    [0, D] (at D >= 128 ``make_pair``'s ground truth is weak)."""
    from stereo_match_traditional_tpu.models import get_pipeline

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    cfg = _full_cfg(d)
    fn, _ = get_pipeline("ad_census")
    res, stats = measure(lambda l, r: fn(l, r, cfg), left, right)
    check(res.disp_final.shape == (h, w), "FULL: wrong output shape")
    _check_range("FULL", res.disp_final, d)
    bad2 = _bad2(res.disp_final, gt)
    check(bound is None or bad2 <= bound, f"FULL: bad-2.0 {bad2} > {bound}")
    yield {"phase": "ad_census_full", "shape": [h, w, d], **stats,
           "bad2": bad2, "bad2_bound": bound}


def phase_cli(shape=TEDDY, bound=FULL_BAD2):
    """``ad_census`` FULL through the CLI's ``run`` path."""
    from stereo_match_traditional_tpu import cli

    h, w, d = shape
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "ad_census", "--synthetic", f"{h}x{w}",
                       "--disp-range", str(d), "--seed", "0",
                       "--set", "scanline=default", "--set", "run_post=true"])
    check(rc == 0, f"CLI run exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(summary["shape"] == [h, w], f"CLI: shape {summary['shape']}")
    check(summary["finite_fraction"] == 1.0, "CLI: non-finite disparities")
    check(summary["bad_2.0"] <= bound, f"CLI: bad-2.0 {summary['bad_2.0']} > {bound}")
    yield {"phase": "cli_run/ad_census_full", "shape": [h, w, d],
           "summary": summary, "bad2_bound": bound}


def phase_batched(shape=TEDDY, batch=4, bound=FULL_BAD2):
    """``ad_census`` through ``models.batch.batched_pipeline`` against the
    direct pipeline pair by pair."""
    import jax.numpy as jnp

    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.models.batch import batched_pipeline

    h, w, d = shape
    pairs = [_pair(h, w, d, seed=s) for s in range(batch)]
    ls = jnp.stack([p[0] for p in pairs])
    rs = jnp.stack([p[1] for p in pairs])
    cfg = cfgs.ADCensusConfig(disp_range=d)
    res, stats = measure(batched_pipeline("ad_census", cfg), ls, rs)
    fn, _ = get_pipeline("ad_census")
    direct = measure(lambda l, r: fn(l, r, cfg), pairs[0][0], pairs[0][1])[0]
    mism = _mismatch(res.disp_left[0], direct.disp_left, ignore_cols=d)
    check(mism <= TIE_FLIP, f"batched vs direct: mismatch {mism}")
    bad2 = [_bad2(res.disp_left[k], pairs[k][2]) for k in range(batch)]
    check(max(bad2) <= bound, f"batched: bad-2.0 {bad2} > {bound}")
    yield {"phase": "batched/ad_census", "shape": [batch, h, w, d], **stats,
           "bad2": bad2, "bad2_bound": bound, "mismatch_vs_direct": mism}


def phase_canonical(shape=TEDDY, bound=FULL_BAD2):
    """Canonical ``cross_two_pass`` aggregation through ``get_pipeline``."""
    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models import get_pipeline

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    cfg = cfgs.ADCensusConfig(disp_range=d, aggregation="cross_two_pass")
    fn, _ = get_pipeline("ad_census")
    res, stats = measure(lambda l, r: fn(l, r, cfg), left, right)
    _check_range("canonical", res.disp_left, d)
    bad2 = _bad2(res.disp_left, gt)
    check(bad2 <= bound, f"canonical: bad-2.0 {bad2} > {bound}")
    yield {"phase": "canonical/cross_two_pass", "shape": [h, w, d], **stats,
           "bad2": bad2, "bad2_bound": bound}


def phase_streamed(shape=UHD, row_tile=None, bound=None):
    """Legacy FULL through ``parallel.streamed_pipeline``; the band is the
    one ``auto_row_tile`` picks from the card's memory (what
    ``row_tile=None`` runs) unless ``row_tile`` is given.  ``bound=None``
    asserts no bad-2.0 bound (weak ground truth at D=256)."""
    from stereo_match_traditional_tpu.parallel.streamed import (
        auto_row_tile,
        streamed_pipeline,
    )

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    cfg = _full_cfg(d)
    t = row_tile or auto_row_tile("ad_census", cfg, h, w)
    res, stats = measure(streamed_pipeline("ad_census", cfg, row_tile), left, right)
    check(res.disp_final.shape == (h, w), "streamed: wrong output shape")
    _check_range("streamed", res.disp_final, d)
    bad2 = _bad2(res.disp_final, gt)
    check(bound is None or bad2 <= bound, f"streamed: bad-2.0 {bad2} > {bound}")
    yield {"phase": "streamed/ad_census_full", "shape": [h, w, d],
           "row_tile": t, **stats, "bad2": bad2, "bad2_bound": bound}


def phase_asw_kernel(shape=TEDDY, win_size=11, time_shapes=(TEDDY, SERVING),
                     interpret=False):
    """The ASW kernel against the plain jnp scan (both views, both
    computed on the device), then the full ``asw`` pipeline timed with
    the kernel and with the scan left to XLA."""
    import jax

    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.ops import volume
    from stereo_match_traditional_tpu.ops.kernels import asw_volume_pallas

    h, w, d = shape
    left, right, _ = _pair(h, w, d)
    for view in ("left", "right"):
        got, stats = measure(
            lambda l, r, view=view: asw_volume_pallas(
                l, r, d, win_size, view=view, interpret=interpret),
            left, right)
        want = jax.jit(lambda l, r, view=view: volume.asw_volume(
            l, r, d, win_size, view=view))(left, right)
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=1e-4, atol=1e-3),
              f"ASW kernel ({view}) differs from asw_volume by {err}")
        yield {"phase": f"asw_kernel/{view}", "shape": [h, w, d],
               "window": 2 * win_size + 3, **stats, "max_abs_err": err}
    fn, _ = get_pipeline("asw")
    for th, tw, td in time_shapes:
        l2, r2, gt = _pair(th, tw, td)
        rec = {"phase": "asw_pipeline/kernel_vs_xla", "shape": [th, tw, td]}
        for use_pallas in (True, False):
            cfg = cfgs.ASWConfig(disp_range=td, use_pallas=use_pallas)
            res, stats = measure(lambda l, r, cfg=cfg: fn(l, r, cfg), l2, r2)
            rec["kernel" if use_pallas else "xla"] = {
                **stats, "bad2": _bad2(res.disp_left, gt)}
        yield rec


def phase_asw_grid(shape=TEDDY, bound=FULL_BAD2):
    """The opt-in bilateral-grid ASW (banded Gaussian matrix products at
    ``Precision.HIGHEST``) through ``get_pipeline``."""
    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models import get_pipeline

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    cfg = cfgs.ASWConfig(disp_range=d, approx="grid")
    fn, _ = get_pipeline("asw")
    res, stats = measure(lambda l, r: fn(l, r, cfg), left, right)
    _check_range("asw grid", res.disp_left, d)
    bad2 = _bad2(res.disp_left, gt)
    check(bad2 <= bound, f"asw grid: bad-2.0 {bad2} > {bound}")
    yield {"phase": "asw_grid", "shape": [h, w, d], **stats, "bad2": bad2,
           "bad2_bound": bound}


def phase_matmul_exactness(shape=TEDDY):
    """The float32 matrix products ask for ``Precision.HIGHEST``; on the
    card that must be exact float32, not TF32.  Integer operands whose
    sums stay below 2**24 make the exact result exact in float32."""
    import jax
    import jax.numpy as jnp

    from stereo_match_traditional_tpu.ops import aggregate
    from stereo_match_traditional_tpu.ops.volume import box_sum_same

    h, w, d = shape
    left, _, _ = _pair(h, w, d)
    sq = (np.asarray(left).astype(np.float32) - 128.0) ** 2     # <= 16384
    got, stats = measure(lambda x: box_sum_same(x, 5, 5), jnp.asarray(sq))
    pad = np.pad(sq.astype(np.float64), 5)
    want = np.zeros(sq.shape, np.float64)
    for dy in range(11):
        for dx in range(11):
            want += pad[dy:dy + h, dx:dx + w]
    err = float(np.abs(np.asarray(got) - want).max())
    check(err <= 0.25, f"box_sum_same: max error {err} > 0.25")
    yield {"phase": "matmul/box_sum_same", "shape": [h, w], **stats,
           "max_abs_err": err}
    vol = np.stack([np.roll(sq, k, axis=1) for k in range(d)])  # [D, H, W]
    for axis in (-1, -2):
        got, stats = measure(
            jax.jit(lambda x, axis=axis: aggregate._mxu_cumsum(x, axis)),
            jnp.asarray(vol))
        want = np.cumsum(vol.astype(np.float64), axis=axis)
        err = float(np.abs(np.asarray(got) - want).max())
        check(err <= 0.5, f"_mxu_cumsum(axis={axis}): max error {err}")
        yield {"phase": f"matmul/mxu_cumsum_axis{axis}", "shape": [d, h, w],
               **stats, "max_abs_err": err}


def one_card_phases():
    yield from phase_reference_paths()
    yield from phase_full()
    yield from phase_cli()
    yield from phase_batched()
    yield from phase_full(SERVING, bound=None)
    yield from phase_canonical()
    yield from phase_streamed()
    yield from phase_asw_kernel()
    yield from phase_asw_grid()
    yield from phase_matmul_exactness()


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _tiled_setup(shape, reference, n):
    """Inputs and jitted programs of :func:`phase_tiled`."""
    import jax

    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.parallel import make_mesh, tiled_pipeline
    from stereo_match_traditional_tpu.parallel.streamed import streamed_pipeline

    h, w, d = shape
    left, right, gt = _pair(h, w, d)
    cfg = _full_cfg(d)
    one = jax.devices()[0]
    ref_args = (jax.device_put(left, one), jax.device_put(right, one))
    row_tile = None
    if reference == "direct":
        fn, _ = get_pipeline("ad_census")
        ref = jax.jit(lambda l, r: fn(l, r, cfg))
    else:
        # bands of the tile height: band and tile boundaries coincide
        row_tile = -(-h // n)
        ref = jax.jit(streamed_pipeline("ad_census", cfg, row_tile))
    tiled = jax.jit(tiled_pipeline("ad_census", cfg, make_mesh(n, ("tile",)),
                                   shard_post=True))
    return types.SimpleNamespace(
        shape=shape, reference=reference, gt=gt, row_tile=row_tile,
        jobs={"tiled": (tiled, (left, right)), reference: (ref, ref_args)})


def phase_tiled(shape, reference, n=4, setup=None):
    """FULL ``tiled_pipeline(shard_post=True)`` over an ``n``-device mesh
    against the one-card run: ``reference='direct'`` (the pipeline) or
    ``'streamed'`` (``streamed_pipeline`` in bands of the tile height, for
    shapes one card cannot hold as a whole volume)."""
    s = setup or _tiled_setup(shape, reference, n)
    h, w, d = s.shape
    got, stats = measure(*_flat(s.jobs["tiled"]))
    want, ref_stats = measure(*_flat(s.jobs[reference]))
    if s.row_tile:
        ref_stats["row_tile"] = s.row_tile
    mism = {
        "disp_left": _mismatch(got.disp_left, want.disp_left, d),
        "disp_right": _mismatch(got.disp_right, want.disp_right, d, "right"),
    }
    for field, frac in mism.items():
        check(frac <= TIE_FLIP, f"tiled {field}: mismatch {frac} vs {reference}")
    wf, gf = np.asarray(want.disp_final), np.asarray(got.disp_final)
    both = np.isfinite(wf) & np.isfinite(gf)
    fin = {"finite_mismatch": float(np.mean(np.isfinite(wf) != np.isfinite(gf))),
           "value_mismatch": float(np.mean(np.abs(wf[both] - gf[both]) > 1e-3))}
    check(max(fin.values()) <= 1e-2, f"tiled disp_final: {fin} vs {reference}")
    yield {"phase": f"tiled{n}/ad_census_full_vs_{reference}", "shape": [h, w, d],
           "tiled": stats, reference: ref_stats, "mismatch": mism,
           "disp_final": fin, "bad2": _bad2(got.disp_final, s.gt)}


def _batch_setup(shape, batch, n):
    """Inputs and jitted programs of :func:`phase_batch_dp`."""
    import jax
    import jax.numpy as jnp

    from stereo_match_traditional_tpu import config as cfgs
    from stereo_match_traditional_tpu.models.batch import batched_pipeline
    from stereo_match_traditional_tpu.parallel import make_mesh

    h, w, d = shape
    pairs = [_pair(h, w, d, seed=s) for s in range(batch)]
    ls = jnp.stack([p[0] for p in pairs])
    rs = jnp.stack([p[1] for p in pairs])
    cfg = cfgs.ADCensusConfig(disp_range=d)
    one = jax.devices()[0]
    sharded = jax.jit(batched_pipeline("ad_census", cfg, mesh=make_mesh(n, ("batch",))))
    return types.SimpleNamespace(shape=shape, batch=batch, jobs={
        "sharded": (sharded, (ls, rs)),
        "one_card": (jax.jit(batched_pipeline("ad_census", cfg)),
                     (jax.device_put(ls, one), jax.device_put(rs, one)))})


def phase_batch_dp(shape=TEDDY, batch=8, n=4, setup=None):
    """``batched_pipeline`` with the batch axis sharded over ``n`` devices
    against the same batch on one device."""
    s = setup or _batch_setup(shape, batch, n)
    h, w, d = s.shape
    got, stats = measure(*_flat(s.jobs["sharded"]))
    want, ref_stats = measure(*_flat(s.jobs["one_card"]))
    mism = max(_mismatch(got.disp_left[k], want.disp_left[k], d)
               for k in range(s.batch))
    check(mism <= TIE_FLIP, f"batch-DP vs one card: mismatch {mism}")
    yield {"phase": f"batch_dp{n}/ad_census", "shape": [s.batch, h, w, d],
           "sharded": stats, "one_card": ref_stats, "mismatch": mism}


def phase_dryrun(n=4, steps=None):
    """``__graft_entry__.dryrun_multichip``: the 2-D ('tile', 'disp') mesh,
    GSPMD and the all_to_all scanline reshard, on small shapes; ``steps``
    from ``multichip_steps`` when they were compiled beforehand."""
    import __graft_entry__

    t0 = time.perf_counter()
    if steps is None:
        __graft_entry__.dryrun_multichip(n)
    else:
        __graft_entry__.run_multichip_steps(steps)
    yield {"phase": f"dryrun_multichip{n}", "wall_s": time.perf_counter() - t0}


def _flat(job):
    fn, args = job
    return (fn, *args)


def four_card_phases(n=4, serving=SERVING, uhd=UHD, teddy=TEDDY):
    """Every multi-card program is built and compiled at once first (the
    compiles run concurrently); each phase then reuses its programs, so
    its own ``compile_s`` is near 0 and the ``compile`` record holds each
    program's compile seconds."""
    import __graft_entry__

    from stereo_match_traditional_tpu.utils.compile_cache import (
        compile_concurrently,
    )

    steps = __graft_entry__.multichip_steps(n)
    tiled = [_tiled_setup(serving, "direct", n), _tiled_setup(uhd, "streamed", n)]
    batch = _batch_setup(teddy, 8, n)
    jobs = [(f"dryrun/{tag}", (fn, args)) for tag, fn, args, _ in steps]
    for s in tiled:
        jobs += [(f"tiled{list(s.shape)}/{k}", j) for k, j in s.jobs.items()]
    jobs += [(f"batch_dp/{k}", j) for k, j in batch.jobs.items()]
    t0 = time.perf_counter()
    secs = compile_concurrently([j for _, j in jobs])
    yield {"phase": f"compile{n}", "wall_s": time.perf_counter() - t0,
           "compile_s": {tag: round(t, 3) for (tag, _), t in zip(jobs, secs)}}
    yield from phase_dryrun(n, steps)
    yield from phase_tiled(serving, "direct", n, tiled[0])
    yield from phase_batch_dp(teddy, 8, n, batch)
    yield from phase_tiled(uhd, "streamed", n, tiled[1])


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)
    try:
        from stereo_match_traditional_tpu.utils.compile_cache import (
            configure_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: the stereo engine is not importable here: {e}",
              file=sys.stderr)
        return 2
    configure_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    t_start = time.perf_counter()
    phases = four_card_phases() if args.four_cards else one_card_phases()
    for record in phases:
        record["elapsed_s"] = round(time.perf_counter() - t_start, 1)
        print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": want,
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
