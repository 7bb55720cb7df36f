"""Benchmark harness: flagship AD-Census throughput on the GPU.

Prints one JSON line per pipeline:
    {"metric": ..., "value": N, "unit": "MPixDisp/s", "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N}

It refuses to run (exit code 2) unless JAX's device is a GPU, or
``--cpu`` asks for the CPU backend; every line names the device it ran on.

By default (``--pipeline all``) every reference driver's active-path
workload is measured — sad, ncc (its committed D=200), asw, cblsm, then
the flagship ad_census LAST (`AD-CensusV1/main.cpp:58-84`: Teddy-shaped
450x375 pair, dispRange 60, fused AD+Census9x7 cost L+R, cross-arm
rectangle-mean aggregation, dual WTA) — one JSON line each, so the
round-over-round artifact tracks the whole zoo, and a last-line parser
still lands on the flagship metric.  ``--pipeline NAME`` selects one.

``vs_baseline`` is the ratio to an independent C++ re-implementation of
the same pipeline with the reference's per-pixel loop structure
(`native/cpu_baseline/timing_baseline.cpp`; threading follows each
reference project's OpenMP enablement) — the reference itself publishes
no numbers.  Every pipeline has a non-null denominator; the recorded
constants keep the ratio comparable run over run, with an opt-in live
drift check.

Usage: python bench.py [--pipeline ad_census] [--iters 12] [--cpu]
                       [--measure-baseline]
"""

import argparse
import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

# Recorded CPU-reference baselines, MPixDisp/s per pipeline at the
# reference workload shape (375x450, D=60 / D=200 for ncc), measured on
# this container with `native/cpu_baseline/timing_baseline.cpp`
# (g++ -O2 -fopenmp, best-of-`iters` as logged).  `threads` follows each
# reference project's OpenMP enablement (.vcxproj, SURVEY.md §5):
# SAD/ASW/CBLSM parallel (4 cores here), NCC/AD-CensusV1 single-threaded.
# The recorded constant is the official `vs_baseline` denominator —
# round-over-round comparable; a cheap live run only sanity-checks drift
# (>20% warns on stderr).  `--measure-baseline` re-measures and uses live.
_BASELINE_SHAPE = {"ncc": (375, 450, 200)}
_DEFAULT_SHAPE = (375, 450, 60)
_RECORDED_CPU_BASELINES = {
    # pipeline: (mpixdisp, threads, iters, ~seconds/run)
    "sad": (23.041, 4, 3, 0.5),
    "ncc": (0.777, 1, 1, 43.5),
    "asw": (0.920, 4, 1, 11.0),
    "ad_census": (5.010, 1, 3, 2.1),
    "cblsm": (18.638, 4, 3, 0.6),
}
# Live drift check only when one run costs under this many seconds.
_LIVE_CHECK_BUDGET_S = 10.0


def _run_baseline_binary(pipeline, rows, cols, disp, iters, threads, timeout):
    exe = os.path.join(_REPO, "native", "cpu_baseline", "timing_baseline")
    src = exe + ".cpp"
    if not os.path.exists(exe) and os.path.exists(src):
        subprocess.run(
            ["g++", "-O2", "-fopenmp", "-o", exe, src],
            check=True, capture_output=True, timeout=120,
        )
    out = subprocess.run(
        [exe, pipeline, str(rows), str(cols), str(disp), str(iters), str(threads)],
        check=True, capture_output=True, text=True, timeout=timeout,
    ).stdout
    return float(json.loads(out.strip().splitlines()[-1])["value"])


def _cpu_baseline(pipeline: str, rows: int, cols: int, disp: int,
                  measure: bool = False, check_drift: bool = False):
    """(mpixdisp, source) CPU-reference baseline for this workload, or
    (None, None).

    Recorded constants stand for the reference workload shape only; any
    other shape must be measured live (per-pixel census/arm/window costs
    are not shape-invariant).  ``measure=True`` forces a live measurement
    (minutes for ncc/asw) and uses it as the denominator.
    """
    rec = _RECORDED_CPU_BASELINES.get(pipeline)
    shape = _BASELINE_SHAPE.get(pipeline, _DEFAULT_SHAPE)
    if rec is None:
        return None, None
    mpix, threads, iters, sec = rec
    at_ref_shape = (rows, cols, disp) == shape
    if measure or mpix is None or not at_ref_shape:
        # full live measurement (also the path for non-default shapes)
        try:
            live = _run_baseline_binary(
                pipeline, rows, cols, disp, iters, threads, timeout=3600
            )
            return live, "measured"
        except Exception:
            return (mpix, "recorded") if (mpix and at_ref_shape) else (None, None)
    # recorded constant (+ the opt-in live drift check: re-running the CPU
    # baseline on the measuring container adds fixed wall-clock and false
    # >20% warnings under CPU contention, so it no longer runs by default)
    if check_drift and sec is not None and sec * iters <= _LIVE_CHECK_BUDGET_S:
        try:
            live = _run_baseline_binary(
                pipeline, rows, cols, disp, iters, threads, timeout=120
            )
            if abs(live - mpix) > 0.2 * mpix:
                print(
                    f"bench.py: live CPU baseline for {pipeline} drifted "
                    f"{live:.2f} vs recorded {mpix:.2f} MPixDisp/s (>20%); "
                    "container CPU contention? re-record with "
                    "--measure-baseline if persistent",
                    file=sys.stderr,
                )
        except Exception:
            pass
    return mpix, "recorded"


# Default measurement order: the four companions first, the flagship last
# (a consumer that parses only the final JSON line keeps getting the
# round-over-round ad_census metric).
_ALL_PIPELINES = ("sad", "ncc", "asw", "cblsm", "ad_census")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="all")
    ap.add_argument(
        "--iters", type=int, default=12,
        help="on-device loop count for the high-N timing program "
        "(utils.benchmark.device_time n_hi; raise for steadier numbers)",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU backend (applied through jax.config); without "
        "it the harness needs a GPU",
    )
    ap.add_argument("--rows", type=int, default=375)
    ap.add_argument("--cols", type=int, default=450)
    ap.add_argument(
        "--disp", type=int, default=None,
        help="disparity range; default = the pipeline's reference workload "
        "(200 for ncc per NCC_main.cpp:18, else 60)",
    )
    ap.add_argument(
        "--measure-baseline", action="store_true",
        help="re-measure the CPU reference baseline live and use it as the "
        "vs_baseline denominator (minutes for ncc/asw); default uses the "
        "recorded constant",
    )
    ap.add_argument(
        "--check-drift", action="store_true",
        help="also re-run the cheap CPU baselines live and warn if they "
        "drift >20%% from the recorded constants (opt-in: the live run "
        "costs seconds and false-positives under container CPU contention)",
    )
    ap.add_argument(
        "--multichip", action="store_true",
        help="also measure the tile-DP sharded path over every available "
        "device and report scaling efficiency vs 1 device",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from stereo_match_traditional_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        print(f"bench.py: needs a GPU (JAX found {dev.platform!r}); pass "
              "--cpu to measure the CPU backend", file=sys.stderr)
        raise SystemExit(2)
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    import jax.numpy as jnp

    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    from stereo_match_traditional_tpu.config import disp_override_kw

    from stereo_match_traditional_tpu.utils.benchmark import device_time

    def checksum(res):
        # Sum EVERY produced output map: returning only disp_left lets XLA
        # dead-code-eliminate the right-view half (and any active post
        # chain) inside the timing loop, silently inflating the number.
        # Config defaults mirror each reference driver's active path, so
        # the non-None StereoResult fields are exactly that workload.
        total = jnp.float32(0.0)
        for f in res:
            if f is not None:
                total = total + jnp.sum(f.astype(jnp.float32))
        return total

    def measure_one(name: str, disp):
        if disp is None:
            disp = _BASELINE_SHAPE.get(name, _DEFAULT_SHAPE)[2]
        pipeline, cfg_cls = get_pipeline(name)
        cfg = cfg_cls(**disp_override_kw(cfg_cls, disp))

        left, right, _ = make_pair(args.rows, args.cols, disp, seed=0)
        left = jnp.asarray(left)
        right = jnp.asarray(right)

        sec = device_time(
            lambda l, r: checksum(pipeline(l, r, cfg)), (left, right),
            n_hi=max(args.iters, 3),
        )
        mpixdisp = args.rows * args.cols * disp / sec / 1e6
        baseline, source = _cpu_baseline(
            name, args.rows, args.cols, disp,
            measure=args.measure_baseline, check_drift=args.check_drift,
        )
        result = {
            "metric": f"{name}_throughput",
            "value": round(mpixdisp, 2),
            "unit": "MPixDisp/s",
            "vs_baseline": round(mpixdisp / baseline, 2) if baseline else None,
            **device,
        }
        if baseline:
            result["baseline_mpixdisp"] = baseline
            result["baseline_source"] = source
            result["baseline_threads"] = _RECORDED_CPU_BASELINES[name][1]

        if args.multichip and len(jax.devices()) > 1:
            from stereo_match_traditional_tpu.parallel import make_mesh, tiled_pipeline

            n = len(jax.devices())
            mesh = make_mesh(n, ("tile",))
            sharded = jax.jit(tiled_pipeline(name, cfg, mesh))
            sec_n = device_time(
                lambda l, r: checksum(sharded(l, r)), (left, right),
                n_hi=max(args.iters, 3),
            )
            result["devices"] = n
            result["sharded_value"] = round(
                args.rows * args.cols * disp / sec_n / 1e6, 2
            )
            result["scaling_efficiency"] = round(sec / (sec_n * n), 3)
        return result

    names = _ALL_PIPELINES if args.pipeline == "all" else (args.pipeline,)
    for name in names:
        print(json.dumps(measure_one(name, args.disp)), flush=True)


if __name__ == "__main__":
    main()
