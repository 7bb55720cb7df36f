"""Unified command-line entry point (SURVEY.md §5 "Config / flag system").

The reference has five hard-coded `main()`s with magic constants
(`SAD/SADmain.cpp:24-99` et al.); this is the single `stereo` driver:

    python -m stereo_match_traditional_tpu.cli run ad_census \
        --left im2.png --right im6.png --out disp.png --disp-range 60
    python -m stereo_match_traditional_tpu.cli run asw --synthetic 375x450 \
        --save-stages /tmp/stages
    python -m stereo_match_traditional_tpu.cli bench --pipeline sad
    python -m stereo_match_traditional_tpu.cli info

Any config dataclass field can be overridden with ``--set field=value``
(repeatable; ``--set scanline=default`` enables a nested stage with its
default settings); defaults are the reference driver constants (config.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import typing


def _coerce(key: str, val: str, typ):
    """Coerce a ``--set`` string to the field's *resolved* type.  Optional
    is unwrapped; bool is dispatched before int (bool is an int subclass,
    and ``--set run_post=1`` must become True, not the int 1)."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T] and friends
        members = [t for t in typing.get_args(typ) if t is not type(None)]
        if val.lower() in ("none", "null"):
            return None
        typ = members[0] if members else str
    if typ is bool:
        if val.lower() in ("true", "1", "yes", "on"):
            return True
        if val.lower() in ("false", "0", "no", "off"):
            return False
        raise SystemExit(f"--set {key}: expected a bool, got {val!r}")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    if typ is str:
        return val
    if dataclasses.is_dataclass(typ) and val.lower() == "default":
        return typ()  # e.g. --set scanline=default turns the stage on
    # nested config dataclasses etc. — passing the raw string through
    # would surface later as an opaque AttributeError inside jit tracing
    raise SystemExit(
        f"--set {key}: field type {getattr(typ, '__name__', typ)!r} cannot "
        "be parsed from the command line (only str/int/float/bool, 'none' "
        "for Optional fields and 'default' for nested configs); construct "
        "other nested configs in Python"
    )


def _parse_set(cfg_cls, overrides):
    hints = typing.get_type_hints(cfg_cls)
    fields = {f.name: f for f in dataclasses.fields(cfg_cls)}
    kw = {}
    for item in overrides or []:
        if "=" not in item:
            raise SystemExit(f"--set expects field=value, got {item!r}")
        key, val = item.split("=", 1)
        if key not in fields:
            raise SystemExit(
                f"unknown config field {key!r} for {cfg_cls.__name__}; "
                f"have {sorted(fields)}"
            )
        kw[key] = _coerce(key, val, hints.get(key, str))
    return kw


def _load_pair(args):
    import numpy as np

    from stereo_match_traditional_tpu.utils import io as io_utils
    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    if args.synthetic:
        if getattr(args, "gt", None):
            raise SystemExit("--gt is for file pairs; --synthetic has its own GT")
        h, w = (int(x) for x in args.synthetic.split("x"))
        left, right, gt = make_pair(h, w, args.disp_range or 60, seed=args.seed)
        return left, right, gt
    if not (args.left and args.right):
        raise SystemExit("provide --left/--right image paths or --synthetic HxW")
    left = io_utils.rgb_to_gray_u8(io_utils.imread(args.left))
    right = io_utils.rgb_to_gray_u8(io_utils.imread(args.right))
    gt = None
    if getattr(args, "gt", None):
        gt = io_utils.read_gt_disparity(args.gt, scale=args.gt_scale)
        if gt.shape != left.shape:
            raise SystemExit(
                f"--gt shape {gt.shape} does not match the pair {left.shape}"
            )
    return left, right, gt


def _build_cfg(args):
    """(pipeline_fn, cfg) from the shared pipeline/--set/--disp-range args."""
    from stereo_match_traditional_tpu.config import disp_override_kw
    from stereo_match_traditional_tpu.models import get_pipeline

    pipeline, cfg_cls = get_pipeline(args.pipeline)
    kw = _parse_set(cfg_cls, args.set)
    for field, val in disp_override_kw(cfg_cls, args.disp_range).items():
        kw.setdefault(field, val)  # an explicit --set wins
    return pipeline, cfg_cls(**kw)


def _metric_map(pipeline_name, res, disp):
    """The map to score against ground truth, plus a note (or None).

    ASW's faithful final map is the reference's *display* scale
    (cv::normalize to 0-255 before speckles, `ASWeight.cpp:69`), not
    disparity units — accuracy is measured on the raw WTA map.
    """
    import numpy as np

    if pipeline_name == "asw" and res.disp_final is not None:
        return np.asarray(res.disp_left), "disp_left (disp_final is display-scaled)"
    return disp, None


def _bad_rate(metric_map, gt, thresh: float = 2.0):
    """bad-``thresh`` rate over the known-GT pixels (file GT marks unknown
    pixels NaN), or None when no pixel is known — an all-unknown map must
    read as no-data, not a perfect 0.0."""
    import numpy as np

    from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate

    finite = np.isfinite(gt)
    if not finite.any():
        return None
    valid = None if finite.all() else finite
    return round(bad_pixel_rate(metric_map, gt, thresh=thresh, valid=valid), 4)


def cmd_run(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereo_match_traditional_tpu.utils import io as io_utils
    from stereo_match_traditional_tpu.utils.profiling import StageTimer

    pipeline, cfg = _build_cfg(args)

    left, right, gt = _load_pair(args)

    executor = getattr(args, "executor", "direct")
    if args.save_stages and executor != "direct":
        raise SystemExit("--save-stages requires --executor direct")

    from stereo_match_traditional_tpu.utils.profiling import profile

    # The ASW Lab variant consumes the COLOR pair in OpenCV's 8-bit Lab
    # encoding (`ASW/ASWeight.cpp:33-34` cvtColor(CV_BGR2Lab)); build the
    # Lab images from the same inputs and hand them to each executor's
    # aux-input path.
    aux = ()
    pkw = {}
    if args.pipeline == "asw" and getattr(cfg, "variant", "") == "lab":
        if args.synthetic:
            from stereo_match_traditional_tpu.utils.synthetic import make_pair

            h, w = (int(x) for x in args.synthetic.split("x"))
            lc, rc, _ = make_pair(
                h, w, args.disp_range or 60, seed=args.seed, color=True
            )
        else:
            lc = io_utils.imread(args.left)
            rc = io_utils.imread(args.right)
            if lc.ndim != 3 or rc.ndim != 3:
                raise SystemExit(
                    "variant=lab needs COLOR input images (the Lab weights "
                    "come from cvtColor(CV_BGR2Lab), ASWeight.cpp:33-34)"
                )
        aux = (io_utils.rgb_to_lab_u8(lc), io_utils.rgb_to_lab_u8(rc))
        pkw = {
            "left_lab": jnp.asarray(aux[0]),
            "right_lab": jnp.asarray(aux[1]),
        }

    timer = StageTimer()
    stages = None
    with profile(args.trace), timer.stage("pipeline"):
        if executor == "direct":
            # one compiled program, not op-by-op dispatch
            if args.save_stages:
                res, stages = jax.jit(
                    lambda l, r, **kw: pipeline(l, r, cfg, return_stages=True, **kw)
                )(jnp.asarray(left), jnp.asarray(right), **pkw)
            else:
                res = jax.jit(lambda l, r, **kw: pipeline(l, r, cfg, **kw))(
                    jnp.asarray(left), jnp.asarray(right), **pkw
                )
        elif executor == "streamed":
            from stereo_match_traditional_tpu.parallel import run_streamed

            res = run_streamed(
                args.pipeline, left, right, cfg, row_tile=args.row_tile, aux=aux
            )
        elif executor == "tiled":
            from stereo_match_traditional_tpu.parallel import run_tiled

            res = run_tiled(args.pipeline, left, right, cfg, aux=aux)
        elif executor == "gspmd":
            from stereo_match_traditional_tpu.parallel.gspmd import gspmd_pipeline
            from stereo_match_traditional_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(axis_names=("tile",))
            aux_names = ("left_lab", "right_lab") if aux else ()
            res = gspmd_pipeline(args.pipeline, cfg, mesh, aux_names=aux_names)(
                jnp.asarray(left), jnp.asarray(right),
                *(jnp.asarray(a) for a in aux)
            )
        else:
            raise SystemExit(f"unknown executor {executor!r}")
        disp = np.asarray(
            res.disp_final if res.disp_final is not None else res.disp_left
        )

    if args.save_stages:
        from stereo_match_traditional_tpu.utils.checkpoint import (
            save_array,
            save_result,
        )

        save_result(args.save_stages, res, meta={"pipeline": args.pipeline})
        for stage_name, arr in (stages or {}).items():
            save_array(args.save_stages, stage_name, arr)
        print(
            f"stages -> {args.save_stages} "
            f"(incl. {sorted(stages)} volumes; re-enter with "
            "models.registry.finish_from_volumes)",
            file=sys.stderr,
        )

    if args.out:
        io_utils.imwrite(args.out, io_utils.normalize_u8(disp))
        print(f"disparity -> {args.out}", file=sys.stderr)
    if args.out_pfm:
        # Raw float disparities (Middlebury submission format), unlike the
        # display-normalized --out PNG.
        io_utils.write_pfm(args.out_pfm, np.asarray(disp, dtype=np.float32))
        print(f"raw disparity -> {args.out_pfm}", file=sys.stderr)

    finite = np.isfinite(disp)
    summary = {
        "pipeline": args.pipeline,
        "shape": list(disp.shape),
        "finite_fraction": float(finite.mean()),
        # null (not NaN — bare NaN is invalid JSON) when nothing is finite
        "disp_min": float(disp[finite].min()) if finite.any() else None,
        "disp_max": float(disp[finite].max()) if finite.any() else None,
    }
    if gt is not None:
        metric_map, note = _metric_map(args.pipeline, res, disp)
        if note:
            summary["bad_2.0_map"] = note
        summary["bad_2.0"] = _bad_rate(metric_map, gt)
    summary.update(json.loads(timer.report()))
    print(json.dumps(summary))
    return 0


def cmd_eval(args) -> int:
    """Evaluate one pipeline over a dataset directory.

    Layout and defaults follow the Middlebury 2003 convention the
    reference hard-codes (`im2.png`/`im6.png` in every main, e.g.
    `SAD/SADmain.cpp:27-28`; ground truth `disp2.png` stores disparity*4
    with 0 = unknown).  ``--data`` may point at one scene directory or at
    a directory of scene directories (`teddy/`, `cones/`, ...).
    """
    import jax.numpy as jnp
    import numpy as np

    from stereo_match_traditional_tpu.utils import io as io_utils

    pipeline, cfg = _build_cfg(args)

    root = args.data
    if not os.path.isdir(root):
        raise SystemExit(f"--data {root!r} is not a directory")
    if os.path.exists(os.path.join(root, args.left_name)):
        scenes = [(os.path.basename(os.path.normpath(root)), root)]
    else:
        scenes = [
            (entry, os.path.join(root, entry))
            for entry in sorted(os.listdir(root))
            if os.path.exists(os.path.join(root, entry, args.left_name))
        ]
    if not scenes:
        raise SystemExit(f"no scene under {root!r} contains {args.left_name!r}")

    rows, rates = [], []
    for name, d in scenes:
        left = io_utils.rgb_to_gray_u8(io_utils.imread(os.path.join(d, args.left_name)))
        right = io_utils.rgb_to_gray_u8(
            io_utils.imread(os.path.join(d, args.right_name))
        )
        res = pipeline(jnp.asarray(left), jnp.asarray(right), cfg)
        disp = np.asarray(
            res.disp_final if res.disp_final is not None else res.disp_left
        )
        metric_map, _ = _metric_map(args.pipeline, res, disp)
        row = {"scene": name, "shape": list(disp.shape)}
        gt_path = os.path.join(d, args.gt_name)
        if os.path.exists(gt_path):
            gt = io_utils.read_gt_disparity(gt_path, scale=args.gt_scale)
            if gt.shape != metric_map.shape:
                raise SystemExit(
                    f"{name}: GT shape {gt.shape} != pair {metric_map.shape}"
                )
            # key matches cmd_run's "bad_2.0" for the default threshold
            rate = _bad_rate(metric_map, gt, args.thresh)
            row[f"bad_{args.thresh:.1f}"] = rate
            if rate is not None:  # all-unknown GT: reported null, not averaged
                rates.append(rate)
        rows.append(row)

    out = {"pipeline": args.pipeline, "scenes": rows}
    if rates:
        out[f"mean_bad_{args.thresh:.1f}"] = round(float(np.mean(rates)), 4)
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    import os
    import subprocess

    import stereo_match_traditional_tpu as pkg

    # bench.py lives at the repo root (next to the package dir), not inside
    # the installed package — resolve it there so `stereo bench` works from
    # any CWD.
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    bench = os.path.join(repo_root, "bench.py")
    if not os.path.exists(bench):
        raise SystemExit(f"bench harness not found at {bench}")
    cmd = [sys.executable, bench, "--pipeline", args.pipeline]
    if args.cpu:
        cmd.append("--cpu")
    return subprocess.call(cmd)


def cmd_info(args) -> int:
    import jax

    from stereo_match_traditional_tpu import __version__
    from stereo_match_traditional_tpu.models import PIPELINES

    info = {
        "version": __version__,
        "pipelines": sorted(PIPELINES),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "devices": [str(d) for d in jax.devices()],
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo", description=__doc__)
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (applied through jax.config before any "
        "device is used)",
    )
    ap.add_argument(
        "--no-compile-cache", action="store_true",
        help="skip the persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR "
        "or .jax_cache/ in the checkout; it has no automatic eviction — "
        "delete the directory to reclaim space)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run a stereo pipeline on an image pair")
    run.add_argument("pipeline")
    run.add_argument("--left")
    run.add_argument("--right")
    run.add_argument("--out")
    run.add_argument(
        "--out-pfm", metavar="PATH",
        help="also write the raw float disparity map as Middlebury PFM",
    )
    run.add_argument(
        "--gt", metavar="PATH",
        help="ground-truth disparity (PFM, or integer PNG/PGM) for bad-2.0",
    )
    run.add_argument(
        "--gt-scale", type=float, default=None,
        help="divide ground-truth values by this; default is the format's "
        "convention (1 for PFM, 4 for integer images — Middlebury 2003 "
        "Teddy/Cones PNGs store disparity*4)",
    )
    run.add_argument("--synthetic", help="HxW procedural pair with ground truth")
    run.add_argument(
        "--trace", metavar="DIR",
        help="capture an XProf/Perfetto trace of the run into DIR "
        "(stages appear as stereo/<stage> named scopes)",
    )
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--disp-range", type=int, default=None)
    run.add_argument("--set", action="append", metavar="FIELD=VALUE")
    run.add_argument("--save-stages", metavar="DIR")
    run.add_argument(
        "--executor", choices=("direct", "tiled", "streamed", "gspmd"),
        default="direct",
        help="direct = single program; tiled = shard_map row tiles over all "
        "devices; streamed = sequential row bands (memory-bounded, 4K-class "
        "inputs); gspmd = sharded-input pjit (every config variant)",
    )
    run.add_argument(
        "--row-tile", type=int, default=None,
        help="rows per band for --executor streamed (default: auto-sized "
        "from the live-buffer model, parallel.streamed.auto_row_tile)",
    )
    run.set_defaults(func=cmd_run)

    ev = sub.add_parser(
        "eval", help="evaluate a pipeline over a dataset directory (bad-pixel rates)"
    )
    ev.add_argument("pipeline")
    ev.add_argument(
        "--data", required=True,
        help="a scene directory or a directory of scene directories",
    )
    ev.add_argument("--left-name", default="im2.png")
    ev.add_argument("--right-name", default="im6.png")
    ev.add_argument("--gt-name", default="disp2.png")
    ev.add_argument(
        "--gt-scale", type=float, default=None,
        help="divide ground-truth values by this; default is the format's "
        "convention (1 for PFM, 4 for integer images)",
    )
    ev.add_argument("--thresh", type=float, default=2.0, help="bad-pixel threshold")
    ev.add_argument("--disp-range", type=int, default=None)
    ev.add_argument("--set", action="append", metavar="FIELD=VALUE")
    ev.set_defaults(func=cmd_eval)

    bench = sub.add_parser("bench", help="run the throughput harness")
    bench.add_argument("--pipeline", default="ad_census")
    bench.set_defaults(func=cmd_bench)

    info = sub.add_parser("info", help="print framework/device info")
    info.set_defaults(func=cmd_info)

    args = ap.parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.no_compile_cache:
        # repeated invocations of the same pipeline/shape skip the XLA
        # compile (utils.compile_cache has the directory rule)
        from stereo_match_traditional_tpu.utils.compile_cache import (
            configure_compile_cache,
        )

        configure_compile_cache()
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
