"""End-to-end demo: all five pipelines on a synthetic stereo pair.

    python examples/demo.py [--cpu] [--out-dir /tmp/stereo_demo]

Generates a procedural rectified pair with ground truth (the reference
hard-codes Middlebury Teddy files it does not ship), runs every pipeline
with its reference-default config, reports bad-2.0 accuracy, and writes
normalized disparity PNGs + stage checkpoints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the GPU")
    ap.add_argument("--out-dir", default="/tmp/stereo_demo")
    ap.add_argument("--size", default="192x256")
    ap.add_argument("--disp", type=int, default=32)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from stereo_match_traditional_tpu.models import PIPELINES, get_pipeline
    from stereo_match_traditional_tpu.utils import io as io_utils
    from stereo_match_traditional_tpu.utils.checkpoint import save_result
    from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate, make_pair

    h, w = (int(x) for x in args.size.split("x"))
    left, right, gt = make_pair(h, w, args.disp, seed=0)
    os.makedirs(args.out_dir, exist_ok=True)
    io_utils.imwrite(os.path.join(args.out_dir, "left.png"), left)
    io_utils.imwrite(os.path.join(args.out_dir, "right.png"), right)

    print(f"{'pipeline':12s} {'bad-2.0':>8s}")
    from stereo_match_traditional_tpu.config import disp_override_kw

    for name in sorted(PIPELINES):
        fn, cfg_cls = get_pipeline(name)
        cfg = cfg_cls(**disp_override_kw(cfg_cls, args.disp))
        res = jax.jit(lambda l, r: fn(l, r, cfg))(jnp.asarray(left), jnp.asarray(right))
        disp = np.asarray(res.disp_left)
        print(f"{name:12s} {bad_pixel_rate(disp, gt):8.3f}")
        io_utils.imwrite(
            os.path.join(args.out_dir, f"disp_{name}.png"), io_utils.normalize_u8(disp)
        )
        save_result(os.path.join(args.out_dir, f"stages_{name}"), res, {"pipeline": name})
    print(f"outputs -> {args.out_dir}")


if __name__ == "__main__":
    main()
