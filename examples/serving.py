"""Serving demo: stream disparity maps for a directory of stereo pairs.

    python examples/serving.py [--cpu] [--pipeline ad_census] [--batch 4]

The production shape of the engine: the native threaded loader decodes
PGM pairs on C++ worker threads while the GPU computes the previous
batch (`utils.native.PairLoader`), `models.batch.serve_pairs` batches
them through one compiled program (`lax.map` holds single-pair
throughput — see README), and normalized disparity PNGs stream out.
The reference has no serving path at all — each binary hard-codes one
image pair (`SAD/SADmain.cpp:27-28`).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the GPU")
    ap.add_argument("--pipeline", default="ad_census")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--size", default="192x256")
    ap.add_argument("--disp", type=int, default=32)
    ap.add_argument("--out-dir", default="/tmp/stereo_serving")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from stereo_match_traditional_tpu.models import get_pipeline
    from stereo_match_traditional_tpu.models.batch import serve_pairs
    from stereo_match_traditional_tpu.utils import io as io_utils
    from stereo_match_traditional_tpu.utils import native
    from stereo_match_traditional_tpu.utils.synthetic import make_pair

    h, w = (int(x) for x in args.size.split("x"))
    os.makedirs(args.out_dir, exist_ok=True)

    # 1) stage a request set on disk; decide the decode path up front —
    #    staging must use a writer that exists (native.write_pnm raises
    #    when the lib cannot be built, so it can't gate the fallback)
    use_native = native.available()
    ext = "pgm" if use_native else "png"
    paths = []
    for i in range(args.pairs):
        L, R, _ = make_pair(h, w, args.disp, seed=i)
        lp = os.path.join(args.out_dir, f"pair{i:03d}_l.{ext}")
        rp = os.path.join(args.out_dir, f"pair{i:03d}_r.{ext}")
        if use_native:
            native.write_pnm(lp, L)
            native.write_pnm(rp, R)
        else:
            io_utils.imwrite(lp, L)
            io_utils.imwrite(rp, R)
        paths.append((lp, rp))

    # 2) decode on native threads, overlap with device compute
    if use_native:
        feed = native.PairLoader(paths, threads=4)
        src = "native threaded loader"
    else:  # native lib not built: plain host decode
        feed = ((io_utils.imread(l), io_utils.imread(r)) for l, r in paths)
        src = "imageio fallback"

    from stereo_match_traditional_tpu.config import disp_override_kw

    _, cfg_cls = get_pipeline(args.pipeline)
    cfg = cfg_cls(**disp_override_kw(cfg_cls, args.disp))

    # 3) batch-DP: with several devices, shard each batch across them
    #    (zero collectives — the throughput scale-out axis)
    mesh = None
    n_dev = len(jax.devices())
    if n_dev > 1 and args.batch % n_dev == 0:
        from stereo_match_traditional_tpu.parallel import make_mesh

        mesh = make_mesh(n_dev, ("batch",))

    t0 = time.time()
    n = 0
    for i, disp in enumerate(
        serve_pairs(args.pipeline, feed, cfg, batch_size=args.batch, mesh=mesh)
    ):
        io_utils.imwrite(
            os.path.join(args.out_dir, f"pair{i:03d}_disp.png"),
            io_utils.normalize_u8(np.asarray(disp)),
        )
        n += 1
    dt = time.time() - t0
    print(
        f"{n} pairs via {src}, batch={args.batch}: "
        f"{dt:.2f} s wall ({n / dt:.1f} pairs/s incl. compile) -> {args.out_dir}"
    )


if __name__ == "__main__":
    main()
