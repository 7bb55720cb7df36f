"""Generate the checked-in REAL-texture stereo pair (tests/data/real_*.png).

Every other test pixel in this repo is procedural (the reference ships no
images — `SAD/SADmain.cpp:27-28` hard-codes files not in its repo, and
this container has no network).  This pair warps a REAL photograph so
real-texture pathologies — sensor noise, saturated/near-uniform regions,
JPEG artifacts — exercise the matchers.

Source texture: matplotlib's bundled ``grace_hopper.jpg`` — the official
U.S. Navy portrait of RADM Grace Hopper, a U.S. federal government work
in the public domain (the reason matplotlib/TensorFlow ship it as their
standard sample image).  The warp geometry mirrors
`utils.synthetic.make_pair`: integer piecewise-smooth disparity (ramp +
foreground box), right view built by scattering left pixels to ``j - d``,
occluded columns keeping background texture.  Ground truth is written
with the framework's own PFM codec.

Run from the repo root (regeneration changes goldens — deliberate only):

    PYTHONPATH=. python tests/data/generate_real_pair.py
"""

import os

import numpy as np

from stereo_match_traditional_tpu.utils import io as io_utils

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, D = 128, 192, 24
# serving-range pair: D >= 64 with real texture
H64, W64, D64 = 192, 256, 64


def _write_pair(gray, row0, col0, h, w, d, prefix) -> None:
    # a textured crop (face + uniform's braid + background edge), width
    # w + d columns so the left view has true texture for every shift
    tex = gray[row0 : row0 + h, col0 : col0 + w + d]
    assert tex.shape == (h, w + d), tex.shape

    rng = np.random.default_rng(7)
    base = rng.standard_normal((3, 4))
    ys = np.linspace(0, 1.999, h).astype(int)
    xs = np.linspace(0, 2.999, w).astype(int)
    disp = 2.0 + (base[np.ix_(ys, xs)] - base.min()) / (base.max() - base.min() + 1e-9) * (d * 0.45)
    disp[h // 4 : 3 * h // 4, w // 3 : 2 * w // 3] = d * 0.75
    disp = np.clip(np.round(disp), 1, d - 2).astype(np.int32)

    left = tex[:, d : d + w]
    right = tex[:, :w].copy()
    rows = np.arange(h)[:, None].repeat(w, 1)
    cols = np.arange(w)
    tgt = cols[None, :] - disp
    valid = tgt >= 0
    right[rows[valid], tgt[valid]] = left[valid]

    def u8(x):
        return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)

    io_utils.imwrite(os.path.join(HERE, f"{prefix}_left.png"), u8(left))
    io_utils.imwrite(os.path.join(HERE, f"{prefix}_right.png"), u8(right))
    io_utils.write_pfm(
        os.path.join(HERE, f"{prefix}_gt.pfm"), disp.astype(np.float32)
    )
    print(f"wrote {prefix} pair {h}x{w}, D={d} -> {HERE}")


def main() -> None:
    import matplotlib

    src = os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data",
        "grace_hopper.jpg",
    )
    img = io_utils.imread(src)
    gray = io_utils.rgb_to_gray_u8(img).astype(np.float64) / 255.0

    _write_pair(gray, 120, 140, H, W, D, "real")
    _write_pair(gray, 100, 100, H64, W64, D64, "real64")


if __name__ == "__main__":
    main()
