"""Pipelines on a REAL photograph (tests/data/real*_*.png).

Until now every test pixel was procedural; these pairs warp matplotlib's
bundled public-domain Grace Hopper portrait (see
tests/data/generate_real_pair.py) so real-texture pathologies — sensor
noise, JPEG artifacts, saturated/near-uniform regions — reach the
matchers.  Budgets are ~1.2x the
measured rates (regression tripwires AND honest
accuracy claims): at D=24 sad 0.0693, ad_census 0.0685, cblsm 0.0711,
asw 0.0519, ncc 0.1753 (NCC's includes its excluded interior border
counting as bad, `NCC.h:72-75`); at the serving-range D=64 pair
(192x256) sad 0.1390, ad_census 0.1113, cblsm 0.1199, ncc 0.2157.

Also cross-checks the flagship against the independent C++
implementation on the real pair — extending test_cpp_parity's synthetic
triangulation to real texture.
"""

import os
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.utils import io
from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
D = 24


@pytest.fixture(scope="module")
def real_pair():
    L = io.imread(os.path.join(_DATA, "real_left.png"))
    R = io.imread(os.path.join(_DATA, "real_right.png"))
    gt = io.read_gt_disparity(os.path.join(_DATA, "real_gt.pfm"))
    return L, R, gt


@pytest.mark.parametrize(
    "name,cfg,budget",
    [
        ("sad", cfgs.SADConfig(max_disparity=D, winsize=2), 0.084),
        ("ad_census", cfgs.ADCensusConfig(disp_range=D), 0.083),
        pytest.param("cblsm", cfgs.CBLSMConfig(disp_range=D), 0.086,
                     marks=pytest.mark.slow),
        pytest.param(
            "asw",
            cfgs.ASWConfig(disp_range=D, win_size=5, use_pallas=False,
                           run_post=False),
            0.063, marks=pytest.mark.slow,
        ),
        ("ncc", cfgs.NCCConfig(disp_range=D, win_size=4), 0.21),
    ],
)
def test_real_texture_accuracy(real_pair, name, cfg, budget):
    L, R, gt = real_pair
    fn, _ = get_pipeline(name)
    res = jax.jit(lambda l, r: fn(l, r, cfg))(jnp.asarray(L), jnp.asarray(R))
    b2 = bad_pixel_rate(np.asarray(res.disp_left), gt)
    assert b2 < budget, (name, b2)


D64 = 64


@pytest.fixture(scope="module")
def real_pair_64():
    L = io.imread(os.path.join(_DATA, "real64_left.png"))
    R = io.imread(os.path.join(_DATA, "real64_right.png"))
    gt = io.read_gt_disparity(os.path.join(_DATA, "real64_gt.pfm"))
    return L, R, gt


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,cfg,budget",
    [
        ("sad", cfgs.SADConfig(max_disparity=D64, winsize=2), 0.17),
        ("ad_census", cfgs.ADCensusConfig(disp_range=D64), 0.135),
        ("cblsm", cfgs.CBLSMConfig(disp_range=D64), 0.145),
        ("ncc", cfgs.NCCConfig(disp_range=D64, win_size=4), 0.26),
    ],
)
def test_real_texture_accuracy_serving_range(real_pair_64, name, cfg, budget):
    """Serving-range (D=64) real-texture accuracy —
    budgets ~1.2x the measured rates in the module docstring."""
    L, R, gt = real_pair_64
    fn, _ = get_pipeline(name)
    res = jax.jit(lambda l, r: fn(l, r, cfg))(jnp.asarray(L), jnp.asarray(R))
    b2 = bad_pixel_rate(np.asarray(res.disp_left), gt)
    assert b2 < budget, (name, b2)


@pytest.mark.slow
def test_real_texture_cpp_parity(real_pair, tmp_path):
    """Framework vs the independent C++ parity implementation on real
    texture: disparity maps agree on >= 99% of pixels (same tie-flip
    budget as test_cpp_parity's synthetic pairs)."""
    src_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native", "cpu_baseline",
    )
    src = os.path.join(src_dir, "parity_baseline.cpp")
    exe = os.path.join(src_dir, "parity_baseline")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.check_call(["g++", "-O2", "-o", exe, src])
    L, R, _ = real_pair
    h, w = L.shape
    lp, rp = str(tmp_path / "L.u8"), str(tmp_path / "R.u8")
    L.tofile(lp)
    R.tofile(rp)
    prefix = str(tmp_path / "ad_census")
    subprocess.check_call(
        [exe, "ad_census", str(h), str(w), str(D), lp, rp, prefix], timeout=300
    )
    cpp = np.fromfile(prefix + ".left.f32", np.float32).reshape(h, w)
    fn, _ = get_pipeline("ad_census")
    ours = np.asarray(
        jax.jit(lambda l, r: fn(l, r, cfgs.ADCensusConfig(disp_range=D)))(
            jnp.asarray(L), jnp.asarray(R)
        ).disp_left
    )
    assert float(np.mean(ours != cpp)) <= 0.01
