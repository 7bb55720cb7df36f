"""The ASW Pallas kernel (Triton route) vs its jnp reference op.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
its Triton lowering is checked by lowering for CUDA without a card, and
``tests/test_gpu_smoke.py`` compares the compiled kernel on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline
from stereo_match_traditional_tpu.ops import volume
from stereo_match_traditional_tpu.ops.kernels import (
    asw_pallas,
    asw_volume_pallas,
    resolve_use_pallas,
)
from stereo_match_traditional_tpu.utils.synthetic import make_pair


def test_asw_pallas_matches_jnp_left():
    L, R, _ = make_pair(14, 18, 5, seed=2)
    want = np.asarray(
        volume.asw_volume(L, R, 5, win_size=2, space_sigma=50, color_sigma=30, truncation=40)
    )
    got = np.asarray(
        asw_volume_pallas(L, R, 5, 2, 50.0, 30.0, 40.0, "left", interpret=True)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_asw_pallas_matches_jnp_right():
    """The right view through the mirror identity equals asw_volume_right."""
    L, R, _ = make_pair(12, 20, 4, seed=5)
    want = np.asarray(
        volume.asw_volume_right(
            L, R, 4, win_size=1, space_sigma=50, color_sigma=30, truncation=40
        )
    )
    got = np.asarray(
        asw_volume_pallas(L, R, 4, 1, 50.0, 30.0, 40.0, "right", interpret=True)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_asw_pallas_pads_ragged_tiles_and_chunks():
    """Shapes and a disparity range that are no multiple of the block
    (rows, columns, disparity chunk): the padding is cropped exactly."""
    L, R, _ = make_pair(11, 70, 7, seed=4)
    got = np.asarray(asw_volume_pallas(L, R, 7, 1, interpret=True))
    want = np.asarray(volume.asw_volume(L, R, 7, 1))
    assert got.shape == (7, 11, 70)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.slow
def test_asw_pallas_default_params_shape():
    """Reference-default geometry: 25x25 window, uneven tile remainders."""
    L, R, _ = make_pair(20, 30, 6, seed=1)
    got = np.asarray(
        asw_volume_pallas(L, R, 6, 11, 50.0, 30.0, 40.0, "left", interpret=True)
    )
    want = np.asarray(volume.asw_volume(L, R, 6, 11, 50.0, 30.0, 40.0))
    assert got.shape == (6, 20, 30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_asw_pallas_lowers_for_cuda():
    """The kernel's Triton lowering (block shapes, indexing, the window
    loops) at the reference workload, produced without a card through a
    cross-platform export; the GPU compiles what this emits."""
    from jax import export

    L, R, _ = make_pair(375, 450, 60, seed=0)
    fn = jax.jit(lambda l, r: asw_volume_pallas(l, r, 60, 11))
    exp = export.export(
        fn,
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )
    # asw_volume_pallas refuses a non-GPU default backend unless interpreted
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "gpu")
        text = exp(jnp.asarray(L), jnp.asarray(R)).mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "asw_volume"' in text


@pytest.mark.parametrize(
    "backend,use_pallas,want",
    [
        ("gpu", None, True),
        ("cpu", None, False),
        ("gpu", True, True),
        ("gpu", False, False),
        ("cpu", False, False),
    ],
)
def test_use_pallas_resolution_per_backend(monkeypatch, backend, use_pallas, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_use_pallas(use_pallas) is want


def test_use_pallas_true_without_compiled_route_raises():
    assert jax.default_backend() == "cpu"
    with pytest.raises(ValueError, match="needs the GPU backend"):
        resolve_use_pallas(True)
    L, R, _ = make_pair(16, 24, 4, seed=0)
    fn, _ = get_pipeline("asw")
    with pytest.raises(ValueError, match="needs the GPU backend"):
        fn(jnp.asarray(L), jnp.asarray(R), cfgs.ASWConfig(disp_range=4, win_size=1,
                                                          use_pallas=True))


def test_asw_pallas_never_interprets_unasked():
    """Off the GPU the kernel raises instead of falling back to the
    interpreter on its own."""
    L, R, _ = make_pair(12, 20, 4, seed=5)
    with pytest.raises(ValueError, match="interpret=True"):
        asw_volume_pallas(L, R, 4, 1)
    assert asw_pallas.asw_volume_pallas.__defaults__[-1] is False
