"""Compiled-on-the-card tests (the GPU lowering, not the interpreter).

The default suite runs on the CPU backend, where the ASW kernel can run
only in the Pallas interpreter and matrix products ignore their
precision.  These tests compile on the GPU and call the same checks as
``chip_smoke.py``:

    STEREO_TESTS_GPU=1 python -m pytest tests/test_gpu_smoke.py -m gpu -q

Without a GPU each test skips (the ``gpu`` fixture decides at run time).
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", sorted(chip_smoke.REFERENCE_BAD2))
def test_pipeline_on_gpu(gpu, name):
    list(chip_smoke.phase_reference_paths(names=(name,)))


def test_full_flagship_on_gpu(gpu):
    """Scanline + the complete post chain (speckle flood, 8-direction
    fill, median) compiled for the card."""
    list(chip_smoke.phase_full())


def test_full_flagship_serving_shape_on_gpu(gpu):
    list(chip_smoke.phase_full(chip_smoke.SERVING, bound=None))


def test_cli_run_full_on_gpu(gpu):
    list(chip_smoke.phase_cli())


def test_batched_pipeline_on_gpu(gpu):
    list(chip_smoke.phase_batched())


def test_canonical_cross_two_pass_on_gpu(gpu):
    list(chip_smoke.phase_canonical())


def test_streamed_scanline_on_gpu(gpu):
    """The streamed FULL flagship (vertical band carries inside two
    lax.scan sweeps) at the Teddy shape keeps the direct accuracy."""
    list(chip_smoke.phase_streamed(chip_smoke.TEDDY, row_tile=128,
                                   bound=chip_smoke.FULL_BAD2))


def test_streamed_4k_on_gpu(gpu):
    list(chip_smoke.phase_streamed())


def test_asw_kernel_matches_jnp_on_gpu(gpu):
    list(chip_smoke.phase_asw_kernel(time_shapes=()))


def test_asw_approx_grid_on_gpu(gpu):
    list(chip_smoke.phase_asw_grid())


def test_matmul_exact_f32_on_gpu(gpu):
    """The box sums and triangular-matmul cumsums must run in float32,
    not TF32 — the CPU backend ignores precision, so only the card can
    catch a product that drops to the default."""
    list(chip_smoke.phase_matmul_exactness())
