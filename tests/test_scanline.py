"""Scanline optimizer vs. naive DP oracle."""

import jax.numpy as jnp
import numpy as np

import oracles
from stereo_match_traditional_tpu.config import ScanlineConfig
from stereo_match_traditional_tpu.ops import scanline


def _case(seed=0, d=5, h=6, w=8):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 4, size=(d, h, w)).astype(np.float32)
    gray = rng.integers(0, 256, size=(h, w)).astype(np.float32)
    return cost, gray


def test_four_direction_sum_matches_oracle():
    cost, gray = _case()
    cfg = ScanlineConfig(p1=1.0, p2=8.0)
    got = np.asarray(scanline.scanline_optimize(cost, gray, cfg))
    want = sum(
        oracles.scanline_pass(cost, gray, 1.0, 8.0, dr) for dr in ("lr", "rl", "ud", "du")
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_faithful_vertical_quirk():
    cost, gray = _case(seed=2)
    cfg = ScanlineConfig(p1=2.0, p2=20.0, faithful_vertical_l2=True)
    got = np.asarray(scanline.scanline_optimize(cost, gray, cfg))
    want = (
        oracles.scanline_pass(cost, gray, 2.0, 20.0, "lr")
        + oracles.scanline_pass(cost, gray, 2.0, 20.0, "rl")
        + oracles.scanline_pass(cost, gray, 2.0, 20.0, "ud", l2_uses_dm1=False)
        + oracles.scanline_pass(cost, gray, 2.0, 20.0, "du", l2_uses_dm1=False)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_penalty_scale_parity_and_effect():
    """Opt-in penalty scaling: scale=1.0 and 'auto' at
    the reference's D=60 calibration point are bit-identical to the parity
    default; an explicit scale equals scaling p1/p2 directly."""
    cost, gray = _case(seed=3, d=6)
    base = np.asarray(scanline.scanline_optimize(cost, gray, ScanlineConfig()))
    one = np.asarray(
        scanline.scanline_optimize(cost, gray, ScanlineConfig(penalty_scale=1.0))
    )
    np.testing.assert_array_equal(base, one)

    # 'auto' at D=60: scale = 60/60 = 1 -> parity
    cost60 = np.concatenate([cost] * 10, axis=0)
    a = np.asarray(
        scanline.scanline_optimize(
            cost60, gray, ScanlineConfig(penalty_scale="auto")
        )
    )
    b = np.asarray(scanline.scanline_optimize(cost60, gray, ScanlineConfig()))
    np.testing.assert_array_equal(a, b)

    # explicit 0.25 == running with p1/4, p2/4
    got = np.asarray(
        scanline.scanline_optimize(cost, gray, ScanlineConfig(penalty_scale=0.25))
    )
    want = np.asarray(
        scanline.scanline_optimize(cost, gray, ScanlineConfig(p1=2.5, p2=37.5))
    )
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)


def test_constant_cost_stays_constant():
    """With P1 large and uniform cost, aggregation must not distort argmin."""
    d, h, w = 4, 5, 7
    cost = np.zeros((d, h, w), np.float32)
    cost[2] = -1.0  # best plane
    gray = np.zeros((h, w), np.float32)
    out = np.asarray(scanline.scanline_optimize(cost, gray, ScanlineConfig(p1=10, p2=150)))
    assert (np.argmin(out, axis=0) == 2).all()


def test_faithful_vertical_p2_uses_column_start():
    """`ScanLineUpDown` never updates grayLast (`ScanlineOptimizer.h:210,232`):
    with the quirk flag, vertical P2 adapts to the column-start pixel."""
    import numpy as np
    import jax.numpy as jnp
    from stereo_match_traditional_tpu.config import ScanlineConfig
    from stereo_match_traditional_tpu.ops.scanline import scanline_optimize

    rng = np.random.default_rng(0)
    cost = rng.random((3, 6, 1)).astype(np.float32)  # [D, H, W=1]
    gray = rng.integers(0, 256, (6, 1)).astype(np.float32)

    # manual single-column recurrence, quirky P2 (|I(p) - I(row 0)|)
    def vert_pass(c, g, rows):
        p1, p2i = 10.0, 150.0
        agg = np.zeros_like(c)
        agg[:, rows[0]] = c[:, rows[0]]
        prev = c[:, rows[0]].copy()
        g0 = g[rows[0]]
        for i in rows[1:]:
            p2 = max(p1, p2i / (abs(g[i] - g0) + 1.0))
            pmin = prev.min()
            out = np.empty(3, np.float32)
            for d in range(3):
                l1 = prev[d]
                l2 = prev[d] + p1          # faithful vertical l2 quirk
                l3 = prev[d + 1] + p1 if d + 1 < 3 else np.inf
                l4 = pmin + p2
                out[d] = c[d, i] + min(l1, l2, l3, l4) - pmin
            agg[:, i] = out
            prev = out
        return agg

    c = cost[:, :, 0]
    g = gray[:, 0]
    want_vert = vert_pass(c, g, list(range(6))) + vert_pass(c, g, list(range(5, -1, -1)))
    cfg = ScanlineConfig(faithful_vertical_l2=True, faithful_vertical_p2=True)
    got = np.asarray(scanline_optimize(jnp.asarray(cost), jnp.asarray(gray), cfg))
    # subtract the (quirk-free) horizontal contribution: W=1 so the
    # horizontal passes are identity-ish: lr = rl = cost -> 2*cost
    got_vert = got[:, :, 0] - 2.0 * c
    np.testing.assert_allclose(got_vert, want_vert, rtol=1e-5, atol=1e-4)


def test_canonical_pass_banded_matches_monolithic():
    """Band continuation of the canonical tso pass == the monolithic
    `_canonical_pass`, bitwise, for any band split (the streamed canonical
    executor's building block): a zero carry is the exact path seed and the
    chunked steps evaluate in the same order."""
    from stereo_match_traditional_tpu.ops.scanline import (
        _canonical_pass, canonical_pass_banded, canonical_scale,
    )

    rng = np.random.default_rng(3)
    n, d, m = 13, 5, 7
    cost = jnp.asarray(rng.random((n, d, m)).astype(np.float32))
    g1 = jnp.asarray(rng.integers(0, 256, (n, m)).astype(np.float32))
    g2 = jnp.asarray(rng.integers(0, 256, (n, d, m)).astype(np.float32))
    p1, p2, tso = 1.0, 3.0, 15.0

    want = np.asarray(_canonical_pass(cost, g1, g2, p1, p2, tso))

    scale = canonical_scale(
        g1, jnp.concatenate([g1[:1], g1[:-1]]),
        g2, jnp.concatenate([g2[:1], g2[:-1]]), tso,
    )
    carry = (jnp.zeros((d, m), jnp.float32), jnp.zeros((m,), jnp.float32))
    pieces = []
    for lo, hi in ((0, 4), (4, 9), (9, n)):
        out, carry = canonical_pass_banded(
            cost[lo:hi], scale[lo:hi], carry, None, p1, p2)
        pieces.append(np.asarray(out))
    got = np.concatenate(pieces, axis=0)
    np.testing.assert_array_equal(got, want)
