"""Ground-truth I/O: PFM round trip, scaled-PNG GT, CLI --gt wiring.

The reference evaluates nothing (SURVEY §4: validation was imshow windows),
but its hard-coded Teddy pair (`SAD/SADmain.cpp:27-28`) is a Middlebury
dataset — whose ground truth ships as disparity*4 PNGs (2003) or PFM
(2005+).  These tests cover the evaluation path a reference user needs.
"""

import json

import numpy as np
import pytest

from stereo_match_traditional_tpu.utils import io
from stereo_match_traditional_tpu.utils.synthetic import bad_pixel_rate, make_pair


def test_pfm_round_trip_gray(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((13, 17)).astype(np.float32)
    p = tmp_path / "d.pfm"
    io.write_pfm(str(p), data)
    back = io.read_pfm(str(p))
    assert back.shape == (13, 17) and back.dtype == np.float32
    np.testing.assert_array_equal(back, data)


def test_pfm_round_trip_color(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((7, 5, 3)).astype(np.float32)
    p = tmp_path / "c.pfm"
    io.write_pfm(str(p), data)
    np.testing.assert_array_equal(io.read_pfm(str(p)), data)


def test_pfm_big_endian_and_row_order(tmp_path):
    # Hand-built big-endian file: positive scale, rows bottom-to-top.
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = tmp_path / "be.pfm"
    with open(p, "wb") as f:
        f.write(b"Pf\n4 3\n1.0\n")
        f.write(data[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(io.read_pfm(str(p)), data)


def test_pfm_rejects_non_pfm(tmp_path):
    p = tmp_path / "x.pfm"
    p.write_bytes(b"P5\n4 3\n255\n" + bytes(12))
    with pytest.raises(ValueError):
        io.read_pfm(str(p))


def test_read_gt_disparity_pfm_inf_is_nan(tmp_path):
    gt = np.array([[1.0, np.inf], [4.0, 2.5]], dtype=np.float32)
    p = tmp_path / "gt.pfm"
    io.write_pfm(str(p), gt)
    out = io.read_gt_disparity(str(p))
    assert np.isnan(out[0, 1])
    np.testing.assert_array_equal(out[np.isfinite(out)], [1.0, 4.0, 2.5])


def test_read_gt_disparity_png_scale4_zero_unknown(tmp_path):
    # Middlebury-2003 convention: 8-bit PNG stores disparity*4, 0 = unknown.
    stored = np.array([[0, 4], [42, 255]], dtype=np.uint8)
    p = tmp_path / "disp2.png"
    io.imwrite(str(p), stored)
    out = io.read_gt_disparity(str(p), scale=4)
    assert np.isnan(out[0, 0])
    np.testing.assert_allclose(out[0, 1], 1.0)
    np.testing.assert_allclose(out[1], [10.5, 63.75])


def test_read_gt_disparity_keeps_16bit_precision(tmp_path):
    import imageio.v3 as iio

    stored = np.array([[0, 300], [70000 % 65535, 1234]], dtype=np.uint16)
    p = tmp_path / "gt16.png"
    iio.imwrite(str(p), stored)
    out = io.read_gt_disparity(str(p), scale=256)
    assert np.isnan(out[0, 0])
    np.testing.assert_allclose(out[0, 1], 300 / 256)


def test_bad_pixel_rate_valid_mask_excludes_unknown():
    gt = np.array([[1.0, np.nan], [5.0, 9.0]])
    disp = np.array([[1.0, 77.0], [5.0, 0.0]])  # the NaN-GT pixel is wild
    valid = np.isfinite(gt)
    assert bad_pixel_rate(disp, gt, valid=valid) == pytest.approx(1 / 3)


def test_cli_run_with_gt_file_and_pfm_out(tmp_path, capsys):
    from stereo_match_traditional_tpu import cli

    L, R, gt = make_pair(48, 64, 10, seed=5)
    lp, rp, gp = tmp_path / "l.png", tmp_path / "r.png", tmp_path / "gt.pfm"
    io.imwrite(str(lp), L)
    io.imwrite(str(rp), R)
    # Mark a corner unknown: it must be excluded, not counted bad/good.
    gt_file = gt.copy()
    gt_file[:8, :8] = np.inf
    io.write_pfm(str(gp), gt_file)
    out_pfm = tmp_path / "d.pfm"
    rc = cli.main(
        [
            "run", "sad", "--left", str(lp), "--right", str(rp),
            "--disp-range", "10", "--gt", str(gp), "--out-pfm", str(out_pfm),
        ]
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= summary["bad_2.0"] < 0.3
    disp = io.read_pfm(str(out_pfm))
    assert disp.shape == (48, 64)
    # The PFM round trip preserves the raw (non-display) disparities.
    finite = np.isfinite(disp)
    assert finite.any() and disp[finite].max() <= 10


def test_cli_rejects_gt_with_synthetic():
    from stereo_match_traditional_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["run", "sad", "--synthetic", "32x32", "--gt", "x.pfm"])


def test_cli_rejects_gt_shape_mismatch(tmp_path):
    from stereo_match_traditional_tpu import cli

    L, R, _ = make_pair(32, 48, 10, seed=2)
    lp, rp, gp = tmp_path / "l.png", tmp_path / "r.png", tmp_path / "g.pfm"
    io.imwrite(str(lp), L)
    io.imwrite(str(rp), R)
    io.write_pfm(str(gp), np.zeros((16, 16), np.float32))
    with pytest.raises(SystemExit):
        cli.main(
            ["run", "sad", "--left", str(lp), "--right", str(rp), "--gt", str(gp)]
        )


def _write_scene(d, seed, h=48, w=64):
    import os

    os.makedirs(d, exist_ok=True)
    L, R, gt = make_pair(h, w, 10, seed=seed)
    io.imwrite(os.path.join(d, "im2.png"), L)
    io.imwrite(os.path.join(d, "im6.png"), R)
    # Middlebury-2003 GT convention: disparity*4 u8, 0 = unknown
    g = np.round(gt * 4).astype(np.uint8)
    g[:4, :4] = 0
    io.imwrite(os.path.join(d, "disp2.png"), g)


def test_cli_eval_dataset_directory(tmp_path, capsys):
    from stereo_match_traditional_tpu import cli

    _write_scene(str(tmp_path / "teddy"), seed=11)
    _write_scene(str(tmp_path / "cones"), seed=12)
    rc = cli.main(
        ["eval", "sad", "--data", str(tmp_path), "--disp-range", "10"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [s["scene"] for s in out["scenes"]] == ["cones", "teddy"]
    for s in out["scenes"]:
        assert 0.0 <= s["bad_2.0"] < 0.5
    assert out["mean_bad_2.0"] == pytest.approx(
        np.mean([s["bad_2.0"] for s in out["scenes"]]), abs=1e-3
    )


def test_cli_eval_single_scene_custom_thresh(tmp_path, capsys):
    from stereo_match_traditional_tpu import cli

    _write_scene(str(tmp_path / "teddy"), seed=13)
    rc = cli.main(
        [
            "eval", "sad", "--data", str(tmp_path / "teddy"),
            "--disp-range", "10", "--thresh", "1.0",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["scenes"][0]["scene"] == "teddy"
    assert "bad_1.0" in out["scenes"][0]


def test_cli_eval_no_scene_errors(tmp_path):
    from stereo_match_traditional_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["eval", "sad", "--data", str(tmp_path)])


def test_cli_run_trace_capture(tmp_path, capsys):
    from stereo_match_traditional_tpu import cli

    trace_dir = tmp_path / "trace"
    rc = cli.main(
        [
            "run", "sad", "--synthetic", "32x48", "--disp-range", "8",
            "--trace", str(trace_dir),
        ]
    )
    assert rc == 0
    # jax.profiler writes plugins/profile/<ts>/*.xplane.pb under the dir
    found = list(trace_dir.rglob("*.xplane.pb"))
    assert found, f"no trace artifacts under {trace_dir}"


def test_pfm_crlf_header_tolerated(tmp_path):
    # Text-mode writers terminate the scale with CRLF; the raster must not
    # be read one byte shifted.
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = tmp_path / "crlf.pfm"
    with open(p, "wb") as f:
        f.write(b"Pf\r\n3 2\r\n-1.0\r\n")
        f.write(data[::-1].astype("<f4").tobytes())
    np.testing.assert_array_equal(io.read_pfm(str(p)), data)


def test_pfm_rejects_corrupt_header_and_truncation(tmp_path):
    bad_dims = tmp_path / "bad.pfm"
    bad_dims.write_bytes(b"Pf\n-4 3\n-1.0\n" + bytes(48))
    with pytest.raises(ValueError):
        io.read_pfm(str(bad_dims))
    trunc = tmp_path / "trunc.pfm"
    trunc.write_bytes(b"Pf\n4 3\n-1.0\n" + bytes(20))  # needs 48
    with pytest.raises(ValueError):
        io.read_pfm(str(trunc))


def test_read_gt_disparity_auto_scale(tmp_path):
    # None picks the format convention: PFM / 1, integer image / 4.
    pf = tmp_path / "a.pfm"
    io.write_pfm(str(pf), np.full((2, 2), 8.0, np.float32))
    np.testing.assert_allclose(io.read_gt_disparity(str(pf)), 8.0)
    png = tmp_path / "a.png"
    io.imwrite(str(png), np.full((2, 2), 8, np.uint8))
    np.testing.assert_allclose(io.read_gt_disparity(str(png)), 2.0)


def test_cli_eval_all_unknown_gt_is_null_not_perfect(tmp_path, capsys):
    import os

    from stereo_match_traditional_tpu import cli

    _write_scene(str(tmp_path / "good"), seed=21)
    _write_scene(str(tmp_path / "empty"), seed=22)
    io.imwrite(
        os.path.join(str(tmp_path / "empty"), "disp2.png"),
        np.zeros((48, 64), np.uint8),  # every pixel unknown
    )
    rc = cli.main(["eval", "sad", "--data", str(tmp_path), "--disp-range", "10"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    by = {s["scene"]: s for s in out["scenes"]}
    assert by["empty"]["bad_2.0"] is None
    # the empty scene must not drag the mean toward perfect
    assert out["mean_bad_2.0"] == by["good"]["bad_2.0"]


def test_cli_eval_missing_data_dir_is_clean_error():
    from stereo_match_traditional_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["eval", "sad", "--data", "/nonexistent/path/xyz"])


def test_cli_eval_asw_scores_raw_wta_map(tmp_path, capsys):
    # ASW's disp_final is display-scaled (`ASWeight.cpp:69`); eval must
    # score the raw WTA map or the bad rate would be ~1.0.
    from stereo_match_traditional_tpu import cli

    _write_scene(str(tmp_path / "teddy"), seed=31, h=40, w=56)
    rc = cli.main(["eval", "asw", "--data", str(tmp_path), "--disp-range", "10"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["scenes"][0]["bad_2.0"] < 0.5


def test_lab_u8_fixed_point_matches_float_within_quantization():
    """The OpenCV-fixed-point u8 Lab path (`RGB2Lab_b` semantics) must
    track the float formula within LUT quantization (<= 2 codes) over a
    dense RGB lattice — and differ somewhere (proving it reproduces the
    integer pipeline, not the float one).  OpenCV itself is not
    installable in this container; this tolerance plus the primary-color
    table below is the verification available."""
    g = np.arange(0, 256, 5, dtype=np.uint8)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    lattice = lattice.reshape(1, -1, 3)
    fx = io.rgb_to_lab_u8(lattice).astype(np.int32)
    fl = io.rgb_to_lab_u8_float(lattice).astype(np.int32)
    diff = np.abs(fx - fl)
    assert diff.max() <= 2, diff.max()
    assert (diff > 0).any()  # quantization IS visible in the codes


def test_lab_u8_known_colors():
    """sRGB primaries/extremes: the well-known D65 Lab values (e.g. red
    L*=53.24, a*=80.09, b*=67.20) in OpenCV's u8 encoding."""
    rgb = np.array(
        [[[255, 255, 255], [0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255],
          [128, 128, 128]]], np.uint8
    )
    got = io.rgb_to_lab_u8(rgb)[0].astype(int)
    want = np.array(
        [[255, 128, 128], [0, 128, 128], [136, 208, 195],
         [224, 42, 211], [82, 207, 20], [137, 128, 128]]
    )
    assert (np.abs(got - want) <= 1).all(), got.tolist()
