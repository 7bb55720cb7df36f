"""chip_smoke.py's four-card phases on four of the virtual CPU devices,
at tiny shapes: the same meshes, shardings and comparisons the
``--four-cards`` run makes on four GPUs."""

import chip_smoke


def test_phase_tiled_vs_direct_four_devices():
    (rec,) = list(chip_smoke.phase_tiled((32, 48, 8), "direct", n=4))
    assert rec["phase"] == "tiled4/ad_census_full_vs_direct"
    assert max(rec["mismatch"].values()) <= chip_smoke.TIE_FLIP


def test_phase_tiled_vs_streamed_four_devices():
    (rec,) = list(chip_smoke.phase_tiled((32, 48, 8), "streamed", n=4))
    assert rec["streamed"]["row_tile"] == 8          # the tile height
    assert max(rec["mismatch"].values()) <= chip_smoke.TIE_FLIP


def test_phase_batch_dp_four_devices():
    (rec,) = list(chip_smoke.phase_batch_dp((32, 44, 10), batch=8, n=4))
    assert rec["mismatch"] <= chip_smoke.TIE_FLIP


def test_four_card_phases_compile_first_then_run():
    """The ``--four-cards`` sequence at tiny shapes: one concurrent compile
    of every program, then the dry run and the three comparisons, which
    reuse the compiled programs."""
    recs = list(chip_smoke.four_card_phases(
        4, serving=(32, 48, 8), uhd=(40, 48, 8), teddy=(24, 32, 6)))
    assert [r["phase"] for r in recs] == [
        "compile4", "dryrun_multichip4", "tiled4/ad_census_full_vs_direct",
        "batch_dp4/ad_census", "tiled4/ad_census_full_vs_streamed"]
    compiled = recs[0]["compile_s"]
    assert len(compiled) >= 16 and all(t > 0 for t in compiled.values())
    # the phases found their programs compiled
    assert recs[2]["tiled"]["compile_s"] < min(compiled.values()) + 0.5
