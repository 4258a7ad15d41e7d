"""The byte and operation counts behind ``chip_smoke.py``'s bounds.

``kernel_work`` gives each kernel's function bytes (each input read once,
each output written once) and its design bytes (what one launch per
traversal moves as the path runs it).  These are computed from shapes, so
they are held here on the CPU at the two geometries the script times.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

GEOMETRIES = {"teddy": (375, 450, 128, 7, 8, 5),
              "hd": (1024, 1280, 256, 7, 8, 4)}


@pytest.mark.parametrize("tag", GEOMETRIES)
def test_sgm_design_bytes(tag):
    """sgm_rows: six traversals, each reading cost, image and out and
    writing out (18 volumes, 6 images); sgm_horizontal: the first launch
    writes out unread (5 volumes, 2 images); sgm_chunk adds the carries
    to sgm_rows."""
    h, w, d, k, r, tiles = GEOMETRIES[tag]
    volume, image = h * w * d * 4, h * w * 4
    work = chip_smoke.kernel_work(h, w, d, k, r, tiles)
    assert work["sgm_rows"][2] == 18 * volume + 6 * image
    assert work["sgm_horizontal"][2] == 5 * volume + 2 * image
    carries = 6 * (tiles - 1) * 2 * w * d * 4
    assert work["sgm_chunk"][2] == work["sgm_rows"][2] + carries
    # The function itself reads cost and image once and writes out once.
    for name in ("sgm_rows", "sgm_horizontal"):
        assert work[name][0] == 2 * volume + image


@pytest.mark.parametrize("tag,rows_ms,horizontal_ms", [
    ("teddy", 0.4654, 0.1294), ("hd", 7.2211, 2.0064)])
def test_design_floor_ms(tag, rows_ms, horizontal_ms):
    """The design floors over the card's 3.35 TB/s, and the function
    bounds they sit above."""
    bounds = chip_smoke.kernel_bounds(*GEOMETRIES[tag])
    assert bounds["sgm_rows"][2] == pytest.approx(rows_ms, abs=1e-4)
    assert bounds["sgm_horizontal"][2] == pytest.approx(horizontal_ms,
                                                        abs=1e-4)
    for name, (bound_ms, bound_by, floor_ms) in bounds.items():
        assert bound_by in ("bytes", "operations")
        if bound_by == "bytes":
            assert floor_ms >= bound_ms * (1 - 1e-12), name


def test_function_bounds_unchanged_at_teddy():
    """bound_ms at teddy, as PERF.md's kernel table records it."""
    bounds = chip_smoke.kernel_bounds(*GEOMETRIES["teddy"])
    want = {"ssd": 0.0262, "sgm_rows": 0.0518, "sgm_horizontal": 0.0518,
            "sgm_chunk": 0.0551, "dp_forward": 0.0323, "dp_backward": 0.0003,
            "cvf": 0.0527}
    for name, ms in want.items():
        assert bounds[name][0] == pytest.approx(ms, abs=1e-4), name


@pytest.mark.parametrize("tag,floor_ms", [("teddy", 0.2264), ("hd", 3.0286)])
def test_cvf_design_floor_ms(tag, floor_ms):
    """The CVF kernels' design floor: the stats kernel's tiles of volume
    and guide with their halos, the filter kernel's tiles of a0 and b0,
    three volumes written, the planes and the guide once."""
    bounds = chip_smoke.kernel_bounds(*GEOMETRIES[tag])
    assert bounds["cvf"][2] == pytest.approx(floor_ms, abs=1e-4)


@pytest.mark.parametrize("tag", GEOMETRIES)
def test_cvf_tile_reads_count_the_halos(tag):
    """Each 32-column tile reads r columns either side that lie in the
    image, each row chunk r rows above and below: more than the image
    once, less than the 1.6 x 1.6 of the narrowest chunks."""
    h, w, d, _, r, _ = GEOMETRIES[tag]
    for td, blocks_per_sm in ((16, 2), (8, 3)):
        pixels = chip_smoke.cvf_tile_reads(h, w, d, r, td, blocks_per_sm)
        assert h * w < pixels < 2.56 * h * w
    # One chunk, one tile: the image exactly.
    assert chip_smoke.cvf_tile_reads(20, 30, 4, 8, 16, 1, sms=1) == 20 * 30


@pytest.mark.parametrize("tag,name,bound_ms,bound_by,floor_ms", [
    ("teddy", "ssd", 0.0262, "bytes", 0.0262),
    ("hd", "ssd", 0.4038, "bytes", 0.4038),
    ("teddy", "sgm_chunk", 0.0551, "bytes", 0.4687),
    ("hd", "sgm_chunk", 0.8170, "bytes", 7.2352)])
def test_ssd_and_chunk_bounds_and_floors(tag, name, bound_ms, bound_by,
                                         floor_ms):
    """The SSD kernel's bound is its function's bytes (its design moves
    no more than them), and the chunk kernel's floor is sgm_rows' plus
    the carries: the figures PERF.md's kernel table records, which the
    redesigns of the two kernels leave as they were."""
    got_ms, got_by, got_floor = chip_smoke.kernel_bounds(
        *GEOMETRIES[tag])[name]
    assert got_ms == pytest.approx(bound_ms, abs=1e-4)
    assert got_by == bound_by
    assert got_floor == pytest.approx(floor_ms, abs=1e-4)


@pytest.mark.parametrize("tag,floor_ms", [("teddy", 0.0067), ("hd", 0.0644)])
def test_dp_backward_design_floor_ms(tag, floor_ms):
    """The windowed walk's design floor: the final costs read, the
    disparities written and, for each of a row's W - 1 walked columns, the
    32-byte sectors its +-64-disparity window touches (4 at D = 128, where
    the window spans the column, 5 at D = 256); its function bound stays
    the one pointer a pixel."""
    h, w, d, *_ = GEOMETRIES[tag]
    work = chip_smoke.kernel_work(*GEOMETRIES[tag])["dp_backward"]
    assert work[2] == h * d * 4 + h * w * 4 + h * (w - 1) * {128: 128,
                                                             256: 160}[d]
    bound_ms, bound_by, got_floor = chip_smoke.kernel_bounds(
        *GEOMETRIES[tag])["dp_backward"]
    assert bound_by == "bytes"
    assert got_floor == pytest.approx(floor_ms, abs=1e-4)
    assert got_floor > bound_ms


@pytest.mark.parametrize("d,sectors", [(1, 1), (24, 1), (64, 2), (65, 3),
                                       (128, 4), (129, 5), (256, 5),
                                       (512, 5)])
def test_dp_window_bytes(d, sectors):
    """A window is 129 bytes: at most 5 sectors, at most the column's."""
    assert chip_smoke.dp_window_bytes(d) == 32 * sectors


@pytest.mark.parametrize("tag", GEOMETRIES)
def test_bf16_bytes_halve_the_stored_volumes(tag):
    """bf16 storage (volume_bytes=2) halves each stored cost or aggregated
    volume and keeps the float32 partial sums, carries, a0 and b0: the
    function of sgm_rows reads a bf16 cost and writes a bf16 result, its
    launches read cost, partial and write the partial five times and the
    result once; the horizontal family writes the float32 partial."""
    h, w, d, k, r, tiles = GEOMETRIES[tag]
    vol, image = h * w * d, h * w * 4
    work = chip_smoke.kernel_work(h, w, d, k, r, tiles, volume_bytes=2)
    assert work["sgm_rows"][0] == 4 * vol + image
    assert work["sgm_rows"][2] == 58 * vol + 6 * image
    assert work["sgm_horizontal"][2] == 16 * vol + 2 * image
    carries = 6 * (tiles - 1) * 2 * w * d * 4
    assert work["sgm_chunk"][2] == work["sgm_rows"][2] + carries
    assert work["ssd"][0] == 2 * image + 2 * vol
    assert work["dp_forward"][0] == 3 * vol + h * d * 4
    f32 = chip_smoke.kernel_work(h, w, d, k, r, tiles)
    for name in ("ssd", "sgm_rows", "sgm_horizontal", "dp_forward", "cvf"):
        assert work[name][0] < f32[name][0] and work[name][1] == \
            f32[name][1], name
    assert work["dp_backward"] == f32["dp_backward"]


@pytest.mark.parametrize("name,bound_ms,floor_ms", [
    ("ssd", 0.2035, 0.2035), ("dp_forward", 0.3008, 0.3008),
    ("sgm_rows", 0.4022, 5.8188), ("sgm_horizontal", 0.6025, 1.6057),
    ("sgm_chunk", 0.4163, 5.8329)])
def test_bf16_bounds_and_floors_at_hd(name, bound_ms, floor_ms):
    """The bf16 figures at HD 1024x1280 D=256 that PERF.md's kernel table
    records beside the float32 ones."""
    got_ms, got_by, got_floor = chip_smoke.kernel_bounds(
        *GEOMETRIES["hd"], volume_bytes=2)[name]
    assert got_by == "bytes"
    assert got_ms == pytest.approx(bound_ms, abs=1e-4)
    assert got_floor == pytest.approx(floor_ms, abs=1e-4)


def test_cost_family_paths_and_gates_follow_the_golden_test():
    """chip_smoke.py holds the card's Birchfield, ZNCC and SSD-over-
    textures paths to tests/data/golden_torch_costs_teddy.npz with the
    same paths and pixel gates as the CPU test of that golden."""
    from .test_torch_costs_golden import MAX_DIFF, PATHS
    assert {name: spec for name, (spec, _) in
            chip_smoke.FAMILY_PATHS.items()} == PATHS
    assert chip_smoke.COSTS_GOLDEN_MAX_DIFF == MAX_DIFF


def test_every_entry_point_names_the_kernel_a_replay_profile_shows():
    """Each C entry point maps to the ``__global__`` kernel it launches,
    whose name the script looks for in the profile of a graph replay."""
    from stereomatch_tpu_torch.ops import _build
    sources = "".join(p.read_text() for p in _build.CSRC_DIR.glob("*.cu"))
    for entry in _build._SIGNATURES:
        kernels = [k for prefix, k in chip_smoke.KERNEL_OF_ENTRY.items()
                   if entry.startswith(prefix)]
        assert len(kernels) == 1, entry
        assert kernels[0] in sources


def test_compiled_paths_cover_the_single_card_registry_paths():
    """The compiled() phase drives the three main paths in both volume
    dtypes at teddy and in float32 at HD, every FAMILY_PATHS path (ncc in
    bf16 too), and D = 600 under backend="auto"; each factory builds a
    pipeline for the card."""
    from stereomatch_tpu_torch import cli_common
    shapes = {"teddy": (None, None, None, 128, 7),
              "hd": (None, None, None, 256, 7)}
    paths = chip_smoke.compiled_paths(cli_common, shapes, 0.1, 0.2)
    labels = [(label, tag) for label, tag, _ in paths]
    assert len(set(labels)) == len(labels) == 17
    for main in ("ssd+sgm+wta", "ssd+sgm+dyn", "census+cvf+wta"):
        assert {(main, "teddy"), (main + " bf16", "teddy"),
                (main, "hd")} <= set(labels)
    for name in chip_smoke.FAMILY_PATHS:
        assert (name, "teddy") in labels
    assert ("ssd+sgm+dyn D=600 auto", "far") in labels
    for label, tag, make in paths:
        pipe = make()
        assert pipe.device == "cuda"
        dtype = torch.bfloat16 if "bf16" in label else torch.float32
        assert getattr(pipe.cost, "cost_volume_dtype", dtype) == dtype


def test_pyramid_phase_reads_the_golden_the_cpu_test_holds():
    """check_pyramid_temporal rebuilds the golden's video and reads its
    entries as tests/test_torch_pyramid_golden.py writes them."""
    import numpy as np
    from . import test_torch_pyramid_golden as golden_test
    golden = np.load(chip_smoke.GOLDEN_PYRAMID)
    frames = chip_smoke.pyramid_video(golden)
    want = golden_test.video()
    assert len(frames) == len(want) == golden["video"].shape[0]
    for (l, r, gt), (wl, wr, wgt) in zip(frames, want):
        np.testing.assert_array_equal(l, wl)
        np.testing.assert_array_equal(r, wr)
    for levels in (1, 2):
        for dtype in ("float32", "bfloat16"):
            key = chip_smoke.pyramid_golden_key(levels, dtype)
            assert key in golden_test.PYRAMIDS and key in golden
        assert f"pyramid{levels}_refined" in golden


def test_image_runs_include_the_pyramid_and_refuse_nothing():
    flags = [run for run in chip_smoke.IMAGE_RUNS if "--pyramid" in run]
    assert [run[run.index("--pyramid") + 1] for run in flags] == ["1", "2"]
    assert not hasattr(chip_smoke, "IMAGE_REFUSALS")


def test_tune_eval_args_give_the_rows_check_tune_reads(tmp_path):
    """TUNE_EVAL_ARGS on the CPU: the tuned census row with its penalties
    and the pyramid row, the names check_tune requires; TUNE_RTOL is the
    tolerance tests/test_torch_tune.py holds the tuner to."""
    import json
    from stereomatch_tpu_torch.cli import evaluate
    from .test_torch_tune import HISTORY_RTOL
    out = tmp_path / "rows.json"
    assert evaluate.main([*chip_smoke.TUNE_EVAL_ARGS, "--synthetic-size",
                          "32x48x16", "--device", "cpu", "--json",
                          str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["name"] for r in rows] == ["census-wta-sgm-tuned", "pyramid1"]
    assert rows[0]["penalty1"] > 0 and "penalty1" not in rows[1]
    assert chip_smoke.TUNE_RTOL == HISTORY_RTOL
