"""The byte and operation counts behind ``chip_smoke.py``'s bounds.

``kernel_work`` gives each kernel's function bytes (each input read once,
each output written once) and its design bytes (what one launch per
traversal moves as the path runs it).  These are computed from shapes, so
they are held here on the CPU at the two geometries the script times.
"""

import importlib.util
from pathlib import Path

import pytest

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
