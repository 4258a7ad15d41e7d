"""The census + SGM cell: its plain reference, its faults, and its
parts found by name.

The reference (``portbench/reference/census_sgm.py``) is checked against
a census code counted by hand and a constant against an adaptive P2 on
a known step; each fault of ``portbench/census_faults.py`` is planted
under a run driven on the CPU at 24x48, D = 16, as
``test_portbench_faults.py`` drives its own, and must read above the
configuration's limit.
"""

import time

import pytest
import torch

from portbench import census_faults, registry, run
from portbench.reference import census_sgm, stereo

CELL = "kitti-census-sgm.stream8"
WINDOW = 12           # frames; every one is kept and judged


def small_cell():
    cell = registry.find_cell(CELL)
    return cell._replace(
        config=dict(cell.config, height=24, width=48, max_disparity=16),
        traffic=dict(cell.traffic, pool=6, batch=4))


def measure(cell, overrides=None, estimator_cls=None, seed=2 ** 31 + 77):
    return run.measure(cell, seed, 60.0, False, "cpu", time.perf_counter(),
                       frames=WINDOW, overrides=overrides,
                       estimator_cls=estimator_cls)


def test_a_9x7_code_counted_by_hand():
    # 7 rows by 9 columns around the centre (3, 4) of a 7x9 image: the
    # neighbours darker than the centre (value 50) set their bits, in
    # row-major order with the centre skipped.
    image = torch.full((7, 9), 100.0)
    image[3, 4] = 50.0
    darker = [(0, 0), (0, 8), (2, 3), (3, 3), (3, 5), (6, 8)]
    for y, x in darker:
        image[y, x] = 10.0
    want = 0
    for y, x in darker:
        k = y * 9 + x
        want |= 1 << (k - 1 if k > 3 * 9 + 4 else k)
    code = census_sgm.census_codes(image, 9, 7)
    assert int(code[3, 4]) == want
    assert bin(want).count("1") == len(darker)
    # Out of the image, neighbours read 0: none is darker than 0 and
    # all of them are darker than a bright corner.
    assert int(census_sgm.census_codes(torch.zeros(5, 5), 9, 7)[2, 2]) == 0
    corner = census_sgm.census_codes(torch.full((7, 9), 200.0), 9, 7)[0, 0]
    inside = 4 * 5 - 1                       # rows 0-3, columns 0-4
    assert bin(int(corner)).count("1") == 62 - inside


@pytest.mark.parametrize("window", [3, 5, 7])
def test_a_square_window_is_the_stereo_reference(window):
    image = torch.randint(0, 256, (11, 13), generator=torch.Generator()
                          .manual_seed(window)).to(torch.float32)
    assert torch.equal(census_sgm.census_codes(image, window, window),
                       stereo.census_codes(image, window))


def test_constant_and_adaptive_p2_on_a_known_step():
    # One row, two pixels, D = 3: the second pixel's path cost is
    # C + min(n[d], n[d +- 1] + P1, P2') over the first's normalised
    # costs n = (0, 40, 40).  Its intensity step |dI| = 20 makes the
    # adaptive P2' = max(10, 120 / 20) = 10, the constant one 120.
    cost = torch.tensor([[[[0.0, 40.0, 40.0], [0.0, 0.0, 0.0]]]])
    image = torch.tensor([[[0.0, 20.0]]])
    p1 = torch.tensor(10.0)
    p2 = torch.tensor(120.0)
    adaptive = stereo._path(cost, image, p1, p2, 0, 1, adaptive=True)
    constant = stereo._path(cost, image, p1, p2, 0, 1, adaptive=False)
    assert adaptive[0, 0, 1].tolist() == [0.0, 10.0, 10.0]
    assert constant[0, 0, 1].tolist() == [0.0, 10.0, 40.0]


def test_the_reference_refuses_what_it_does_not_model():
    config = dict(registry.find_cell(CELL).config)
    pair = torch.zeros(1, 8, 16), torch.zeros(1, 8, 16)
    for extra in ({"median": True}, {"cost": "ssd"}, {"kernel_size": 3},
                  {"reducer": "dynamic_programming"}):
        bad = dict(config, max_disparity=4,
                   estimator=dict(config["estimator"], **extra))
        with pytest.raises(ValueError):
            census_sgm.disparity(bad, *pair)


def test_the_cell_finds_its_configuration_reference_and_metrics():
    cell = registry.find_cell(CELL)
    assert cell.config["name"] == "kitti-census-sgm"
    assert cell.reference is not None
    assert cell.reference.__module__.endswith("census_sgm")
    assert {m.name for m in cell.end_to_end} == {
        "fps", "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert {"census_codes_window_ms", "census_hamming_window_ms",
            "cost_window_ms", "cost_roofline", "aggregation_window_ms",
            "device_idle_share", "program_ops_per_frame"} <= {
        m.name for m in cell.per_layer}
    estimator = cell.config["estimator"]
    assert (estimator["census_window"], estimator["census_height"],
            estimator["adaptive_p2"]) == (9, 7, False)


def test_a_sound_run_is_correct():
    record, checks, result = measure(small_cell())
    assert all(c.ok for c in checks), checks
    assert result["attempted"] == WINDOW and result["failed"] == 0
    assert max(record["mismatch_shares"]) == 0.0


@pytest.mark.parametrize("fault", census_faults.CENSUS_SGM)
def test_a_fault_is_not_correct(fault):
    cell = small_cell()
    record, checks, result = measure(
        cell, *census_faults.planted(fault, cell.config))
    worst = next(c for c in checks if c.name == "mismatch_worst")
    assert not worst.ok, (fault, checks)
    assert result["failed"] > 0


def test_the_reference_in_place_is_correct():
    cell = small_cell()
    _, checks, _ = measure(cell, estimator_cls=census_faults
                           .reference_in_place(cell.config))
    assert all(c.ok for c in checks), checks
