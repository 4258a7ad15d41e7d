"""The plain reference agrees with the program's plain path on the CPU
at a small size, stage by stage and end to end, for the benchmark's
configuration and a census one."""

import numpy as np
import pytest
import torch

from portbench import reference, registry, scenes
from stereomatch_tpu_torch.cli_common import create_pipeline
from stereomatch_tpu_torch.ops import aggregation as port_sgm
from stereomatch_tpu_torch.ops import cost as port_cost

TEDDY = registry.find_cell("teddy-ssd-sgm.stream8").config
# A census configuration of the kind the reference also models
# (pixelwise census, 8-path SGM with Hamming-unit penalties, WTA).
CENSUS = dict(TEDDY, name="census-sgm", estimator=dict(
    cost="census", census_window=7, kernel_size=1, aggregation="sgm",
    penalty1=7.0, penalty2=86.0, reducer="wta", cost_dtype="float32"))
CONFIGS = {"teddy-ssd-sgm": TEDDY, "census-sgm": CENSUS}
H, W, D = 40, 72, 24


def small(name):
    return dict(CONFIGS[name], height=H, width=W, max_disparity=D)


def images(seed, n=2):
    pairs = scenes.pool(seed, n, H, W, D)
    left = torch.stack([torch.from_numpy(p.left) for p in pairs]).float()
    right = torch.stack([torch.from_numpy(p.right) for p in pairs]).float()
    return left, right


def test_ssd_volume_equals_the_port():
    left, right = images(11)
    ours = reference.ssd_volume(left, right, D, 7)
    for b in range(2):
        theirs = port_cost.ssd_cost_volume(left[b], right[b],
                                           max_disparity=D, kernel_size=7)
        assert torch.equal(ours[b], theirs)


def test_census_volume_equals_the_port():
    left, right = images(12)
    ours = reference.census_volume(left, right, D, 7)
    for b in range(2):
        theirs = port_cost.census_hamming_cost_volume(
            left[b], right[b], max_disparity=D, window_size=7)
        assert torch.equal(ours[b], theirs)


@pytest.mark.parametrize("p1, p2", [(0.1, 0.2), (7.0, 86.0),
                                    (6502.5, 3316275.0)])
def test_semiglobal_equals_the_port(p1, p2):
    left, right = images(13)
    cost = reference.ssd_volume(left, right, D, 3)
    ours = reference.semiglobal(cost, left, p1, p2)
    for b in range(2):
        theirs = port_sgm.semiglobal_aggregate(cost[b], left[b],
                                               penalty1=p1, penalty2=p2)
        assert torch.equal(ours[b], theirs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_disparities_equal_the_port_plain_path(name):
    config = small(name)
    opts = config["estimator"]
    left, right = images(2 ** 31 + 17, n=3)
    ours = reference.disparity(config, left, right).numpy()
    pipe = create_pipeline(
        opts["cost"], "wta", opts["aggregation"], max_disparity=D,
        penalty1=opts["penalty1"], penalty2=opts["penalty2"],
        census_window=opts.get("census_window", 5), backend="torch",
        device="cpu", kernel_size=opts["kernel_size"])
    for b in range(3):
        theirs = pipe.estimate(left[b], right[b]).numpy()
        assert ours.dtype == theirs.dtype == np.int32
        assert np.array_equal(ours[b], theirs)


def test_the_reference_refuses_what_it_does_not_model():
    config = dict(small("teddy-ssd-sgm"))
    config["estimator"] = dict(config["estimator"], subpixel=True)
    left, right = images(5, n=1)
    with pytest.raises(ValueError, match="subpixel"):
        reference.disparity(config, left, right)


def test_the_sgm_faults_change_the_reference():
    # The faults that portbench/faults.py plants in the reference's
    # place each give other answers than the reference at this size.
    config = small("teddy-ssd-sgm")
    left, right = images(2 ** 31 + 19, n=2)
    sound = reference.disparity(config, left, right)
    for sgm in ({"paths": reference.stereo.PATHS[:-1]},
                {"adaptive": False}):
        assert not torch.equal(
            reference.disparity(config, left, right, **sgm), sound), sgm


def test_wta_takes_the_first_least_cost():
    vol = torch.tensor([[[[3.0, 1.0, 1.0, float("inf")],
                          [float("inf"), 2.0, 0.5, 0.5]]]])
    assert reference.winner_takes_all(vol).tolist() == [[[1, 2]]]


def test_scenes_are_seeded_uint8_and_distinct():
    a = scenes.pool(2 ** 33 + 1, 3, H, W, D)
    b = scenes.pool(2 ** 33 + 1, 3, H, W, D)
    c = scenes.pool(-5, 3, H, W, D)
    assert all(p.left.dtype == np.uint8 and p.left.shape == (H, W)
               for p in a)
    assert all(np.array_equal(x.left, y.left) and
               np.array_equal(x.right, y.right) for x, y in zip(a, b))
    assert not np.array_equal(a[0].left, a[1].left)
    assert not np.array_equal(a[0].left, c[0].left)
