"""The port's scanline DP reducer against the JAX package.

The same numpy volumes, made from a seed, go through JAX's
``dynamic_programming`` (the XLA scan, the semantic oracle), its Pallas
kernels in interpret mode (``dynamic_programming_pallas``, as
tests/test_dp_pallas.py runs them) and the port's plain version
(``stereomatch_tpu_torch.ops.disparity``), which is the oracle of the
CUDA kernels in ``ops/dp_cuda.py``.  The DP is exact comparisons and one
float32 add per step, so every comparison is bit-equality: disparities,
int8 back-pointers and final-column costs.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                           dynamic_programming_with_paths)
from stereomatch_tpu.ops.dp_pallas import dynamic_programming_pallas
from stereomatch_tpu_torch.disparity_reduce import DynamicProgramming
from stereomatch_tpu_torch.ops import disparity as port

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_shapes import DP_RAMP_CASES, ramp_cost_volume

D = STM_MAX_DISPARITY


def _ssd_volume(seed):
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=seed)
    return np.array(ssd_cost_volume(left, right, max_disparity=D,
                                    kernel_size=3))


def _permutation_volume():
    """All-distinct costs: any tie-break divergence changes the result."""
    rng = np.random.default_rng(0)
    height, width = 16, 24
    return rng.permutation(height * width * D).reshape(
        height, width, D).astype(np.float32)


def _constant_volume():
    """Uniform costs: every step ties."""
    return np.ones((12, 20, D), np.float32)


def _wedge_volume():
    """Random costs with the +inf wedge x < d of the cost producers."""
    rng = np.random.default_rng(8)
    vol = rng.random((14, 30, 20), np.float32)
    x, d = np.meshgrid(np.arange(30), np.arange(20), indexing="ij")
    vol[:, x < d] = np.inf
    return vol


VOLUMES = {
    "ssd_seed5": lambda: _ssd_volume(5),
    "ssd_seed11": lambda: _ssd_volume(11),
    "ssd_seed23": lambda: _ssd_volume(23),
    "distinct": _permutation_volume,
    "constant": _constant_volume,
    "inf_wedge": _wedge_volume,
}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_dp_bit_equal_to_xla_and_pallas(name):
    vol = VOLUMES[name]()
    ref = np.asarray(dynamic_programming(vol))
    pallas = np.asarray(dynamic_programming_pallas(vol, interpret=True))
    out = port.dynamic_programming(torch.from_numpy(vol))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pallas)


@pytest.mark.parametrize("name", ["ssd_seed5", "distinct", "inf_wedge"])
def test_dp_with_paths_equals_jax(name):
    vol = VOLUMES[name]()
    ref_disp, ref_path, ref_final = dynamic_programming_with_paths(vol)
    disp, path, final = port.dynamic_programming_with_paths(
        torch.from_numpy(vol))
    assert path.dtype == torch.int8 and tuple(path.shape) == vol.shape
    assert final.dtype == torch.float32
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref_path))
    np.testing.assert_array_equal(final.numpy(), np.asarray(ref_final))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(ref_disp))
    assert (path[:, 0] == 0).all()


def test_single_column_and_single_disparity():
    rng = np.random.default_rng(3)
    for shape in [(5, 1, 7), (6, 9, 1)]:
        vol = rng.random(shape, np.float32)
        np.testing.assert_array_equal(
            port.dynamic_programming(torch.from_numpy(vol)).numpy(),
            np.asarray(dynamic_programming(vol)))


def test_reducer_class_on_cpu_and_its_backends():
    vol = torch.from_numpy(_ssd_volume(5))
    ref = port.dynamic_programming(vol)
    assert torch.equal(DynamicProgramming()(vol), ref)
    assert torch.equal(DynamicProgramming(backend="torch")(vol), ref)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DynamicProgramming(backend="cuda")(vol)
    assert torch.equal(DynamicProgramming()(vol.to(torch.int32)),
                       port.dynamic_programming(vol.to(torch.int32)))


def _longest_run(disp):
    """The longest run of equal non-zero steps along W in any row."""
    best = 0
    for steps in np.diff(disp.astype(np.int64), axis=1):
        run = 0
        for i, step in enumerate(steps):
            run = run + 1 if step != 0 and i and step == steps[i - 1] else (
                int(step != 0))
            best = max(best, run)
    return best


@pytest.mark.parametrize("case", DP_RAMP_CASES, ids=str)
def test_dp_on_ramp_volumes_equals_xla_and_pallas(case):
    """The ramp volumes that push the card's windowed walk to its window's
    edge: the plain DP (the kernels' oracle on the card) equals JAX's XLA
    scan and its Pallas kernels, pointers and final costs included, and
    the walk does move one step a column for runs past a 32-step batch
    (or across the whole band when D < 33) and saturates at a band edge."""
    vol = ramp_cost_volume(*case)
    ref_disp, ref_path, ref_final = dynamic_programming_with_paths(vol)
    pallas = np.asarray(dynamic_programming_pallas(vol, interpret=True))
    disp, path, final = port.dynamic_programming_with_paths(
        torch.from_numpy(vol))
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref_path))
    np.testing.assert_array_equal(final.numpy(), np.asarray(ref_final))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(ref_disp))
    np.testing.assert_array_equal(disp.numpy(), pallas)
    max_disp = case[2]
    out = disp.numpy()
    assert _longest_run(out) >= min(33, max_disp - 1)
    assert out.min() == 0 or out.max() == max_disp - 1
