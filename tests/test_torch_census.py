"""The port's census transform and Hamming cost against the JAX package.

The same numpy images, made from a seed, go through
``stereomatch_tpu.ops.cost`` (XLA on the CPU) and the port's plain
PyTorch version.  Census codes and Hamming counts are integers and the
optional box sum of small integers is exact in float32, so every
comparison is bit-equality.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.cost import Census as JaxCensus
from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu_torch.cost import Census
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.utils import validation


@pytest.mark.parametrize("window", [3, 5, 7])
def test_census_transform_bit_equal(window):
    rng = np.random.default_rng(window)
    img = rng.random((23, 31), np.float32)
    img[5:9, 4:12] = 0.5                     # plateaus: ties set no bit
    ref = np.asarray(jax_cost.census_transform(img, window))
    out = port_cost.census_transform(torch.from_numpy(img), window)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    if window == 7:
        assert ref.shape == (23, 31, 2)      # 48 bits -> two words


def test_census_transform_rejects_even_windows():
    with pytest.raises(ValueError, match="odd"):
        port_cost.census_transform(torch.zeros(4, 4), 4)


def test_popcount_against_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(-2**31, 2**31, 200_000, dtype=np.int64)
    words = np.concatenate([words, [0, -1, -2**31, 2**31 - 1, 1]])
    words = words.astype(np.int32)
    want = np.bitwise_count(words.view(np.uint32)).astype(np.int32)
    out = port_cost.popcount32(torch.from_numpy(words))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("window,kernel_size", [(5, 1), (5, 3), (7, 1),
                                                (7, 3), (3, 1)])
def test_census_hamming_volume_bit_equal(window, kernel_size, dtype):
    rng = np.random.default_rng(window * 10 + kernel_size)
    left = rng.random((21, 37), np.float32)
    right = np.roll(left, -3, axis=1) + 0.01 * rng.random((21, 37),
                                                          np.float32)
    kw = dict(max_disparity=12, window_size=window, kernel_size=kernel_size)
    ref = np.asarray(jax_cost.census_hamming_cost_volume(
        left, right, cost_dtype=np.dtype(dtype), **kw))
    out = port_cost.census_hamming_cost_volume(
        torch.from_numpy(left), torch.from_numpy(right),
        cost_dtype=getattr(torch, dtype), **kw)
    assert str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(out.numpy(), ref)


def test_census_class_matches_jax_class():
    rng = np.random.default_rng(4)
    left = rng.random((18, 26), np.float32)
    right = rng.random((18, 26), np.float32)
    ref = np.asarray(JaxCensus(10, window_size=7, kernel_size=2)(left, right))
    out = Census(10, window_size=7, kernel_size=2)(torch.from_numpy(left),
                                                   torch.from_numpy(right))
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(validation.DTypeError):
        Census(10, cost_volume_dtype=torch.float64)
    with pytest.raises(ValueError, match="positive"):
        Census(0)
