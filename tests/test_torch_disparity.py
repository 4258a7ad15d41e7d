"""The port's winner-takes-all against ``jnp.argmin``.

Exact equality: both are argmin over the disparity axis with ties broken
toward the lower disparity (winners_take_all.cu:29-37).
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.ops.disparity import winner_takes_all as jax_wta
from stereomatch_tpu_torch.disparity_reduce import WinnerTakesAll
from stereomatch_tpu_torch.ops.disparity import winner_takes_all
from stereomatch_tpu_torch.utils import validation


def test_distinct_values_match_jax():
    rng = np.random.default_rng(0)
    vol = rng.permutation(10 * 13 * 24).reshape(10, 13, 24).astype(np.float32)
    out = winner_takes_all(torch.from_numpy(vol))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_wta(vol)))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_ties_go_to_lower_disparity(levels):
    """Few distinct values: nearly every pixel has tied minima."""
    rng = np.random.default_rng(levels)
    vol = rng.integers(0, levels, (9, 11, 17)).astype(np.float32)
    out = winner_takes_all(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_wta(vol)))
    np.testing.assert_array_equal(out, np.argmin(vol, axis=2))


def test_inf_wedge_and_int32_volumes():
    vol = np.full((3, 5, 4), np.inf, np.float32)
    vol[..., 0] = 2.0
    vol[1, 3, 2] = 1.0
    np.testing.assert_array_equal(
        winner_takes_all(torch.from_numpy(vol)).numpy(),
        np.asarray(jax_wta(vol)))
    ivol = np.random.default_rng(1).integers(0, 9, (4, 6, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        WinnerTakesAll()(torch.from_numpy(ivol)).numpy(),
        np.asarray(jax_wta(ivol)))


def test_class_validates():
    with pytest.raises(validation.ShapeError):
        WinnerTakesAll()(torch.zeros((3, 4)))
    with pytest.raises(validation.DTypeError):
        WinnerTakesAll()(torch.zeros((3, 4, 5), dtype=torch.float64))
