"""The port on the occluded synthetic scene, against the JAX package.

Counterpart of ``tests/test_occlusion.py`` on
``io.synthetic.stereo_pair_occluded``, whose two depth layers leave left
pixels with no right correspondence and an exact mask for them.  Each
step runs through the port's plain versions on the CPU and through the
JAX package's XLA functions on the same scene: the disparities of SSD
and census -> SGM -> WTA, the right-view disparity, the left-right mask,
the occlusion fill and the 3x3 median are bit-equal, and the port's
results also meet the JAX file's own quality bounds (matchable pixels in
single digits, failures concentrated on the occlusions, the LR check's
recall and false positives against the true mask, the fill's repair).
On the textured surface model the guided filter (the masked path, held
against JAX's ``use_mxu=False`` lowering, bit for bit) beats its
guide-blind ablation, as in the JAX file.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.io.synthetic import \
    stereo_pair_occluded as jax_stereo_pair_occluded
from stereomatch_tpu.ops import refine as jax_refine
from stereomatch_tpu.ops.aggregation import \
    semiglobal_aggregate as jax_semiglobal
from stereomatch_tpu.ops.cost import \
    census_hamming_cost_volume as jax_census
from stereomatch_tpu.ops.cost import ssd_cost_volume as jax_ssd
from stereomatch_tpu.ops.cvf import \
    guided_filter_aggregate as jax_guided_filter
from stereomatch_tpu.ops.disparity import winner_takes_all as jax_wta
from stereomatch_tpu_torch.io.synthetic import stereo_pair_occluded
from stereomatch_tpu_torch.ops import refine
from stereomatch_tpu_torch.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu_torch.ops.cost import (census_hamming_cost_volume,
                                            ssd_cost_volume)
from stereomatch_tpu_torch.ops.cvf import guided_filter_aggregate
from stereomatch_tpu_torch.ops.disparity import winner_takes_all

from .torch_threads import one_torch_thread  # noqa: F401

D = 16


@pytest.fixture(scope="module")
def scene():
    left, right, gt, occ = stereo_pair_occluded(64, 96, D, seed=3)
    assert 0.03 < occ.mean() < 0.3      # the mask is non-trivial
    return left, right, gt, occ


def _port_pipeline(cost):
    def fn(left, right):
        if cost == "ssd":
            vol = ssd_cost_volume(left, right, max_disparity=D,
                                  kernel_size=3)
        else:
            vol = census_hamming_cost_volume(left, right, max_disparity=D)
        return winner_takes_all(semiglobal_aggregate(vol, left))
    return fn


def _jax_pipeline(cost):
    def fn(left, right):
        if cost == "ssd":
            vol = jax_ssd(left, right, max_disparity=D, kernel_size=3)
        else:
            vol = jax_census(left, right, max_disparity=D)
        return jax_wta(jax_semiglobal(vol, left))
    return fn


def _valid(occ):
    valid = ~occ
    valid[:, :D] = False
    return valid


def _lr_steps(left, right):
    """(disparity, right disparity, LR mask) through the port and
    through JAX, SSD -> SGM -> WTA."""
    port_fn, jax_fn = _port_pipeline("ssd"), _jax_pipeline("ssd")
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    port = [port_fn(lt, rt), refine.right_disparity(port_fn, lt, rt)]
    port.append(refine.left_right_consistency(*port))
    want = [jax_fn(left, right), jax_refine.right_disparity(jax_fn, left,
                                                             right)]
    want.append(jax_refine.left_right_consistency(*want))
    return [p.numpy() for p in port], [np.asarray(w) for w in want]


@pytest.mark.parametrize("texture", ["noise", "textured"])
@pytest.mark.parametrize("seed", [3, 100])
def test_scene_equals_jax(texture, seed):
    got = stereo_pair_occluded(64, 96, D, seed=seed, texture=texture)
    want = jax_stereo_pair_occluded(64, 96, D, seed=seed, texture=texture)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cost", ["ssd", "census"])
def test_matchable_pixels_recovered(scene, cost):
    left, right, gt, occ = scene
    disp = _port_pipeline(cost)(torch.from_numpy(left),
                                torch.from_numpy(right)).numpy()
    np.testing.assert_array_equal(
        disp, np.asarray(_jax_pipeline(cost)(left, right)))
    valid = _valid(occ)
    bad_valid = np.mean((np.abs(disp - gt) > 1)[valid])
    bad_occ = np.mean((np.abs(disp - gt) > 1)[occ])
    assert bad_valid < 0.08             # matchable: single digits
    assert bad_occ > 2 * bad_valid      # failure concentrates on occlusion


def test_lr_check_detects_true_occlusion(scene):
    left, right, gt, occ = scene
    port, want = _lr_steps(left, right)
    for got, ref in zip(port, want):
        np.testing.assert_array_equal(got, ref)
    mask = port[2]
    recall = np.mean(~mask[occ])
    false_pos = np.mean(~mask[_valid(occ)])
    assert recall > 0.6
    assert false_pos < 0.08


def test_occlusion_fill_repairs_occluded_regions(scene):
    left, right, gt, occ = scene
    (disp, _, mask), _ = _lr_steps(left, right)
    filled = refine.fill_inconsistent(torch.from_numpy(disp),
                                      torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        filled, np.asarray(jax_refine.fill_inconsistent(disp, mask)))

    def bad_occ(d):
        return np.mean((np.abs(d - gt) > 1)[occ])

    assert bad_occ(filled) < 0.6 * bad_occ(disp)
    np.testing.assert_array_equal(filled[mask], disp[mask])

    smoothed = refine.median_filter_3x3(torch.from_numpy(filled)).numpy()
    np.testing.assert_array_equal(
        smoothed, np.asarray(jax_refine.median_filter_3x3(filled)))
    assert np.mean((np.abs(smoothed - gt) > 1)[_valid(occ)]) < 0.08


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_textured_guided_filter_beats_guide_blind(seed):
    """On the textured model the guide-aware CVF has fewer bad pixels
    than its guide-blind ablation (eps = 1e6) on each seed (JAX's file
    pins the three seeds' sum), with every disparity map bit-equal to
    JAX's."""
    left, right, gt, occ = stereo_pair_occluded(64, 96, D, seed=seed,
                                                texture="textured")
    vol = census_hamming_cost_volume(torch.from_numpy(left),
                                     torch.from_numpy(right),
                                     max_disparity=D)
    jax_vol = np.asarray(jax_census(left, right, max_disparity=D))
    np.testing.assert_array_equal(vol.numpy(), jax_vol)
    bad = {}
    for eps in (1e-4, 1e6):
        disp = winner_takes_all(guided_filter_aggregate(
            vol, torch.from_numpy(left), radius=4, eps=eps)).numpy()
        want = np.asarray(jax_wta(jax_guided_filter(
            jax_vol, left, radius=4, eps=eps, use_mxu=False)))
        np.testing.assert_array_equal(disp, want)
        bad[eps] = (np.abs(disp - gt)[~occ] > 1).sum()
    assert bad[1e-4] < bad[1e6]


def test_textured_rejects_unknown_model():
    with pytest.raises(ValueError, match="texture model"):
        stereo_pair_occluded(32, 48, 8, texture="marble")
