"""The JAX package's differential soak, on the port's plain chain.

``tests/test_differential_soak.py`` holds numpy oracle == XLA == Pallas
at seeded random geometries (``tests/torch_shapes.soak_geometry``, drawn
exactly as that file draws them: k 1-3, D 2-15, odd and even H and W).
Here the port's plain versions on the CPU take the same inputs:

* the chain, at every ``SOAK_SEEDS`` geometry: the SSD volume equals
  the oracle within the JAX file's rtol = atol = 1e-4 and JAX's volume
  bit for bit; the SGM volume equals JAX's bit for bit; WTA and DP over
  it equal the oracles' disparities (SGM oracle, WTA oracle, DP oracle)
  and JAX's exactly; Birchfield equals its oracle within 1e-4 and JAX's
  bit for bit;
* the integer matrix (uint8/int16 images x int32/float32 cost at seeds
  5, 19, 47, 73): the volume equals the oracle exactly, int32 max on
  every invalid cell, and JAX's bit for bit; WTA and DP over it equal
  the oracles and JAX;
* guided-filter aggregation at every soak CVF draw: the masked path
  against ``guided_filter_oracle`` within the JAX file's rtol = 5e-4,
  atol = 5e-5 and against JAX's masked ``use_mxu=False`` lowering; the
  wedge path against JAX's wedge path at wedge offset i % 3 for the i-th
  seed (each of 0, 1 and 2 at five or six geometries, which keeps the
  file's JAX compiles inside its time; the card holds the kernel at all
  three offsets at every geometry against this plain version).  Both
  bit for bit at D >= 9; below that within ``test_torch_cvf_masked``'s
  1e-5 / 1e-6, because XLA's CPU vectoriser leaves the products of a
  short D loop unfused at some widths (on the wedge path too, at D = 3
  and W = 28 or 24, up to 4.8e-7 absolute, as ``python -m
  tests.test_torch_soak`` prints).

``chip_smoke.py``'s ``check_soak`` holds the kernels against these plain
versions at the same geometries on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.ops import aggregation as jax_agg
from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu.ops import cvf as jax_cvf
from stereomatch_tpu.ops import disparity as jax_disp
from stereomatch_tpu_torch.ops import aggregation, cost, cvf, disparity

from .oracles import (birchfield_oracle, dynamic_programming_oracle,
                      guided_filter_oracle, sgm_oracle, ssd_oracle,
                      wta_oracle)
from .torch_shapes import (SOAK_INT_SEEDS, SOAK_SEEDS, soak_geometry,
                           soak_int_geometry)
from .torch_threads import one_torch_thread  # noqa: F401

INT32_MAX = np.iinfo(np.int32).max
MASKED_RTOL, MASKED_ATOL = 1e-5, 1e-6       # test_torch_cvf_masked's


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array))


def _close_to_oracle(got, ref, rtol, atol):
    mask = np.isfinite(ref)
    assert np.array_equal(mask, np.isfinite(got))
    np.testing.assert_allclose(got[mask], ref[mask], rtol=rtol, atol=atol)


def _equal_to_xla(got, want, max_disp):
    """Bit-equal to XLA's CPU result at D >= 9; below that, where XLA's
    vectoriser may leave products unfused, within MASKED_RTOL/ATOL."""
    if max_disp >= 9:
        np.testing.assert_array_equal(got, want)
    else:
        _close_to_oracle(got, want, MASKED_RTOL, MASKED_ATOL)


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_plain_chain_equals_oracles_and_jax(seed):
    c = soak_geometry(seed)
    kw = dict(max_disparity=c.max_disp, kernel_size=c.k)
    left, right = _t(c.left), _t(c.right)

    vol = cost.ssd_cost_volume(left, right, **kw).numpy()
    ref_vol = ssd_oracle(c.left, c.right, c.max_disp, c.k)
    _close_to_oracle(vol, ref_vol, 1e-4, 1e-4)
    np.testing.assert_array_equal(
        vol, np.asarray(jax_cost.ssd_cost_volume(c.left, c.right, **kw)))

    agg = aggregation.semiglobal_aggregate(_t(vol), left, penalty1=c.p1,
                                           penalty2=c.p2)
    agg_jax = np.asarray(jax_agg.semiglobal_aggregate(
        vol, c.left, penalty1=c.p1, penalty2=c.p2))
    np.testing.assert_array_equal(agg.numpy(), agg_jax)
    agg_o = sgm_oracle(ref_vol.astype(np.float32), c.left, c.p1, c.p2)

    wta = disparity.winner_takes_all(agg).numpy()
    np.testing.assert_array_equal(wta, wta_oracle(agg_o))
    np.testing.assert_array_equal(
        wta, np.asarray(jax_disp.winner_takes_all(agg_jax)))
    dp = disparity.dynamic_programming(agg).numpy()
    np.testing.assert_array_equal(dp, dynamic_programming_oracle(agg_o))
    np.testing.assert_array_equal(
        dp, np.asarray(jax_disp.dynamic_programming(agg_jax)))

    bvol = cost.birchfield_cost_volume(left, right,
                                       max_disparity=c.max_disp).numpy()
    boracle = birchfield_oracle(c.left, c.right, c.max_disp, 4)
    bmask = np.isfinite(boracle)
    np.testing.assert_allclose(bvol[bmask], boracle[bmask], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(bvol, np.asarray(
        jax_cost.birchfield_cost_volume(c.left, c.right,
                                        max_disparity=c.max_disp)))


@pytest.mark.parametrize("image_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("cost_dtype", ["int32", "float32"])
@pytest.mark.parametrize("seed", SOAK_INT_SEEDS)
def test_integer_matrix(image_dtype, cost_dtype, seed):
    left, right, d, k = soak_int_geometry(seed, image_dtype)
    tdt = getattr(torch, cost_dtype)
    vol = cost.ssd_cost_volume(_t(left), _t(right), max_disparity=d,
                               kernel_size=k, cost_dtype=tdt).numpy()
    assert vol.dtype == np.dtype(cost_dtype)
    np.testing.assert_array_equal(vol, np.asarray(jax_cost.ssd_cost_volume(
        left, right, max_disparity=d, kernel_size=k,
        cost_dtype=getattr(jnp, cost_dtype))))
    ref_vol = ssd_oracle(left, right, d, k)
    mask = np.isfinite(ref_vol)
    if cost_dtype == "int32":
        assert (vol[~mask] == INT32_MAX).all()
        np.testing.assert_array_equal(vol[mask],
                                      ref_vol[mask].astype(np.int64))
    else:
        assert np.array_equal(mask, np.isfinite(vol))
        np.testing.assert_array_equal(vol[mask], ref_vol[mask])

    oracle_vol = np.where(mask, ref_vol, np.inf)
    wta = disparity.winner_takes_all(_t(vol)).numpy()
    np.testing.assert_array_equal(wta, wta_oracle(oracle_vol))
    np.testing.assert_array_equal(
        wta, np.asarray(jax_disp.winner_takes_all(vol)))
    vol_f = vol.astype(np.float32)
    dp = disparity.dynamic_programming(_t(vol_f)).numpy()
    np.testing.assert_array_equal(dp, dynamic_programming_oracle(oracle_vol))
    np.testing.assert_array_equal(
        dp, np.asarray(jax_disp.dynamic_programming(vol_f)))


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_guided_filter_equals_oracle_and_jax(seed):
    c = soak_geometry(seed, cvf=True)
    kw = dict(max_disparity=c.max_disp, kernel_size=c.k)
    fkw = dict(radius=c.radius, eps=c.eps)
    vol = np.asarray(jax_cost.ssd_cost_volume(c.left, c.right, **kw))
    guide = _t(c.left)

    masked = cvf.guided_filter_aggregate(_t(vol), guide, **fkw).numpy()
    ref = guided_filter_oracle(vol, c.left, c.radius, c.eps)
    assert np.array_equal(np.isinf(masked), np.isinf(ref))
    _close_to_oracle(masked, ref, 5e-4, 5e-5)
    want = np.asarray(jax_cvf.guided_filter_aggregate(vol, c.left,
                                                      use_mxu=False, **fkw))
    _equal_to_xla(masked, want, c.max_disp)

    off = SOAK_SEEDS.index(seed) % 3
    wedge_vol = cost.ssd_cost_volume(_t(c.left), _t(c.right),
                                     disparity_offset=off, **kw)
    got = cvf.guided_filter_aggregate(wedge_vol, guide, wedge_offset=off,
                                      **fkw).numpy()
    _equal_to_xla(got, np.asarray(jax_cvf.guided_filter_aggregate(
        wedge_vol.numpy(), c.left, wedge_offset=off, use_mxu=False, **fkw)),
        c.max_disp)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_soak: the largest
    # distance between the port's CVF paths and JAX's use_mxu=False
    # lowering at each soak CVF draw with D < 9 (masked path, and the
    # wedge path at offsets 0, 1 and 2).
    for seed in SOAK_SEEDS:
        c = soak_geometry(seed, cvf=True)
        if c.max_disp >= 9:
            continue
        kw = dict(max_disparity=c.max_disp, kernel_size=c.k)
        fkw = dict(radius=c.radius, eps=c.eps)
        dists = []
        for off in (None, 0, 1, 2):
            vol = cost.ssd_cost_volume(_t(c.left), _t(c.right),
                                       disparity_offset=off or 0, **kw)
            got = cvf.guided_filter_aggregate(vol, _t(c.left),
                                              wedge_offset=off, **fkw).numpy()
            want = np.asarray(jax_cvf.guided_filter_aggregate(
                vol.numpy(), c.left, wedge_offset=off, use_mxu=False, **fkw))
            fin = np.isfinite(want)
            dists.append(float(np.abs(got[fin] - want[fin]).max()))
        print(f"seed {seed} {c.height}x{c.width} D={c.max_disp} "
              f"r={c.radius}: masked {dists[0]:.3g}, wedge offsets 0-2 "
              f"{[float(f'{x:.3g}') for x in dists[1:]]}")
