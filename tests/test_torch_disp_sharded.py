"""The port's disparity-block partitioner (``parallel/disp_sharded.py``)
against the JAX package's ``make_disp_sharded_wta``.

JAX's scene of ``tests/test_parallel.py`` (32x48, seed 3): JAX's blocks
over ``make_disp_mesh(n_disp=8)`` on the 8-device virtual CPU mesh, the
port's over ``[torch.device("cpu")] * 8``, laid out by
``convert.disp_mesh_from_jax``.  For every cost, with and without the
guided filter, the port's disparities equal JAX's and the port's
single-device ``winner_takes_all`` of the whole volume bit for bit
(``tests/test_parallel.py:162,291,481``, ``tests/test_cvf.py:271``; on
the CPU each block is filtered by the masked path, as JAX filters it).
The cross-block reduction gives the lowest disparity among tied blocks
and 0 where every block is +inf.  JAX's refusals are kept, with the
same exception types (``tests/test_cvf.py:286``).
"""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu_torch import convert
from stereomatch_tpu_torch.aggregation import CostFilter
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.ops.disparity import winner_takes_all
from stereomatch_tpu_torch.parallel import (DISP_AXIS, disp_sharded,
                                            make_disp_mesh,
                                            make_disp_sharded_wta)

from .conftest import synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
D_TOTAL = 32


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(32, 48, 16, seed=3)
    return left, right


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return jax_parallel.make_disp_mesh(n_disp=8)


@pytest.fixture(scope="module")
def mesh(jax_mesh):
    return convert.disp_mesh_from_jax(jax_mesh, [CPU] * 8)


def _single(left, right, cost, aggregation, **kw):
    """The port's single-device volume -> (masked CVF) -> WTA."""
    left_t, right_t = torch.from_numpy(left), torch.from_numpy(right)
    k = kw.get("kernel_size")
    if cost in ("ssd", "ssd-texture", "sad"):
        fn = (port_cost.sad_cost_volume if cost == "sad"
              else port_cost.ssd_cost_volume)
        vol = fn(left_t, right_t, max_disparity=D_TOTAL, kernel_size=k)
    elif cost == "ncc":
        vol = port_cost.zncc_cost_volume(left_t, right_t,
                                         max_disparity=D_TOTAL,
                                         kernel_size=k)
    elif cost == "census":
        vol = port_cost.census_hamming_cost_volume(left_t, right_t,
                                                   max_disparity=D_TOTAL)
    else:
        vol = port_cost.birchfield_cost_volume(left_t, right_t,
                                               max_disparity=D_TOTAL)
    if aggregation == "cvf":
        vol = CostFilter(3, wedge_offset=None)(vol, left_t)
    return winner_takes_all(vol).numpy()


def test_mesh_layout(jax_mesh, mesh):
    assert dict(mesh.shape) == dict(jax_mesh.shape) == {DISP_AXIS: 8}
    assert mesh.devices == (CPU,) * 8
    assert make_disp_mesh([CPU] * 8, n_disp=4).shape == {DISP_AXIS: 4}
    with pytest.raises(ValueError, match="torch devices"):
        convert.disp_mesh_from_jax(jax_mesh, [CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_disp_mesh()                 # no CPU fallback


@pytest.mark.parametrize("aggregation", [None, "cvf"])
@pytest.mark.parametrize("cost", ["ssd", "ssd-texture", "sad", "ncc",
                                  "census", "birchfield"])
def test_disparities_equal_jax_and_the_single_device(jax_mesh, mesh, pair,
                                                     cost, aggregation):
    left, right = pair
    kw = dict(cost=cost, aggregation=aggregation, max_disparity=D_TOTAL)
    if cost in ("ssd", "ssd-texture", "sad", "ncc"):
        kw["kernel_size"] = 3
    if aggregation:
        kw["cvf_radius"] = 3
    ref = np.asarray(jax_parallel.make_disp_sharded_wta(jax_mesh, **kw)(
        left, right))
    out = make_disp_sharded_wta(mesh, **kw)(left, right)
    assert out.dtype == torch.int32 and out.device == CPU
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), _single(left, right, **kw))


def test_bf16_and_int32_blocks_equal_jax(jax_mesh, mesh, pair):
    left, right = pair
    for dtype, jax_dtype in ((torch.bfloat16, "bfloat16"),
                             (torch.int32, "int32")):
        import jax.numpy as jnp
        kw = dict(max_disparity=D_TOTAL, kernel_size=3)
        l8 = (left * 255).astype(np.int32) if dtype == torch.int32 else left
        r8 = (right * 255).astype(np.int32) if dtype == torch.int32 \
            else right
        ref = np.asarray(jax_parallel.make_disp_sharded_wta(
            jax_mesh, cost_dtype=jnp.dtype(jax_dtype), **kw)(l8, r8))
        out = make_disp_sharded_wta(mesh, cost_dtype=dtype, **kw)(l8, r8)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_ties_across_blocks_and_all_inf_pixels():
    """The cross-block rule on hand-made block maps: a minimum shared by
    blocks 1 and 3 goes to block 1's disparity, and a pixel that is +inf
    in every block to 0, as ``torch.argmin`` of the whole volume."""
    inf = float("inf")
    vol = torch.tensor([[[5.0, 2.0, 1.0, 3.0, 1.0, 1.0, 4.0, 2.0],
                         [inf] * 8,
                         [3.0, 0.0, 7.0, 0.0, 0.0, 9.0, 0.0, 8.0],
                         [inf, inf, 6.0, 6.0, inf, 6.0, 6.0, inf]]])
    parts = [(torch.amin(b, dim=2),
              torch.argmin(b, dim=2).to(torch.int32) + 2 * i)
             for i, b in enumerate(vol.split(2, dim=2))]
    got = disp_sharded.global_argmin(parts)
    assert torch.equal(got, winner_takes_all(vol))
    assert got.tolist() == [[2, 0, 1, 2]]


def test_periodic_scene_ties_go_to_the_lowest_block(mesh):
    """A period-4 scene shifted by 2 matches exactly at d = 2, 6, 10, ...:
    every tie across the blocks of two disparities goes to d = 2 (block
    1), as on one device."""
    x = np.arange(64)
    row = np.array([0.1, 0.7, 0.3, 0.9], np.float32)[x % 4]
    left = np.tile(row[2:50], (16, 1)).astype(np.float32)
    right = np.tile(row[:48], (16, 1)).astype(np.float32)
    out = make_disp_sharded_wta(make_disp_mesh([CPU] * 8), max_disparity=16,
                                kernel_size=1)(left, right)
    want = winner_takes_all(port_cost.ssd_cost_volume(
        torch.from_numpy(left), torch.from_numpy(right), max_disparity=16,
        kernel_size=1))
    assert torch.equal(out, want)
    assert bool((out[:, 2:] == 2).all())


REFUSALS = [
    (dict(cost="sgm-cost"), "unknown cost"),
    (dict(aggregation="sgm"), "disparity .*sharding supports"),
    (dict(aggregation="dp"), "disparity .*sharding supports"),
    (dict(max_disparity=20), "not divisible by disp axis"),
]


@pytest.mark.parametrize("kw,match", REFUSALS,
                         ids=["cost", "sgm", "dp", "D%n"])
def test_refusals_raise_as_jax(jax_mesh, mesh, kw, match):
    kw = {"max_disparity": D_TOTAL, **kw}
    with pytest.raises(ValueError, match=match):
        jax_parallel.make_disp_sharded_wta(jax_mesh, **kw)
    with pytest.raises(ValueError, match=match):
        make_disp_sharded_wta(mesh, **kw)


def test_call_time_refusals_raise_as_jax(jax_mesh, mesh, pair):
    """H % n (JAX slices its output rows over the blocks) and ZNCC past
    W + 1: both at the call."""
    left, right = pair
    for fn in (jax_parallel.make_disp_sharded_wta(jax_mesh,
                                                  max_disparity=D_TOTAL),
               make_disp_sharded_wta(mesh, max_disparity=D_TOTAL)):
        with pytest.raises(ValueError, match="height 30 not divisible"):
            fn(left[:30], right[:30])
    narrow = left[:, :23], right[:, :23]
    for fn in (jax_parallel.make_disp_sharded_wta(
                   jax_mesh, max_disparity=D_TOTAL, cost="ncc",
                   kernel_size=3),
               make_disp_sharded_wta(mesh, max_disparity=D_TOTAL,
                                     cost="ncc", kernel_size=3)):
        with pytest.raises(ValueError, match="W \\+ 1"):
            fn(*narrow)


def test_block_wedge_filter_equals_the_full_wedge_filter():
    """The card's per-block filter: each block's guided filter on its
    wedge ``x < d + offset`` (the CVF kernels' path, here their plain
    version) is the registry's single-device wedge filter restricted to
    the block, bit for bit."""
    from stereomatch_tpu_torch.ops import cvf
    left, right, _ = synthetic_stereo_pair(40, 64, 32, seed=11)
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    for volume in (port_cost.census_hamming_cost_volume,
                   port_cost.ssd_cost_volume):
        full = cvf.guided_filter_aggregate(
            volume(left, right, max_disparity=32), left, radius=4,
            wedge_offset=0)
        blocks = [cvf.guided_filter_aggregate(
                      volume(left, right, max_disparity=8,
                             disparity_offset=o), left, radius=4,
                      wedge_offset=o)
                  for o in (0, 8, 16, 24)]
        assert torch.equal(torch.cat(blocks, dim=2), full)
