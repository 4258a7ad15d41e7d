"""The port's 2-D tiles (``parallel/tiled2d.py``) against the JAX
package's ``make_tiled2d_estimate``, and the DP chunk forms they hand
across column tiles.

JAX's scene of ``tests/test_parallel.py`` (32x48, D=16, seed 3, two
frames): JAX's program over ``make_mesh_2d`` on the 8-device virtual
CPU mesh (``backend="xla"``), the port's over ``[torch.device("cpu")] *
8`` laid out by ``convert.mesh_2d_from_jax``.  The port's disparities
equal JAX's tiled program bit for bit for every cost at the covering
overlap and at a small one, with WTA and with DP over the (2, 2, 2) and
(2, 1, 4) grids, with CVF and with every post-processing flag of
``tests/test_parallel.py:559-739``; at the covering overlap they also
equal the port's single-device pipeline.  One exception, JAX's own: its
tiled program's sub-pixel step departs from its single-device step by a
last-place rounding (measured 1.9e-6 at 462 of 3072 pixels; its test
allows 1e-4), so there the port, which equals the single-device stages
bit for bit, is held to JAX's tiled output within that 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu.ops import disparity as jax_disparity
from stereomatch_tpu_torch import cli_common, convert
from stereomatch_tpu_torch.ops import disparity as port_disparity
from stereomatch_tpu_torch.ops import refine
from stereomatch_tpu_torch.parallel import (TILE_W_AXIS, make_mesh_2d,
                                            make_tiled2d_estimate)

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
CPU = torch.device("cpu")
COVER = 48              # max(H, W): every block's halo covers the image


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    return np.stack([left] * 2), np.stack([right] * 2)


def _meshes(grid):
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    nb, nt, nw = grid
    jax_mesh = jax_parallel.make_mesh_2d(n_batch=nb, n_tile=nt, n_tile_w=nw)
    return jax_mesh, convert.mesh_2d_from_jax(jax_mesh, [CPU] * 8)


def _both(pair, grid=(2, 2, 2), jax_backend="xla", **kw):
    jax_mesh, mesh = _meshes(grid)
    ref = jax_parallel.make_tiled2d_estimate(
        jax_mesh, max_disparity=D, backend=jax_backend,
        interpret=jax_backend == "pallas", **kw)(*pair)
    out = make_tiled2d_estimate(mesh, max_disparity=D, **kw)(*pair)
    assert out.device == CPU
    return np.asarray(ref), out.numpy()


def _single(pair, cost="ssd", aggregation="sgm", reducer="wta", **kw):
    """The port's single-device pipeline on the first frame."""
    pipe = cli_common.create_pipeline(cost, reducer, aggregation,
                                      max_disparity=D, device="cpu", **kw)
    return pipe.estimate(pair[0][0], pair[1][0]).numpy()


COSTS = {"ssd": dict(kernel_size=3), "ssd-texture": dict(kernel_size=3),
         "sad": dict(kernel_size=3), "ncc": dict(kernel_size=3),
         "census": {}, "birchfield": {}}


def test_mesh_layout():
    jax_mesh, mesh = _meshes((2, 2, 2))
    assert dict(mesh.shape) == dict(jax_mesh.shape) == {
        "batch": 2, "tile": 2, TILE_W_AXIS: 2}
    assert mesh.devices == (((CPU,) * 2,) * 2,) * 2
    assert make_mesh_2d([CPU] * 8, 1, 2, 4).shape == {
        "batch": 1, "tile": 2, TILE_W_AXIS: 4}
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh_2d([CPU] * 4, 2, 2, 2)
    with pytest.raises(ValueError, match="torch devices"):
        convert.mesh_2d_from_jax(jax_mesh, [CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh_2d()                   # no CPU fallback


@pytest.mark.parametrize("cost", COSTS)
def test_covering_overlap_equals_jax_and_the_single_device(pair, cost):
    """``tests/test_parallel.py:145,332,465``."""
    ref, out = _both(pair, cost=cost, overlap=COVER, **COSTS[cost])
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    pipe_kw = {"kernel_size": 3} if COSTS[cost] else {}
    np.testing.assert_array_equal(out[0], _single(pair, cost, **pipe_kw))
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.parametrize("cost", COSTS)
def test_small_overlap_equals_jax(pair, cost):
    """``tests/test_parallel.py:386``: a 6-pixel warm-up is JAX's tiled
    result bit for bit, and within JAX's 2% of one device."""
    ref, out = _both(pair, cost=cost, overlap=6, **COSTS[cost])
    np.testing.assert_array_equal(out, ref)
    pipe_kw = {"kernel_size": 3} if COSTS[cost] else {}
    assert np.mean(out[0] != _single(pair, cost, **pipe_kw)) < 0.02


@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 1, 4)])
@pytest.mark.parametrize("overlap", [COVER, 6])
def test_dp_exact_hand_off(pair, grid, overlap):
    """``tests/test_parallel.py:353``: the forward accumulator and the
    decided column cross the column tiles; exact at any W split."""
    ref, out = _both(pair, grid, kernel_size=3, overlap=overlap,
                     reducer="dynamic_programming")
    np.testing.assert_array_equal(out, ref)
    if overlap == COVER:
        np.testing.assert_array_equal(
            out[0], _single(pair, reducer="dyn", kernel_size=3))


def test_equals_jax_pallas_interpret(pair):
    """``tests/test_parallel.py:371``: JAX's Pallas SGM kernels in
    interpret mode on each extended tile."""
    ref, out = _both(pair, jax_backend="pallas", kernel_size=3,
                     overlap=COVER)
    np.testing.assert_array_equal(out, ref)


def test_cvf_is_exact(pair):
    """``tests/test_cvf.py:253``: 2r halos, +inf beyond the image, the
    masked filter: JAX's tiled result and the port's single-device
    masked filter."""
    ref, out = _both(pair, kernel_size=3, aggregation="cvf", cvf_radius=3)
    np.testing.assert_array_equal(out, ref)
    from stereomatch_tpu_torch.aggregation import CostFilter
    pipe = cli_common.create_pipeline("ssd", "wta", "cvf", max_disparity=D,
                                      device="cpu", kernel_size=3)
    pipe.aggregation = CostFilter(3, wedge_offset=None)
    single = pipe.estimate(pair[0][0], pair[1][0]).numpy()
    for b in range(2):
        np.testing.assert_array_equal(out[b], single)


POST = {
    "confidence": dict(min_confidence=0.05, overlap=COVER),
    "lr-check": dict(aggregation=None, lr_check=True),
    "speckle-background": dict(aggregation=None, speckle=True,
                               speckle_fill="background"),
    "speckle-zero-median": dict(overlap=COVER, speckle=True, median=True),
    "weighted-median": dict(aggregation=None, weighted_median=True,
                            wmf_sigma=0.1, wmf_window=5),
    "census-multiword": dict(cost="census", census_window=7,
                             aggregation=None),
}


@pytest.mark.parametrize("case", POST)
def test_post_processing_equals_jax(pair, case):
    kw = dict(POST[case])
    if kw.get("cost") != "census":
        kw["kernel_size"] = 3
    ref, out = _both(pair, **kw)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_lr_check_over_four_column_tiles(pair):
    """``tests/test_parallel.py:609``, (1, 2, 4): the (D-1)-column halos
    reach past the neighbouring tile; both frames equal the single-device
    stages."""
    ref, out = _both(pair, (1, 2, 4), kernel_size=3, aggregation=None,
                     lr_check=True)
    np.testing.assert_array_equal(out, ref)
    pipe = cli_common.create_pipeline("ssd", "wta", None, max_disparity=D,
                                      device="cpu", kernel_size=3)
    vol = pipe.cost(torch.from_numpy(pair[0][0]),
                    torch.from_numpy(pair[1][0]))
    disp = port_disparity.winner_takes_all(vol)
    mask = refine.left_right_consistency(
        disp, refine.right_disparity_from_volume(vol), 1, max_disparity=D)
    want = refine.fill_inconsistent(disp, mask).numpy()
    np.testing.assert_array_equal(out[0], want)
    np.testing.assert_array_equal(out[1], want)


def test_subpixel_equals_the_single_device_stages(pair):
    """``tests/test_parallel.py:559``: median, sub-pixel and speckle over
    the tiles equal the port's single-device stages bit for bit, and
    JAX's tiled program within its own 1e-4 (see the module
    docstring)."""
    kw = dict(kernel_size=3, overlap=COVER, median=True, subpixel=True,
              speckle=True)
    ref, out = _both(pair, **kw)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=D,
                                      device="cpu", kernel_size=3)
    left = torch.from_numpy(pair[0][0])
    agg = pipe.aggregation(pipe.cost(left, torch.from_numpy(pair[1][0])),
                           left)
    disp = refine.median_filter_3x3(port_disparity.winner_takes_all(agg))
    want = refine.subpixel_refine(agg, disp.clamp(0, D - 1))
    want = torch.where(refine.speckle_mask(want), want, 0.0).numpy()
    np.testing.assert_array_equal(out[0], want)
    np.testing.assert_array_equal(out[1], want)


def test_refusals_raise_as_jax(pair):
    jax_mesh, mesh = _meshes((2, 2, 2))
    for kw, match in ((dict(lr_check=True, lr_mode="mirror"), "volume"),
                      (dict(cost="nope"), "unknown cost"),
                      (dict(reducer="nope"), "unknown reducer"),
                      (dict(aggregation="nope"), "unknown aggregation"),
                      (dict(speckle_fill="nope"), "unknown fill")):
        with pytest.raises(ValueError, match=match):
            jax_parallel.make_tiled2d_estimate(jax_mesh, max_disparity=D,
                                               **kw)
        with pytest.raises(ValueError, match=match):
            make_tiled2d_estimate(mesh, max_disparity=D, **kw)
    left, right = pair
    for fn in (jax_parallel.make_tiled2d_estimate(jax_mesh, max_disparity=D,
                                                  kernel_size=3,
                                                  backend="xla"),
               make_tiled2d_estimate(mesh, max_disparity=D, kernel_size=3)):
        with pytest.raises(ValueError, match="not divisible"):
            fn(left[:, :, :45], right[:, :, :45])
    for fn in (jax_parallel.make_tiled2d_estimate(
                   jax_mesh, max_disparity=D, kernel_size=3, backend="xla",
                   aggregation="cvf", cvf_radius=9),
               make_tiled2d_estimate(mesh, max_disparity=D, kernel_size=3,
                                     aggregation="cvf", cvf_radius=9)):
        with pytest.raises(ValueError, match="halo rows/cols"):
            fn(left, right)
    with pytest.raises(ValueError, match="interpret"):
        make_tiled2d_estimate(mesh, max_disparity=D, interpret=True)


@pytest.mark.parametrize("splits", [(20,), (7, 30)])
def test_dp_chunk_forms_equal_jax(splits):
    """The plain chunk forms against JAX's ``dp_forward_chunk`` and
    ``dp_backward_chunk`` over a scanline split at ``splits``: the
    forward accumulator and the decided column handed chunk to chunk,
    and the chained walk equal to the whole-row DP."""
    rng = np.random.default_rng(5)
    vol = rng.random((6, 48, 9)).astype(np.float32)
    vol[:, :4, 5:] = np.inf
    edges = [0, *splits, 48]
    chunks = [vol[:, a:b] for a, b in zip(edges, edges[1:])]
    acc_j = acc_p = None
    ptrs = []
    for chunk in chunks:
        pj, acc_j = jax_disparity.dp_forward_chunk(chunk, acc_j)
        pp, acc_p = port_disparity.dp_forward_chunk(torch.from_numpy(chunk),
                                                    acc_p)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))
        ptrs.append((pj, pp))
    cur_j = jax_disparity.jnp.argmin(acc_j, axis=1).astype(np.int32)
    cur_p = port_disparity.dp_end_disparities(acc_p)
    parts = []
    for i in range(len(chunks) - 1, -1, -1):
        last = i == len(chunks) - 1
        dj, cur_j = jax_disparity.dp_backward_chunk(ptrs[i][0], cur_j,
                                                    emit_current=last)
        dp_, cur_p = port_disparity.dp_backward_chunk(ptrs[i][1], cur_p,
                                                      emit_current=last)
        np.testing.assert_array_equal(dp_.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(cur_p.numpy(), np.asarray(cur_j))
        parts.insert(0, dp_)
    whole = port_disparity.dynamic_programming(torch.from_numpy(vol))
    assert torch.equal(torch.cat(parts, dim=1), whole)
