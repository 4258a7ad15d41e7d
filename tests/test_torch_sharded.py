"""The port's row-sharded pipeline against the JAX package's.

Both pipelines are built from one kwargs dict, on the scene of
``tests/test_parallel.py`` (32x48, D=16, 2 frames): JAX's over the
8-device virtual CPU mesh, the port's over ``make_mesh([cpu] * 8,
n_batch=2)`` (2 frames x 4 tiles), laid out by ``convert.mesh_from_jax``.
Exact hand-off and an overlap that covers every predecessor must give
the same disparities as JAX's ``ShardedPipeline(backend="xla")`` and the
same SGM volume as the port's single-device aggregation, bit for bit.

The post-processing flags run over the row tiles on two distinct frames
and equal the port's single-device ``estimate_refined`` (then
``filter_speckles``) at every pixel, which equals the JAX package's
single-device result bit for bit.  Against JAX's sharded program they
are equal too, except where that program itself departs from JAX's
single-device pipeline: by a last-place rounding after the sub-pixel
step (measured 1.9e-6) and after the smoother's cross-tile column solves
(measured 7.0e-5; its docstring bounds it by 4e-4).  There the port is
held to JAX's sharded output within that documented 4e-4.
"""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli_common
from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu.ops import refine as jax_refine
from stereomatch_tpu.parallel.mesh import batch_tile_axes as jax_axes
from stereomatch_tpu_torch import cli_common, convert
from stereomatch_tpu_torch.ops import aggregation as port_agg
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.ops import refine as port_refine
from stereomatch_tpu_torch.parallel import (ShardedPipeline, batch_tile_axes,
                                            halo, initialize_distributed,
                                            make_hybrid_mesh, make_mesh,
                                            sharded)

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    return np.stack([left] * 2), np.stack([right] * 2)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return jax_parallel.make_mesh(jax.devices()[:8], n_batch=2)


@pytest.fixture(scope="module")
def mesh(jax_mesh):
    return convert.mesh_from_jax(jax_mesh, [CPU] * 8)


def _both(jax_mesh, mesh, pair, jax_backend="xla", **kw):
    left, right = pair
    ref = jax_parallel.ShardedPipeline(jax_mesh, D, backend=jax_backend,
                                       interpret=jax_backend == "pallas",
                                       **kw).estimate(left, right)
    out = ShardedPipeline(mesh, D, **kw).estimate(left, right)
    assert out.dtype == torch.int32 and out.device == CPU
    return np.asarray(ref), out.numpy()


def _single(pair, reducer="wta", cost="ssd"):
    left, right = pair
    pipe = cli_common.create_pipeline(cost, reducer, "sgm", max_disparity=D,
                                      device="cpu")
    if cost != "census":
        pipe.cost.kernel_size = 3
    return pipe.estimate(left[0], right[0]).numpy()


def test_batch_tile_axes_and_mesh_layout(jax_mesh, mesh):
    for n in range(1, 17):
        assert batch_tile_axes(n) == jax_axes(n)
        for n_batch in (1, 2, 4):
            if n % n_batch == 0:
                assert batch_tile_axes(n, n_batch) == jax_axes(n, n_batch)
    with pytest.raises(ValueError):
        batch_tile_axes(8, n_batch=3)
    assert dict(mesh.shape) == dict(jax_mesh.shape) == {"batch": 2,
                                                        "tile": 4}
    assert mesh.devices == ((CPU,) * 4,) * 2
    assert make_mesh([CPU] * 8, n_tile=8).shape == {"batch": 1, "tile": 8}
    assert make_mesh([CPU]).shape == {"batch": 1, "tile": 1}
    with pytest.raises(ValueError, match="torch devices"):
        convert.mesh_from_jax(jax_mesh, [CPU] * 4)
    with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
        make_hybrid_mesh()
    with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
        initialize_distributed()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()                  # no CPU fallback


def test_halo_exchange_matches_the_whole_axis():
    """Every pull equals the rows of the whole (zero-padded) tensor."""
    whole = torch.arange(4 * 5 * 3, dtype=torch.float32).reshape(20, 3) + 1
    blocks = list(whole.split(5))
    padded = torch.cat([torch.zeros(12, 3), whole, torch.zeros(12, 3)])
    for count in (1, 5, 12):
        prev = halo.pull_from_prev_multi(blocks, count)
        nxt = halo.pull_from_next_multi(blocks, count)
        for t in range(4):
            start = 12 + 5 * t
            assert torch.equal(prev[t], padded[start - count:start])
            assert torch.equal(nxt[t], padded[start + 5:start + 5 + count])
    assert all(torch.equal(a, b) for a, b in zip(
        halo.pull_from_prev(blocks, 2), halo.pull_from_prev_multi(blocks, 2)))
    assert all(torch.equal(a, b) for a, b in zip(
        halo.pull_from_next(blocks, 2), halo.pull_from_next_multi(blocks, 2)))
    with pytest.raises(ValueError, match="_multi"):
        halo.pull_from_prev(blocks, 6)
    for t, ext in enumerate(halo.pad_with_halos(blocks, 3, 2)):
        assert torch.equal(ext, padded[12 + 5 * t - 3:12 + 5 * t + 7])
        mask = halo.out_of_image_mask(t, 4, 5, 3, 2)
        assert torch.equal(mask, (padded[12 + 5 * t - 3:12 + 5 * t + 7, 0]
                                  == 0))


@pytest.mark.parametrize("reducer", ["wta", "dynamic_programming"])
@pytest.mark.parametrize("sgm_mode", ["exact", "overlap"])
def test_disparities_equal_jax_xla(jax_mesh, mesh, pair, sgm_mode, reducer):
    ref, out = _both(jax_mesh, mesh, pair, kernel_size=3, aggregation="sgm",
                     reducer=reducer, sgm_mode=sgm_mode, overlap=32)
    np.testing.assert_array_equal(out, ref)
    single = _single(pair, "wta" if reducer == "wta" else "dyn")
    for b in range(2):
        np.testing.assert_array_equal(out[b], single)


@pytest.mark.parametrize("sgm_mode,overlap", [("exact", 0), ("overlap", 24),
                                              ("overlap", 100)])
def test_sharded_volume_bit_equal_to_single_device(pair, sgm_mode, overlap):
    """The cost crop and the sharded SGM volume against the port's own
    single-device plain versions, for an exact hand-off and for overlaps
    that cover every predecessor (24 = 3 tiles of 8 rows; 100 is
    clamped to 24)."""
    left = torch.from_numpy(pair[0][0])
    right = torch.from_numpy(pair[1][0])
    vol = port_cost.ssd_cost_volume(left, right, max_disparity=D,
                                    kernel_size=3)
    lefts, rights = list(left.split(8)), list(right.split(8))
    blocks = sharded.local_cost(
        lefts, rights,
        lambda lp, rp: port_cost.ssd_cost_volume(lp, rp, max_disparity=D,
                                                 kernel_size=3), 3, 2)
    assert torch.equal(torch.cat(blocks), vol)
    out = sharded.sharded_semiglobal(blocks, lefts, penalty1=0.1,
                                     penalty2=0.2, mode=sgm_mode,
                                     overlap=overlap)
    assert torch.equal(torch.cat(out),
                       port_agg.semiglobal_aggregate(vol, left))


def test_exact_equals_jax_pallas_interpret(jax_mesh, mesh, pair):
    """JAX's exact hand-off through the Pallas chunk kernel (K5), in
    interpret mode."""
    ref, out = _both(jax_mesh, mesh, pair, jax_backend="pallas",
                     kernel_size=3, aggregation="sgm", reducer="wta",
                     sgm_mode="exact")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("cost,aggregation", [("sad", "sgm"),
                                              ("census", "sgm"),
                                              ("census", None)])
def test_sad_and_census_costs_equal_jax(jax_mesh, mesh, pair, cost,
                                        aggregation):
    window = {} if cost == "census" else dict(kernel_size=3)
    ref, out = _both(jax_mesh, mesh, pair, cost=cost, aggregation=aggregation,
                     reducer="wta", sgm_mode="exact", **window)
    np.testing.assert_array_equal(out, ref)
    if aggregation:
        np.testing.assert_array_equal(out[0], _single(pair, cost=cost))


def test_small_overlap_close_and_equal_to_jax(jax_mesh, mesh, pair):
    """4 warm-up rows do not cover the predecessors: not exact, but under
    5% of pixels may differ (tests/test_parallel.py's bound), and the
    port runs JAX's computation, so the two agree exactly."""
    ref, out = _both(jax_mesh, mesh, pair, kernel_size=3, aggregation="sgm",
                     reducer="wta", sgm_mode="overlap", overlap=4)
    np.testing.assert_array_equal(out, ref)
    assert np.mean(out[0] != _single(pair)) < 0.05


def test_single_tile_mesh_and_schedules(pair):
    left, right = pair
    single = _single(pair)
    one = ShardedPipeline(make_mesh([CPU]), D, kernel_size=3)
    assert one.mesh.shape == {"batch": 1, "tile": 1}
    np.testing.assert_array_equal(one.estimate(left[0], right[0]).numpy(),
                                  single)
    mesh = make_mesh([CPU] * 4, n_tile=4)
    for schedule in ("auto", "wavefront", "naive"):
        pipe = ShardedPipeline(mesh, D, kernel_size=3, sgm_schedule=schedule)
        np.testing.assert_array_equal(pipe.estimate(left, right).numpy(),
                                      np.stack([single] * 2))


def test_divisibility_and_shape_errors(mesh, pair):
    left, right = pair
    pipe = ShardedPipeline(mesh, D, kernel_size=3)
    with pytest.raises(ValueError, match="not divisible"):
        pipe.estimate(np.stack([left[0]] * 3), np.stack([right[0]] * 3))
    with pytest.raises(ValueError, match="not divisible"):
        pipe.estimate(left[:, :30], right[:, :30])
    with pytest.raises(ValueError, match="shape"):
        pipe.estimate(left, right[:, :, :40])


@pytest.mark.parametrize("kwargs,item", [
    (dict(sgm_mode="auto"), "A.14"),
    (dict(aggregation="cvf"), "A.9"),
    (dict(cost="birchfield"), None),
    (dict(cost="ncc"), None),
    (dict(cost="ssd-texture"), None)],
    # The ids the cases had while the A.8 costs were refused.
    ids=["{'sgm_mode': 'auto'}-A.14", "{'aggregation': 'cvf'}-A.9",
         "{'cost': 'birchfield'}-A.8", "{'cost': 'ncc'}-A.8",
         "{'cost': 'ssd-texture'}-A.8"])
def test_refused_options_name_their_roadmap_item(jax_mesh, mesh, pair,
                                                 kwargs, item):
    """sgm_mode="auto" (A.14) and sharded CVF (A.9) refuse naming their
    item; the A.8 costs, refused until they were ported, run and equal
    JAX's sharded pipeline."""
    if item is None:
        ref, out = _both(jax_mesh, mesh, pair, aggregation="sgm",
                         reducer="wta", **kwargs)
        np.testing.assert_array_equal(out, ref)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ShardedPipeline(mesh, D, **kwargs)


@pytest.mark.parametrize("cost", ["birchfield", "ncc", "ssd-texture"])
@pytest.mark.parametrize("reducer", ["wta", "dynamic_programming"])
def test_cost_families_equal_the_single_device(pair, cost, reducer):
    """Row-sharded Birchfield (no halo), ZNCC (halos, row mask, gathered
    image sums) and SSD over textures (float32 SSD with halos) over 4
    tiles: each tile's volume the rows of the single-device volume, and
    the disparities the single device's, bit for bit."""
    left, right = pair
    mesh4 = make_mesh([CPU] * 4, n_tile=4)
    out = ShardedPipeline(mesh4, D, cost=cost, reducer=reducer,
                          kernel_size=3).estimate(left[0], right[0])
    single = cli_common.create_pipeline(
        cost, "wta" if reducer == "wta" else "dyn", "sgm", max_disparity=D,
        device="cpu")
    inner = getattr(single.cost, "cost_function", single.cost)
    inner.kernel_size = 3
    np.testing.assert_array_equal(out.numpy(),
                                  single.estimate(left[0],
                                                  right[0]).numpy())
    lefts = list(torch.from_numpy(left[0]).split(8))
    rights = list(torch.from_numpy(right[0]).split(8))
    if cost == "ncc":
        vols = sharded.local_zncc(lefts, rights, max_disparity=D,
                                  kernel_size=3, cost_dtype=torch.float32)
    else:
        fn = (port_cost.birchfield_cost_volume if cost == "birchfield"
              else port_cost.ssd_cost_volume)
        halo_rows = (0, 0) if cost == "birchfield" else (3, 2)
        vols = sharded.local_cost(
            lefts, rights, lambda l, r: fn(l, r, max_disparity=D,
                                           kernel_size=3), *halo_rows)
    assert torch.equal(torch.cat(vols), single._cost_volume)


def test_sharded_kernel_size_defaults_follow_jax(pair):
    """kernel_size None: 4 for Birchfield, 1 for census, 7 otherwise."""
    left, right = pair
    mesh2 = make_mesh([CPU] * 2, n_tile=2)
    for cost, k in (("birchfield", 4), ("ncc", 7), ("ssd-texture", 7)):
        out = ShardedPipeline(mesh2, D, cost=cost,
                              aggregation=None).estimate(left[0], right[0])
        single = cli_common.create_pipeline(cost, "wta", max_disparity=D,
                                            device="cpu")
        inner = getattr(single.cost, "cost_function", single.cost)
        assert inner.kernel_size == k
        np.testing.assert_array_equal(out.numpy(), single.estimate(
            left[0], right[0]).numpy())
    with pytest.raises(ValueError, match="int32"):
        ShardedPipeline(mesh2, D, cost="ncc", aggregation=None,
                        cost_dtype="int32")


@pytest.mark.parametrize("kwargs", [
    dict(cost="sdd"), dict(reducer="dyn"), dict(aggregation="sgn"),
    dict(sgm_mode="halo"), dict(sgm_schedule="fast"), dict(backend="xla"),
    dict(cost="census", kernel_size=3), dict(interpret=True),
    dict(cost_dtype="int32"), dict(cost_dtype="float16")],
    ids=lambda v: str(v))
def test_invalid_options_raise_value_error(mesh, kwargs):
    with pytest.raises(ValueError):
        ShardedPipeline(mesh, D, **kwargs)


@pytest.mark.parametrize("cost_dtype", ["bfloat16", torch.bfloat16],
                         ids=["name", "torch"])
@pytest.mark.parametrize("reducer", ["wta", "dynamic_programming"])
def test_bf16_cost_dtype_runs(mesh, pair, cost_dtype, reducer):
    """cost_dtype bfloat16 (refused until bf16 storage was ported): the
    tiles' volumes and SGM blocks are bf16, the disparities int32."""
    left, right = pair
    pipe = ShardedPipeline(mesh, D, kernel_size=3, cost_dtype=cost_dtype,
                           reducer=reducer)
    out = pipe.estimate(left, right)
    assert out.dtype == torch.int32 and tuple(out.shape) == left.shape
    lefts = list(torch.from_numpy(left[0]).split(8))
    rights = list(torch.from_numpy(right[0]).split(8))
    vols = sharded.local_cost(
        lefts, rights,
        lambda lp, rp: port_cost.ssd_cost_volume(
            lp, rp, max_disparity=D, kernel_size=3,
            cost_dtype=torch.bfloat16), 3, 2)
    assert all(v.dtype == torch.bfloat16 for v in vols)
    aggs = sharded.sharded_semiglobal(vols, lefts, penalty1=0.1,
                                      penalty2=0.2)
    assert all(a.dtype == torch.bfloat16 for a in aggs)


def test_int32_cost_only_path_and_backend_cuda_refuses_cpu(mesh, pair):
    left, right = pair
    left8, right8 = (left * 255).astype(np.uint8), (right * 255).astype(
        np.uint8)
    pipe = ShardedPipeline(mesh, D, kernel_size=3, cost_dtype=np.int32,
                           aggregation=None)
    single = cli_common.create_pipeline("ssd", "wta", max_disparity=D,
                                        volume_dtype="int32", device="cpu")
    single.cost.kernel_size = 3
    np.testing.assert_array_equal(
        pipe.estimate(left8, right8).numpy()[1],
        single.estimate(left8[1], right8[1]).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ShardedPipeline(mesh, D, kernel_size=3, backend="cuda").estimate(
            left, right)


# The sharded post-processing keywords of each case.
POST_PROCESSING = {
    "median": dict(median=True),
    "subpixel": dict(subpixel=True),
    "lr_check": dict(lr_check=True),
    "lr_check_volume": dict(lr_check=True, lr_mode="volume", lr_max_diff=0),
    "weighted_median": dict(weighted_median=True, wmf_sigma=0.1),
    "fgs_lambda": dict(fgs_lambda=16.0, fgs_sigma=0.08),
    "fgs_lambda_lr": dict(fgs_lambda=16.0, fgs_sigma=0.08, lr_check=True),
    "min_confidence": dict(min_confidence=0.1),
    "speckle": dict(speckle=True),
    "speckle_background": dict(speckle=True, speckle_fill="background"),
    "all": dict(lr_check=True, weighted_median=True, wmf_sigma=0.1,
                median=True, subpixel=True, min_confidence=0.05,
                speckle=True),
}
# JAX's sharded program departs from its single-device pipeline after
# these stages (see the module docstring); its documented bound.
JAX_SHARDED_DEPARTS = ("subpixel", "fgs_lambda")
JAX_SHARDED_BOUND = 4e-4


@pytest.fixture(scope="module")
def frames():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    other_left, other_right, _ = synthetic_stereo_pair(32, 48, D, seed=8)
    return np.stack([left, other_left]), np.stack([right, other_right])


def _single_refined(create_pipeline, frames, kw, speckle_filter, to_numpy):
    """Each frame through the single-device estimate_refined (then the
    speckle filter) with the sharded keywords' meaning."""
    flags = {k: v for k, v in kw.items() if not k.startswith("speckle")}
    flags.setdefault("median", False)
    flags.setdefault("subpixel", False)
    if "lr_max_diff" in flags:
        flags["max_diff"] = flags.pop("lr_max_diff")
    pipe = create_pipeline()
    pipe.cost.kernel_size = 3
    out = []
    for left, right in zip(*frames):
        disp = pipe.estimate_refined(left, right, **flags)
        if kw.get("speckle"):
            disp = speckle_filter(disp, fill=kw.get("speckle_fill", "zero"))
        out.append(to_numpy(disp))
    return np.stack(out)


@pytest.mark.parametrize("name", POST_PROCESSING)
def test_post_processing_equals_single_device_and_jax(jax_mesh, mesh, frames,
                                                      name):
    kw = POST_PROCESSING[name]
    out = ShardedPipeline(mesh, D, kernel_size=3, **kw).estimate(*frames)
    single = _single_refined(
        lambda: cli_common.create_pipeline("ssd", "wta", "sgm",
                                           max_disparity=D, device="cpu"),
        frames, kw, port_refine.filter_speckles, lambda t: t.numpy())
    assert out.numpy().dtype == single.dtype
    np.testing.assert_array_equal(out.numpy(), single)
    jax_single = _single_refined(
        lambda: jax_cli_common.create_pipeline("ssd", "wta", "sgm",
                                               max_disparity=D),
        frames, kw, jax_refine.filter_speckles, np.asarray)
    np.testing.assert_array_equal(single, jax_single)
    ref = np.asarray(jax_parallel.ShardedPipeline(
        jax_mesh, D, kernel_size=3, backend="xla", **kw).estimate(*frames))
    assert ref.dtype == single.dtype
    if any(key in kw for key in JAX_SHARDED_DEPARTS):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=JAX_SHARDED_BOUND)
    else:
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", ["median", "weighted_median", "fgs_lambda_lr",
                                  "speckle_background", "all"])
def test_post_processing_halos_span_tiles(frames, name):
    """8 tiles of 4 rows: the speckle window's 4-row halos reach across a
    whole tile, the smoother chains through 8 tiles; every pixel equals
    the single-device result."""
    kw = POST_PROCESSING[name]
    pipe = ShardedPipeline(make_mesh([CPU] * 8, n_tile=8), D, kernel_size=3,
                           **kw)
    single = _single_refined(
        lambda: cli_common.create_pipeline("ssd", "wta", "sgm",
                                           max_disparity=D, device="cpu"),
        frames, kw, port_refine.filter_speckles, lambda t: t.numpy())
    np.testing.assert_array_equal(pipe.estimate(*frames).numpy(), single)
