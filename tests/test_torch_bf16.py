"""bfloat16 volume storage in the port against the JAX package.

JAX's XLA path is the oracle: bf16 there is float32 compute with one
rounding at each stage's end (the cost's ``astype``, SGM's and CVF's
final cast; the DP widens first).  The port's plain versions round at
the same places, so their volumes equal XLA's bit for bit (compared as
uint16 patterns) and their disparities pixel for pixel.  JAX's Pallas
SGM rounds after every pass instead, so the port is held to it only by
``tests/test_bf16.py``'s own bound, and the bf16 pipelines to f32's
accuracy on synthetic scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli
from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu.ops import aggregation as jax_agg
from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu.ops import cvf as jax_cvf
from stereomatch_tpu.ops import disparity as jax_disp
from stereomatch_tpu.ops.sgm_pallas import semiglobal_aggregate_pallas
from stereomatch_tpu_torch import cli_common, convert
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import aggregation as port_agg
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.ops import cvf as port_cvf
from stereomatch_tpu_torch.ops import disparity as port_disp
from stereomatch_tpu_torch.parallel import ShardedPipeline

from .torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _bits(x) -> np.ndarray:
    """The uint16 patterns of a bf16 JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == BF16
        return x.view(torch.int16).numpy().view(np.uint16)
    assert x.dtype == jnp.bfloat16
    return np.asarray(x).view(np.uint16)


def _assert_bits_equal(ref, out):
    ref_bits, out_bits = _bits(ref), _bits(out)
    assert ref_bits.shape == out_bits.shape
    assert int((ref_bits != out_bits).sum()) == 0


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w), np.float32),
            rng.random((h, w), np.float32))


# (H, W, D, k): k = 1, 3 and 7; odd and even D; W < D.
COST_SHAPES = [(13, 20, 37, 1), (24, 40, 16, 3), (9, 12, 30, 7),
               (16, 33, 24, 7), (11, 27, 9, 3)]


@pytest.mark.parametrize("shape", COST_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["ssd", "sad", "census"])
def test_cost_volumes_bit_equal_to_xla(kind, shape):
    h, w, d, k = shape
    left, right = _images(h, w, h * w + d)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    if kind == "census":
        kw = dict(max_disparity=d, window_size=5, kernel_size=min(k, 3))
        ref = jax_cost.census_hamming_cost_volume(
            left, right, cost_dtype=jnp.bfloat16, **kw)
        out = port_cost.census_hamming_cost_volume(tl, tr, cost_dtype=BF16,
                                                   **kw)
    else:
        jf, pf = {"ssd": (jax_cost.ssd_cost_volume, port_cost.ssd_cost_volume),
                  "sad": (jax_cost.sad_cost_volume,
                          port_cost.sad_cost_volume)}[kind]
        kw = dict(max_disparity=d, kernel_size=k)
        ref = jf(left, right, cost_dtype=jnp.bfloat16, **kw)
        out = pf(tl, tr, cost_dtype=BF16, **kw)
    _assert_bits_equal(ref, out)
    assert torch.isinf(out.float()[:, 0, 1:]).all()


def test_bf16_images_widen_at_the_cost():
    """A bf16 image is widened to float32 at the cost's entry, as JAX
    widens it."""
    left, right = _images(12, 30, 1)
    left16 = jnp.asarray(left, jnp.bfloat16)
    right16 = jnp.asarray(right, jnp.bfloat16)
    ref = jax_cost.ssd_cost_volume(left16, right16, max_disparity=12,
                                   kernel_size=3, cost_dtype=jnp.bfloat16)
    out = port_cost.ssd_cost_volume(
        convert.tensor_from_jax(left16, "cpu"),
        convert.tensor_from_jax(right16, "cpu"), max_disparity=12,
        kernel_size=3, cost_dtype=BF16)
    _assert_bits_equal(ref, out)


def _bf16_volume(h, w, d, k, seed):
    """(left image, JAX bf16 SSD volume, the same volume as a tensor)."""
    left, right = _images(h, w, seed)
    vol = jax_cost.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k, cost_dtype=jnp.bfloat16)
    return left, vol, convert.tensor_from_jax(vol, "cpu")


@pytest.mark.parametrize("shape", [(24, 40, 16, 3), (13, 20, 37, 2),
                                   (9, 12, 30, 7)], ids=str)
def test_sgm_bit_equal_to_xla(shape):
    left, vol, tvol = _bf16_volume(*shape, seed=sum(shape))
    ref = jax_agg.semiglobal_aggregate(vol, left, penalty1=0.2, penalty2=0.9)
    out = port_agg.semiglobal_aggregate(tvol, torch.from_numpy(left),
                                        penalty1=0.2, penalty2=0.9)
    _assert_bits_equal(ref, out)


def test_sgm_chunks_of_a_bf16_volume_equal_the_float32_sweep():
    """The chunk sweep widens a bf16 cost and keeps float32 carries: its
    contributions equal those of the widened volume's."""
    _, _, tvol = _bf16_volume(20, 30, 12, 2, seed=4)
    image = torch.from_numpy(_images(20, 30, 4)[0])
    kw = dict(penalty1=0.1, penalty2=0.2)
    carry16 = carry32 = (None, None)
    for a, b in ((0, 7), (7, 20)):
        out16, carry16 = port_agg.sweep_chunk_with_carry(
            tvol[a:b], image[a:b], (1, 1), *carry16, seed=a == 0, **kw)
        out32, carry32 = port_agg.sweep_chunk_with_carry(
            tvol[a:b].float(), image[a:b], (1, 1), *carry32, seed=a == 0,
            **kw)
        assert out16.dtype == carry16[0].dtype == torch.float32
        assert torch.equal(out16, out32) and torch.equal(carry16[0],
                                                         carry32[0])


@pytest.mark.parametrize("radius", [0, 1, 2])
@pytest.mark.parametrize("shape,offset", [((24, 40, 16), 0),
                                          ((13, 29, 9), 0),
                                          ((17, 25, 8), 3)], ids=str)
def test_cvf_bit_equal_to_xla(shape, offset, radius):
    """The wedge filter on a bf16 census volume (and an offset wedge):
    float32 statistics, q rounded once.  Held bit-equal at r = 0 too,
    where the float32 filter takes a tolerance: the one rounding to bf16
    absorbs XLA's other fusion there at these shapes."""
    h, w, d = shape
    left, right = _images(h, w, h + d + radius)
    vol = jax_cost.census_hamming_cost_volume(left, right, max_disparity=d,
                                              cost_dtype=jnp.bfloat16)
    if offset:
        x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
        vol = jnp.where(jnp.asarray(x < dd + offset)[None], jnp.inf,
                        vol + 1).astype(jnp.bfloat16)
    kw = dict(radius=radius, eps=1e-4, wedge_offset=offset)
    ref = jax_cvf.guided_filter_aggregate(vol, left, use_mxu=False, **kw)
    out = port_cvf.guided_filter_aggregate(
        convert.tensor_from_jax(vol, "cpu"), torch.from_numpy(left), **kw)
    assert ref.dtype == jnp.bfloat16
    _assert_bits_equal(ref, out)


@pytest.mark.parametrize("kind", ["sgm", "ties"])
def test_reducers_equal_xla_on_bf16(kind):
    """WTA (argmin on the bf16 values) and DP (widened to float32) on an
    aggregated bf16 volume, and on a bf16 volume of many ties."""
    if kind == "sgm":
        left, vol, _ = _bf16_volume(24, 40, 16, 3, seed=9)
        vol = jax_agg.semiglobal_aggregate(vol, left)
    else:
        rng = np.random.default_rng(2)
        vol = jnp.asarray(rng.integers(0, 3, (16, 40, 33)), jnp.bfloat16)
    tvol = convert.tensor_from_jax(vol, "cpu")
    np.testing.assert_array_equal(port_disp.winner_takes_all(tvol).numpy(),
                                  np.asarray(jax_disp.winner_takes_all(vol)))
    np.testing.assert_array_equal(
        port_disp.dynamic_programming(tvol).numpy(),
        np.asarray(jax_disp.dynamic_programming(vol)))


def test_sgm_within_the_pallas_bound():
    """JAX's Pallas SGM (interpret mode) rounds after every pass; the
    port rounds once, as XLA does: under 5% of the disparities differ,
    tests/test_bf16.py's bound between Pallas bf16 and float32."""
    left, right, _ = stereo_pair(48, 64, 16, seed=21)
    vol = jax_cost.ssd_cost_volume(left, right, max_disparity=16,
                                   kernel_size=3, cost_dtype=jnp.bfloat16)
    ref = np.asarray(jax_disp.winner_takes_all(
        semiglobal_aggregate_pallas(vol, left, interpret=True)))
    out = port_disp.winner_takes_all(port_agg.semiglobal_aggregate(
        convert.tensor_from_jax(vol, "cpu"), torch.from_numpy(left)))
    assert np.mean(out.numpy() != ref) < 0.05


@pytest.mark.parametrize("cost,aggr,reducer", [
    ("ssd", "sgm", "wta"), ("ssd", "sgm", "dyn"), ("census", "cvf", "wta")])
def test_bf16_bad_pixel_within_one_point_of_float32(cost, aggr, reducer):
    """The end metric on synthetic scenes: bf16 storage costs at most one
    point of bad-pixel rate against float32."""
    d = 16
    for seed in (21, 5):
        left, right, gt = stereo_pair(48, 96, d, seed=seed)
        bad = {}
        for dtype in ("float32", "bfloat16"):
            pipe = cli_common.create_pipeline(cost, reducer, aggr,
                                              max_disparity=d,
                                              volume_dtype=dtype,
                                              device="cpu")
            if cost == "ssd":
                pipe.cost.kernel_size = 3
            disp = pipe.estimate(left, right).numpy()
            bad[dtype] = np.mean((np.abs(disp - gt) > 1)[:, d:])
        assert bad["bfloat16"] <= bad["float32"] + 0.01, bad


@pytest.mark.parametrize("cost,aggr,reducer", [
    ("ssd", "sgm", "wta"), ("sad", "sgm", "dyn"), ("census", "cvf", "wta"),
    ("ssd", None, "dyn")])
def test_convert_carries_a_jax_bf16_pipeline(cost, aggr, reducer):
    """A JAX bf16 pipeline crosses with its dtype and gives the same
    disparities (JAX's factory picks its own CVF lowering, within 1e-4 of
    XLA's use_mxu=False one that the port equals: a few pixels may
    differ there)."""
    left, right, _ = stereo_pair(32, 64, 16, seed=6)
    jax_pipe = jax_cli.create_pipeline(cost, reducer, aggr, max_disparity=16,
                                       volume_dtype="bfloat16")
    port = convert.pipeline_from_jax(jax_pipe, device="cpu")
    assert port.cost.cost_volume_dtype == BF16
    ref = np.asarray(jax_pipe.estimate(left, right))
    out = port.estimate(left, right).numpy()
    assert port._aggregation_volume.dtype == BF16
    limit = 0.01 if aggr == "cvf" else 0.0
    assert np.mean(out != ref) <= limit


def test_tensor_from_jax_keeps_every_bf16_pattern():
    bits = np.arange(0, 1 << 16, dtype=np.uint16)
    arr = jnp.asarray(bits.view(jnp.bfloat16))
    t = convert.tensor_from_jax(arr, "cpu")
    assert t.dtype == BF16
    np.testing.assert_array_equal(_bits(t), bits)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    jax_mesh = jax_parallel.make_mesh(jax.devices()[:8], n_batch=2)
    return jax_mesh, convert.mesh_from_jax(jax_mesh,
                                           [torch.device("cpu")] * 8)


@pytest.mark.parametrize("sgm_mode", ["exact", "overlap"])
@pytest.mark.parametrize("reducer", ["wta", "dynamic_programming"])
def test_sharded_bf16_equals_single_device_and_tracks_jax(meshes, sgm_mode,
                                                          reducer):
    """bf16 over the 8-CPU mesh (2 frames x 4 tiles of 8 rows): each
    tile's sum rounded once, so the port equals its single-device bf16
    pipeline at every pixel; JAX's bf16 ShardedPipeline (XLA) within 2%."""
    jax_mesh, mesh = meshes
    left, right, _ = stereo_pair(32, 48, 16, seed=3)
    kw = dict(kernel_size=3, aggregation="sgm", reducer=reducer,
              sgm_mode=sgm_mode, overlap=32)
    out = ShardedPipeline(mesh, 16, cost_dtype="bfloat16", **kw).estimate(
        np.stack([left] * 2), np.stack([right] * 2)).numpy()
    single = cli_common.create_pipeline(
        "ssd", "dyn" if reducer != "wta" else "wta", "sgm", max_disparity=16,
        volume_dtype="bfloat16", device="cpu")
    single.cost.kernel_size = 3
    want = single.estimate(left, right).numpy()
    np.testing.assert_array_equal(out, np.stack([want] * 2))
    ref = np.asarray(jax_parallel.ShardedPipeline(
        jax_mesh, 16, cost_dtype=jnp.bfloat16, backend="xla", **kw).estimate(
            np.stack([left] * 2), np.stack([right] * 2)))
    assert np.mean(out != ref) < 0.02


def test_sharded_pipeline_from_jax_keywords_in_bf16(meshes):
    """The same keywords on both sides, a JAX dtype included."""
    _, mesh = meshes
    left, right, _ = stereo_pair(32, 48, 16, seed=8)
    out = ShardedPipeline(mesh, 16, kernel_size=3,
                          cost_dtype=jnp.bfloat16).estimate(left, right)
    assert out.dtype == torch.int32 and tuple(out.shape) == (32, 48)


@pytest.mark.parametrize("height,width,d,aggregation,want", [
    (375, 450, 128, "sgm", "float32"), (480, 640, 64, "sgm", "float32"),
    (720, 1280, 64, "sgm", "bfloat16"), (480, 640, 256, "sgm", "bfloat16"),
    (720, 1280, 128, "sgm", "bfloat16"), (1024, 1280, 256, "sgm", "bfloat16"),
    (1080, 1920, 256, "sgm", "bfloat16"), (1024, 1280, 256, "cvf", "float32"),
    (375, 450, 128, "cvf", "float32"), (1080, 1920, 256, None, "float32")])
def test_recommended_dtype_follows_the_card(height, width, d, aggregation,
                                            want):
    """bf16 for SGM from a volume of 1280x720x64 cells up, where it
    measured faster on the H100 (VGA at D=256 too, 720p at D=64 too);
    float32 where the two measured level (the JAX package's rule,
    measured on the TPU, is not carried over)."""
    got = cli_common.recommended_dtype(height, width, aggregation,
                                       max_disparity=d)
    assert got == want and got in cli_common.VOLUME_DTYPES
    pipe = cli_common.create_pipeline("ssd", "wta", aggregation,
                                      max_disparity=8, volume_dtype=got,
                                      device="cpu")
    assert pipe.cost.cost_volume_dtype == cli_common.VOLUME_DTYPES[want]
