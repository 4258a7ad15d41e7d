"""The port's coarse-to-fine pyramid (``stereomatch_tpu_torch/pyramid.py``)
against the JAX package's ``pyramid.py`` (its XLA path), on the CPU.

Every result is compared bit for bit: ``downsample2`` (row-major block
sums, then 1/4: one unit in the last place could flip a coarse census
bit), the band stage (integer Hamming planes, first-minimum argmin, the
winner's neighbours, the float32 vertex) over band windows 1, 3 and 5,
sub-pixel, the winning cost, ``row_valid``, anchors past both band ends
and columns with no valid candidate; ``PyramidPipeline`` at levels 1-3
on float32 and bf16 coarse volumes, sizes that need padding, median on
and off; and ``convert.pyramid_from_jax``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu import pyramid as jax_pyramid
from stereomatch_tpu_torch import convert, pyramid
from stereomatch_tpu_torch.io.synthetic import stereo_pair

from .torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("h,w", [(33, 47), (1, 1), (64, 96), (188, 226)])
def test_downsample2_bit_equal(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.random((2 * h, 2 * w)).astype(np.float32)
    x.flat[:4] = [1e-38, 3.4e38, 1 - 2 ** -24, 0.1]
    want = np.asarray(jax_pyramid.downsample2(jnp.asarray(x)))
    np.testing.assert_array_equal(
        pyramid.downsample2(torch.from_numpy(x)).numpy(), want)
    # Batched stacks pool each frame alone.
    np.testing.assert_array_equal(
        pyramid.downsample2(torch.from_numpy(np.stack([x, x])))[1].numpy(),
        want)


def test_upsample2_nearest_equal():
    d = np.random.default_rng(3).integers(0, 16, (7, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        pyramid.upsample2_nearest(torch.from_numpy(d)).numpy(),
        np.asarray(jax_pyramid.upsample2_nearest(jnp.asarray(d))))


@pytest.fixture(scope="module")
def band_scene():
    left, right, gt = stereo_pair(30, 44, 24, seed=9)
    rng = np.random.default_rng(4)
    pred = np.clip(gt + rng.integers(-3, 4, gt.shape), 0, 23)
    pred[:, :6] = 23                  # band past the left columns: x < base
    pred[:3] = 0                      # band clipped at d = 0
    pred[-3:] = 40                    # band clipped at the top of the range
    return left, right, pred.astype(np.int32)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("best_cost", [False, True])
def test_band_refine_census_bit_equal(band_scene, k, subpixel, best_cost):
    left, right, pred = band_scene
    kw = dict(band_radius=3, max_disparity=24, window_size=5,
              band_kernel_size=k, subpixel=subpixel,
              return_best_cost=best_cost)
    want = jax_pyramid.band_refine_census(jnp.asarray(left),
                                          jnp.asarray(right),
                                          jnp.asarray(pred), **kw)
    got = pyramid.band_refine_census(torch.from_numpy(left),
                                     torch.from_numpy(right),
                                     torch.from_numpy(pred), **kw)
    if not best_cost:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Columns left of every band candidate fall back to d = x.
    disp = got[0].numpy()
    assert np.array_equal(np.round(disp[10, :3]), np.arange(3))


@pytest.mark.parametrize("k", [3, 5])
def test_band_refine_row_valid(band_scene, k):
    """Rows flagged invalid contribute the box's zero padding, as the
    sharded band stage marks rows past the true image edge."""
    left, right, pred = band_scene
    row_valid = np.ones(left.shape[0], bool)
    row_valid[:2] = row_valid[-4:] = False
    kw = dict(band_radius=4, max_disparity=24, band_kernel_size=k,
              subpixel=True)
    want = jax_pyramid.band_refine_census(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(pred),
        row_valid=jnp.asarray(row_valid), **kw)
    got = pyramid.band_refine_census(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(pred), row_valid=torch.from_numpy(row_valid), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_refine_wide_band_and_radius_past_range(band_scene):
    """A band wider than the range (base clipped to 0) and radius 0."""
    left, right, pred = band_scene
    for r in (0, 15):
        kw = dict(band_radius=r, max_disparity=24, band_kernel_size=3)
        want = jax_pyramid.band_refine_census(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(pred), **kw)
        got = pyramid.band_refine_census(
            torch.from_numpy(left), torch.from_numpy(right),
            torch.from_numpy(pred), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_band_refine_refuses_multiword_census(band_scene):
    left, right, pred = band_scene
    with pytest.raises(ValueError, match="5x5"):
        pyramid.band_refine_census(torch.from_numpy(left),
                                   torch.from_numpy(right),
                                   torch.from_numpy(pred), band_radius=2,
                                   max_disparity=24, window_size=7)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_pipeline_bit_equal(levels, dtype):
    left, right, _ = stereo_pair(45, 67, 32, seed=levels)    # padded
    kw = dict(levels=levels, band_radius=5)
    jax_pipe = jax_pyramid.PyramidPipeline(
        32, cost_dtype=getattr(jnp, dtype), backend="xla", **kw)
    pipe = pyramid.PyramidPipeline(32, cost_dtype=dtype, device="cpu", **kw)
    got = pipe.estimate(left, right)
    assert got.dtype == torch.int32 and tuple(got.shape) == left.shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pipe.estimate(left, right)))
    refined = pipe.estimate_refined(left, right)
    assert refined.dtype == torch.float32
    np.testing.assert_array_equal(
        refined.numpy(), np.asarray(jax_pipe.estimate_refined(left, right)))


@pytest.mark.parametrize("median,band_kernel_size", [(False, 5), (True, 1)])
def test_pyramid_options_bit_equal(median, band_kernel_size):
    left, right, _ = stereo_pair(40, 56, 16, seed=12)
    kw = dict(levels=1, band_radius=4, median=median, penalty1=0.3,
              penalty2=0.9, band_kernel_size=band_kernel_size)
    want = jax_pyramid.PyramidPipeline(16, backend="xla", **kw).estimate(
        left, right)
    got = pyramid.PyramidPipeline(16, device="cpu", **kw).estimate(
        torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pyramid_from_jax_carries_every_setting():
    jax_pipe = jax_pyramid.PyramidPipeline(
        32, levels=2, band_radius=7, window_size=3, band_kernel_size=3,
        penalty1=0.4, penalty2=0.8, cost_dtype=jnp.bfloat16, median=False,
        backend="xla")
    pipe = convert.pyramid_from_jax(jax_pipe, device="cpu")
    for name in ("max_disparity", "levels", "band_radius", "window_size",
                 "band_kernel_size", "penalty1", "penalty2", "median"):
        assert getattr(pipe, name) == getattr(jax_pipe, name), name
    assert pipe.cost_dtype == torch.bfloat16
    assert convert.pyramid_from_jax(jax_pipe).device == "cuda"
    left, right, _ = stereo_pair(32, 48, 32, seed=5)
    np.testing.assert_array_equal(pipe.estimate(left, right).numpy(),
                                  np.asarray(jax_pipe.estimate(left, right)))


def test_validation_and_default_device():
    with pytest.raises(ValueError):
        pyramid.PyramidPipeline(16, levels=0)
    with pytest.raises(ValueError):
        pyramid.PyramidPipeline(18, levels=2)
    with pytest.raises(ValueError):
        pyramid.PyramidPipeline(16, backend="pallas")
    with pytest.raises(ValueError):
        pyramid.PyramidPipeline(16, cost_dtype="int32")
    pipe = pyramid.PyramidPipeline(16)
    assert pipe.device == "cuda"
    if not torch.cuda.is_available():
        # No silent fallback: without a card the default refuses to run.
        left, right, _ = stereo_pair(16, 32, 16, seed=1)
        with pytest.raises((RuntimeError, AssertionError)):
            pipe.estimate(left, right)
    with pytest.raises(ValueError):
        pyramid.PyramidPipeline(16, device="cpu").estimate(
            np.zeros((8, 8), np.float32), np.zeros((8, 9), np.float32))
