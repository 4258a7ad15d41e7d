"""The port's texture sampler (``stereomatch_tpu_torch/texture.py``)
against the JAX package's (``stereomatch_tpu/texture.py``): the same
images and coordinates, made from a numpy seed, through both.  Samples
are held bit for bit (the port copies XLA's fused multiply-adds of the
bilinear blend), and the contract errors are the same exceptions.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu import texture as jax_texture
from stereomatch_tpu_torch import texture

RNG = np.random.default_rng(12)


def _image(channels, dtype, shape=(16, 32)):
    img = RNG.random(shape + (channels,)) * 255
    return img.astype(dtype).squeeze(-1) if channels == 1 else \
        img.astype(dtype)


def _coords(shape=(23, 29), lo=-4.0, hi=40.0):
    xs = RNG.uniform(lo, hi, shape).astype(np.float32)
    ys = RNG.uniform(lo, hi * 0.6, shape).astype(np.float32)
    # Integer and half-integer coordinates hit the blend's exact weights.
    xs[0, :8] = [0, 0.5, 1, 1.5, 31, 31.5, 32, -0.5]
    return xs, ys


@pytest.mark.parametrize("mode", [texture.FilterMode.NEAREST,
                                  texture.FilterMode.LINEAR])
@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_sample_equals_jax(mode, channels, dtype):
    img = _image(channels, dtype)
    xs, ys = _coords()
    ref = jax_texture.TextureImage(img, filter_mode=mode).sample(xs, ys)
    out = texture.TextureImage(img, filter_mode=mode).sample(xs, ys)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", [texture.FilterMode.NEAREST,
                                  texture.FilterMode.LINEAR])
@pytest.mark.parametrize("normalized", [False, True])
def test_sample_grid_equals_jax(mode, normalized):
    img = _image(1, np.float32)
    ref = jax_texture.TextureImage(img, use_normalized_coords=normalized,
                                   filter_mode=mode).sample_grid()
    tex = texture.TextureImage(torch.from_numpy(img),
                               use_normalized_coords=normalized,
                               filter_mode=mode)
    out = tex.sample_grid()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if mode == texture.FilterMode.NEAREST and not normalized:
        np.testing.assert_array_equal(out.numpy(), img)


def test_normalized_sampling_equals_jax():
    img = _image(4, np.uint8, (8, 16))
    xs = RNG.random((5, 7)).astype(np.float32)
    ys = RNG.random((5, 7)).astype(np.float32)
    for mode in (texture.FilterMode.NEAREST, texture.FilterMode.LINEAR):
        ref = jax_texture.TextureImage(img, use_normalized_coords=True,
                                       filter_mode=mode).sample(xs, ys)
        out = texture.TextureImage(img, use_normalized_coords=True,
                                   filter_mode=mode).sample(xs, ys)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_round_trip_and_accessors(channels, dtype):
    img = _image(channels, dtype, (6, 10))
    ref = jax_texture.TextureImage.from_array(img)
    tex = texture.TextureImage.from_tensor(torch.from_numpy(img))
    assert (tex.height, tex.width, tex.channels) == \
        (ref.height, ref.width, ref.channels)
    np.testing.assert_array_equal(tex.to_array().numpy(),
                                  np.asarray(ref.to_array()))
    assert str(tex) == str(ref)
    tex.release()
    assert texture.CUDATexture is texture.TextureImage


@pytest.mark.parametrize("data,kwargs", [
    (np.zeros((4, 4, 3), np.float32), {}),
    (np.zeros((4, 4), np.float64), {}),
    (np.zeros((4, 4), np.int16), {}),
    (np.zeros((2, 4, 4, 1), np.float32), {}),
    (np.zeros((5, 7), np.float32), dict(use_normalized_coords=True)),
    (np.zeros((8, 6), np.float32), dict(use_normalized_coords=True))],
    ids=["3-channels", "float64", "int16", "rank-4", "normalized-5x7",
         "normalized-8x6"])
def test_contract_errors_equal_jax(data, kwargs):
    with pytest.raises(RuntimeError):
        jax_texture.TextureImage(data, **kwargs)
    with pytest.raises(RuntimeError):
        texture.TextureImage(data, **kwargs)
    texture.TextureImage(np.zeros((8, 16), np.float32),
                         use_normalized_coords=True)
