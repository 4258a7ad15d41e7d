"""Image sampling layer, the counterpart of ``stereomatch_tpu/texture.py``
(the reference's CUDA textures, ``src/cuda_texture.cpp:23-172``).

The same semantics as the JAX package: clamp addressing, nearest or
bilinear filtering, optional normalised coordinates, over a tensor on
its own device.  The sampler is explicit clamped gathers and weighted
sums in the JAX ``_sample``'s order, not ``F.grid_sample`` (whose weight
arithmetic is its own); the bilinear blends are the fused multiply-adds
that XLA's CPU backend contracts them into (``utils/numeric.fma``), so
the samples equal the JAX package's bit for bit on the CPU, and the
card's equal the CPU's.  Sampling every integer pixel centre with
nearest filtering returns the stored image exactly, which makes the
texture-backed SSD equal to the tensor SSD.

Contract, as the reference's:
  * 1, 2 or 4 channels, float32 or uint8 (a 3-channel image raises);
  * ``use_normalized_coords`` needs power-of-two width and height;
  * ``from_array`` then ``to_array`` restores the input.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.numeric import fma, is_power_of_two

_ALLOWED_CHANNELS = (1, 2, 4)
_ALLOWED_DTYPES = (torch.float32, torch.uint8)


class FilterMode:
    NEAREST = "nearest"
    LINEAR = "linear"


def _sample(image: torch.Tensor, xs, ys, filter_mode: str = FilterMode.NEAREST,
            normalized: bool = False) -> torch.Tensor:
    """Gather-based tex2D with clamp addressing over [H, W, C]: returns
    [..., C] float32 at the coordinates' shape."""
    height, width = image.shape[0], image.shape[1]
    xs = torch.as_tensor(xs, device=image.device).to(torch.float32)
    ys = torch.as_tensor(ys, device=image.device).to(torch.float32)
    if normalized:
        xs = xs * width
        ys = ys * height
    flat = image.to(torch.float32).reshape(height * width, -1)

    def gather(ix, iy):
        ix = ix.clamp(0, width - 1)
        iy = iy.clamp(0, height - 1)
        return flat[(iy * width + ix).long()]

    if filter_mode == FilterMode.NEAREST:
        # CUDA point sampling truncates the continuous coordinate.
        return gather(torch.floor(xs).to(torch.int32),
                      torch.floor(ys).to(torch.int32))
    # CUDA bilinear convention: texel centres at integer + 0.5.
    fx = xs - 0.5
    fy = ys - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    v00 = gather(x0i, y0i)
    v01 = gather(x0i + 1, y0i)
    v10 = gather(x0i, y0i + 1)
    v11 = gather(x0i + 1, y0i + 1)
    # Each blend a * (1 - w) + b * w is one product rounded and one fused
    # into the sum, as XLA's CPU backend compiles ``_sample``; which
    # product it fuses in the top row depends on the channel count
    # (measured against the JAX package at 1, 2 and 4 channels).
    if image.shape[2] == 1:
        top = fma(v01, wx, v00 * (1 - wx))
    else:
        top = fma(v00, 1 - wx, v01 * wx)
    bot = fma(v10, 1 - wx, v11 * wx)
    return fma(top, 1 - wy, bot * wy)


def _as_tensor(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.array(data))


class TextureImage:
    """Clamp-addressed, filterable view over an image tensor, the
    counterpart of the JAX package's ``TextureImage`` (reference:
    ``stereomatch.cuda_texture.CUDATexture``)."""

    def __init__(self, data, *, use_normalized_coords: bool = False,
                 filter_mode: str = FilterMode.NEAREST):
        data = _as_tensor(data)
        if data.ndim == 2:
            data = data[:, :, None]
        if data.ndim != 3:
            raise RuntimeError(
                f"TextureImage expects [H, W] or [H, W, C], got "
                f"{tuple(data.shape)}")
        channels = data.shape[2]
        if channels not in _ALLOWED_CHANNELS:
            raise RuntimeError(
                f"TextureImage supports {_ALLOWED_CHANNELS} channels, got "
                f"{channels} (reference contract: cuda_texture.cpp:44-63)")
        if data.dtype not in _ALLOWED_DTYPES:
            raise RuntimeError(
                f"TextureImage supports float32/uint8, got {data.dtype}")
        if use_normalized_coords and not (
                is_power_of_two(data.shape[0])
                and is_power_of_two(data.shape[1])):
            raise RuntimeError(
                "Normalized coordinates require power-of-two dimensions "
                "(reference contract: cuda_texture.cpp:30-35)")
        self._data = data
        self.use_normalized_coords = use_normalized_coords
        self.filter_mode = filter_mode

    @property
    def width(self) -> int:
        return self._data.shape[1]

    @property
    def height(self) -> int:
        return self._data.shape[0]

    @property
    def channels(self) -> int:
        return self._data.shape[2]

    @property
    def device(self) -> torch.device:
        return self._data.device

    @classmethod
    def from_array(cls, array, normalized_coords: bool = False,
                   filter_mode: str = FilterMode.NEAREST) -> "TextureImage":
        """A texture over ``array`` (a tensor, on its device, or a numpy
        array, on the CPU)."""
        return cls(array, use_normalized_coords=normalized_coords,
                   filter_mode=filter_mode)

    # Alias so reference call sites read unchanged.
    from_tensor = from_array

    def to_array(self) -> torch.Tensor:
        """The stored image ([H, W] if single-channel)."""
        if self.channels == 1:
            return self._data[:, :, 0]
        return self._data

    def release(self) -> None:
        """No-op: the tensor's owner frees it."""

    def sample(self, xs, ys) -> torch.Tensor:
        """tex2D(texture, x, y) for arbitrary coordinate arrays."""
        out = _sample(self._data, xs, ys, filter_mode=self.filter_mode,
                      normalized=self.use_normalized_coords)
        if self.channels == 1:
            return out[..., 0]
        return out

    def sample_grid(self) -> torch.Tensor:
        """Sample every integer pixel centre: the stored image (float32)
        under nearest filtering without normalised coordinates, with no
        gather for that case, as the JAX package does."""
        if (self.filter_mode == FilterMode.NEAREST
                and not self.use_normalized_coords):
            return self.to_array().to(torch.float32)
        ys, xs = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=self.device),
            torch.arange(self.width, dtype=torch.float32, device=self.device),
            indexing="ij")
        return self.sample(xs, ys)

    def __str__(self) -> str:
        return (f"TextureImage(width={self.width}, height={self.height}, "
                f"channels={self.channels}, "
                f"normalized={self.use_normalized_coords}, "
                f"filter={self.filter_mode})")

    __repr__ = __str__


# Reference-compatible alias.
CUDATexture = TextureImage
