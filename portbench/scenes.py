"""Seeded stereo frames for the benchmark: numpy only.

A frozen copy of the flat-warp scene of
``stereomatch_tpu_torch.io.synthetic.stereo_pair`` (a smoothed-noise
texture strip, a background plane and four boxes at random
disparities, ``left[y, x] = right[y, x - gt[y, x]]``), kept here so
that a change to the program cannot change the benchmark's inputs.
Each view then gets its own sensor noise and is quantised to uint8, as
a camera delivers it: no match is perfect, as in real footage.

Every frame of a pool has the same height, width and disparity range,
so the work of a frame does not depend on the seed.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

# Standard deviation of each view's sensor noise, in 8-bit levels.
NOISE_LEVELS = 2.0


class Pair(NamedTuple):
    """One stereo frame as a capture hands it over: gray uint8 views."""
    left: np.ndarray
    right: np.ndarray


def _smooth_texture(rng, height: int, width: int) -> np.ndarray:
    noise = rng.standard_normal((height, width)).astype(np.float32)
    texture = noise.copy()
    for _ in range(3):
        texture = (texture
                   + np.roll(texture, 1, 0) + np.roll(texture, -1, 0)
                   + np.roll(texture, 1, 1) + np.roll(texture, -1, 1)) / 5.0
    texture += 0.15 * noise
    texture -= texture.min()
    texture /= max(texture.max(), 1e-6)
    return texture


def _flat_warp(rng, height: int, width: int, max_disparity: int):
    """(left, right) float32 in [0, 1] and the int32 ground truth."""
    texture = _smooth_texture(rng, height, width + max_disparity)
    gt = np.full((height, width), max(max_disparity // 8, 1), np.int32)
    for _ in range(4):
        h0 = int(rng.integers(0, max(height - 8, 1)))
        w0 = int(rng.integers(0, max(width - 8, 1)))
        bh = int(rng.integers(height // 6 + 1, height // 2 + 2))
        bw = int(rng.integers(width // 6 + 1, width // 2 + 2))
        d = int(rng.integers(1, max_disparity - 1))
        gt[h0:h0 + bh, w0:w0 + bw] = d
    xs = np.arange(width)[None, :]
    gt = np.minimum(gt, xs).astype(np.int32)
    right = texture[:, max_disparity:]
    left = np.take_along_axis(right, xs - gt, axis=1)
    return left, right, gt


def _to_uint8(rng, view: np.ndarray) -> np.ndarray:
    noisy = view * 255.0 + NOISE_LEVELS * rng.standard_normal(view.shape)
    return np.clip(np.rint(noisy), 0, 255).astype(np.uint8)


def frame(seed: int, index: int, height: int, width: int,
          max_disparity: int) -> Pair:
    """Frame ``index`` of the pool of ``seed``: any whole numbers."""
    rng = np.random.default_rng([seed % 2 ** 64, index])
    left, right, _ = _flat_warp(rng, height, width, max_disparity)
    return Pair(_to_uint8(rng, left), _to_uint8(rng, right))


def pool(seed: int, size: int, height: int, width: int,
         max_disparity: int) -> List[Pair]:
    """``size`` distinct frames drawn from ``seed``."""
    return [frame(seed, i, height, width, max_disparity)
            for i in range(size)]
