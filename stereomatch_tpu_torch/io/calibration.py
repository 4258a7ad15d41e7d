"""Stereo rectification by a pair of homographies, the counterpart of
``stereomatch_tpu/io/calibration.py``.

``warp_perspective`` is ``cv2.warpPerspective``'s map in PyTorch on the
image's device: bilinear sampling, zero outside the image (cv2's default
border).  The state dict keeps the reference's keys (homography0,
homography1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..pipeline import as_tensor


def warp_perspective(image, homography, inverse: bool = False
                     ) -> torch.Tensor:
    """Apply a 3x3 homography to an [H, W] or [H, W, C] image with
    bilinear sampling.

    As cv2.warpPerspective: each destination pixel p samples the source
    at H^-1 p (``inverse=True`` takes ``homography`` as that inverse
    map already).  A corner sample outside the image contributes 0.  A
    float image keeps its dtype; an integer one is rounded back to it.
    """
    image = as_tensor(image)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[:, :, None]
    height, width = image.shape[:2]
    dev = image.device

    hmat = torch.as_tensor(np.asarray(homography, np.float32), device=dev)
    if not inverse:
        hmat = torch.linalg.inv(hmat)

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    src = dst @ hmat.T
    sx = src[:, 0] / src[:, 2]
    sy = src[:, 1] / src[:, 2]

    img = image.to(torch.float32).reshape(height * width, -1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= width - 1) & (iy >= 0) & (iy <= height - 1)
        ixc = ix.clamp(0, width - 1).to(torch.int64)
        iyc = iy.clamp(0, height - 1).to(torch.int64)
        return torch.where(inb[:, None], img[iyc * width + ixc], 0.0)

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    out = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
           + (v10 * (1 - wx) + v11 * wx) * wy)
    out = out.reshape(height, width, -1)
    if not image.is_floating_point():
        out = out.round()
    out = out.to(image.dtype)
    return out[:, :, 0] if squeeze else out


class StereoRectifier:
    """Homography-pair rectifier (reference: stereomatch/calibration.py:11-72).

    Attributes:
        homography0: 3x3 homography for the left camera.
        homography1: 3x3 homography for the right camera.
    """

    def __init__(self, homography0: np.ndarray, homography1: np.ndarray):
        self.homography0 = np.asarray(homography0, np.float32)
        self.homography1 = np.asarray(homography1, np.float32)

    @classmethod
    def from_state_dict(cls, state_dict) -> "StereoRectifier":
        return cls(state_dict["homography0"], state_dict["homography1"])

    def get_state_dict(self):
        return {"homography0": self.homography0,
                "homography1": self.homography1}

    def __call__(self, img0, img1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rectify a stereo pair."""
        return (warp_perspective(img0, self.homography0),
                warp_perspective(img1, self.homography1))

    def invert(self, rectified_img, stereo_view_idx: int) -> torch.Tensor:
        """Undo the rectification for one view (0 = left, 1 = right)."""
        if stereo_view_idx not in (0, 1):
            raise ValueError(f"stereo_view_idx must be 0 or 1, got "
                             f"{stereo_view_idx}")
        hmat = (self.homography0, self.homography1)[stereo_view_idx]
        return warp_perspective(rectified_img, hmat, inverse=True)
