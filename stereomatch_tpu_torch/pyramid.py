"""Coarse-to-fine pyramid estimation, the counterpart of
``stereomatch_tpu/pyramid.py``: full census + SGM + WTA at reduced
resolution, then per-pixel disparity-band refinement at each finer level.

Halving both image axes and the disparity range divides the volume by 8
a level, so the full pipeline runs on a volume 8^levels times smaller;
each finer level only re-scores a band of ``2r + 1`` candidates around
the upsampled prediction, with census Hamming distances (pixelwise, so a
per-pixel band needs no windowed sums across neighbours with other
bands).

The coarse SGM is ``aggregation.Semiglobal``: on the card the SGM kernels
(the TPU's K2/K3), as the JAX package runs its Pallas SGM there.  The
rest is plain PyTorch on the images' device; no Pallas kernel reaches
the JAX module's band stage (XLA there).  On the TPU the band stage is a
loop over the D planes that keeps no volume; here it computes the masked
Hamming planes as one [H, W, D] int32 tensor and takes the first minimum
with ``torch.argmin`` (the loop's "ties keep the lower d") and the
winner's neighbours with a gather, all in integers, so every result
equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .aggregation import Semiglobal
from .ops.cost import (census_hamming_cost_volume, census_transform,
                       popcount32, shifted_right_stack)
from .ops.disparity import winner_takes_all
from .ops.refine import median_filter_3x3
from .pipeline import Device, Image, as_tensor
from .utils import validation

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Invalid candidates' cost in the band stage (beyond any Hamming sum).
_BIG = 1 << 20


def downsample2(image: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling of a float [..., H, W] image (H and W even), in
    float32.  Each block sums in row-major order, ``((x00 + x01) + x10)
    + x11``, then scales by 1/4: the order XLA's CPU reduces
    ``mean(axis=(1, 3))`` in (one unit in the last place here can flip a
    census bit at the coarse level)."""
    x = image.to(torch.float32)
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return (((a + b) + c) + d) * 0.25


def upsample2_nearest(disparity: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of a [..., H, W] disparity map, values doubled
    (one coarse pixel is two fine pixels; one coarse disparity two)."""
    up = disparity.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up * 2


def _box_rows_cols(plane: torch.Tensor, half: int) -> torch.Tensor:
    """Zero-padded (2 half + 1)-box sums of an int32 [H, W, D] volume over
    H, then over W."""
    for dim in (0, 1):
        n = plane.shape[dim]
        pad = [0, 0] * (plane.ndim - dim - 1) + [half, half]
        padded = F.pad(plane, pad)
        acc = padded.narrow(dim, 0, n).clone()
        for t in range(1, 2 * half + 1):
            acc.add_(padded.narrow(dim, t, n))
        plane = acc
    return plane


def band_refine_census(left: torch.Tensor, right: torch.Tensor,
                       predicted: torch.Tensor, *,
                       band_radius: int,
                       max_disparity: int,
                       window_size: int = 5,
                       band_kernel_size: int = 1,
                       row_valid=None,
                       subpixel: bool = False,
                       return_best_cost: bool = False):
    """Re-score disparities in [predicted - r, predicted + r] per pixel.

    Census Hamming distances of every disparity, each masked to its
    pixel's band: the band starts at ``predicted - r`` clipped into
    [0, max_disparity - (2r + 1)], and candidates with d > x are
    invalid.  Ties break toward the lowest disparity, as winner-takes-all
    breaks them; a pixel with no valid candidate gets d = x.

    ``band_kernel_size`` > 1 box-sums each disparity plane over a
    (k x k) window first (zero padding; columns with d > x contribute
    the worst Hamming value, ``window_size**2``; rows where ``row_valid``
    is False contribute 0, as the single-device zero padding).
    ``subpixel`` returns float32: the parabolic vertex of the winner's
    cost and its neighbours' ``d* + (cm - cp) / (2 (cm - 2 c0 + cp))``,
    clamped to +-0.5, keeping d* at band borders and flat fits.
    ``return_best_cost`` also returns the winning distance (int32;
    pixels with no valid candidate get the worst value), the drift
    signal of ``temporal.TemporalPipeline``.

    Integer arithmetic throughout (the vertex in float32), so the result
    equals the JAX package's band scan bit for bit.
    """
    height, width = left.shape
    r = band_radius
    n_band = 2 * r + 1
    device = left.device
    code_l = census_transform(left, window_size)
    code_r = census_transform(right, window_size)
    if code_l.ndim != 2:
        raise ValueError(f"the band stage takes census windows of up to 5x5 "
                         f"(one code word), got {window_size}")

    base = (predicted.to(torch.int32) - r).clamp(
        0, max(max_disparity - n_band, 0))[:, :, None]          # [H, W, 1]
    x = torch.arange(width, dtype=torch.int32, device=device)[:, None]
    d = torch.arange(max_disparity, dtype=torch.int32, device=device)
    # ham[y, x, d] = popcount(code_l[y, x] ^ code_r[y, x - d]), the right
    # code read as 0 left of the image.
    ham = popcount32(code_l[:, :, None]
                     ^ shifted_right_stack(code_r, max_disparity))
    worst = window_size * window_size
    k2 = band_kernel_size // 2
    if k2:
        filt = torch.where(x >= d, ham, worst)
        if row_valid is not None:
            filt = torch.where(row_valid.to(device)[:, None, None], filt, 0)
        ham = _box_rows_cols(filt, k2)
    valid = (d >= base) & (d < base + n_band) & (d <= x)
    cost = torch.where(valid, ham, _BIG)                        # [H, W, D]
    best_d = cost.argmin(dim=-1, keepdim=True)                  # first min
    best_cost = cost.gather(-1, best_d)[..., 0]
    best_d = best_d[..., 0].to(torch.int32)
    any_valid = best_cost < _BIG
    out = torch.where(any_valid, best_d, x[:, 0].expand(height, width))
    if subpixel:
        def neighbour(shift):
            idx = (best_d + shift).clamp(0, max_disparity - 1).to(torch.int64)
            c = cost.gather(-1, idx[..., None])[..., 0]
            inside = (best_d + shift >= 0) & (best_d + shift < max_disparity)
            return torch.where(inside, c, _BIG)

        c_minus, c_plus = neighbour(-1), neighbour(1)
        cm = c_minus.to(torch.float32)
        c0 = best_cost.to(torch.float32)
        cp = c_plus.to(torch.float32)
        denom = cm - 2.0 * c0 + cp
        offset = torch.where(denom.abs() > 1e-12, (cm - cp) / (2.0 * denom),
                             0.0).clamp(-0.5, 0.5)
        interior = (c_minus < _BIG) & (c_plus < _BIG)
        out = torch.where(any_valid & interior, out.to(torch.float32) + offset,
                          out.to(torch.float32))
    if not return_best_cost:
        return out
    return out, torch.where(any_valid, best_cost.clamp(max=worst), worst)


def _cost_dtype(dtype) -> torch.dtype:
    name = validation.dtype_name(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unknown cost dtype {dtype!r}; expected float32 or "
                         "bfloat16")
    return _DTYPES[name]


class PyramidPipeline:
    """Coarse-to-fine census pipeline: SGM at 1/2^levels resolution and
    disparity range, then census band refinement up to full resolution.

    ``estimate(left, right) -> [H, W] int32`` like :class:`Pipeline`.
    Images whose sides are not divisible by 2**levels are edge-padded
    (bottom and right) before the pyramid and cropped after.

    Args:
      max_disparity: full-resolution disparity range (divisible by
        2**levels).
      levels: number of halvings before the full pipeline runs.
      band_radius: half-width of the refinement band at each finer level.
      window_size: census window at every level.
      band_kernel_size: the band stage's Hamming box window.
      penalty1/penalty2: SGM penalties at the coarse level.
      cost_dtype: the coarse volume's dtype, float32 or bfloat16 (a torch,
        numpy or JAX dtype, or its name).
      median: 3x3-median every level's disparity.
      backend: the coarse SGM's, as ``aggregation.Semiglobal`` takes it
        ("auto", "cuda" or "torch").
      device: where ``estimate`` runs: the card unless ``"cpu"`` is asked
        for.
    """

    def __init__(self, max_disparity: int, *, levels: int = 1,
                 band_radius: int = 24, window_size: int = 5,
                 band_kernel_size: int = 5,
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 cost_dtype=torch.float32,
                 median: bool = True,
                 backend: str = "auto",
                 device: Device = "cuda"):
        if levels < 1:
            raise ValueError("levels must be >= 1")
        if max_disparity % (2 ** levels):
            raise ValueError(f"max_disparity {max_disparity} not divisible "
                             f"by 2**levels = {2 ** levels}")
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                             "'cuda' or 'torch'")
        self.max_disparity = max_disparity
        self.levels = levels
        self.band_radius = band_radius
        self.window_size = window_size
        self.band_kernel_size = band_kernel_size
        self.penalty1 = penalty1
        self.penalty2 = penalty2
        self.cost_dtype = _cost_dtype(cost_dtype)
        self.median = median
        self.backend = backend
        self.device = device

    def _estimate(self, left, right, subpixel=False):
        height, width = left.shape
        scale = 2 ** self.levels
        pad_h, pad_w = (-height) % scale, (-width) % scale
        left = left.to(torch.float32)
        right = right.to(torch.float32)
        if pad_h or pad_w:
            left, right = (F.pad(x[None, None], (0, pad_w, 0, pad_h),
                                 mode="replicate")[0, 0]
                           for x in (left, right))

        pyr = [(left, right)]
        for _ in range(self.levels):
            l, r = pyr[-1]
            pyr.append((downsample2(l), downsample2(r)))

        coarse_l, coarse_r = pyr[-1]
        vol = census_hamming_cost_volume(
            coarse_l, coarse_r, max_disparity=self.max_disparity // scale,
            window_size=self.window_size, cost_dtype=self.cost_dtype)
        agg = Semiglobal(self.penalty1, self.penalty2,
                         backend=self.backend)(vol, coarse_l)
        disp = winner_takes_all(agg)

        for level in range(self.levels - 1, -1, -1):
            fine_l, fine_r = pyr[level]
            disp = band_refine_census(
                fine_l, fine_r, upsample2_nearest(disp),
                band_radius=self.band_radius,
                max_disparity=self.max_disparity // (2 ** level),
                window_size=self.window_size,
                band_kernel_size=self.band_kernel_size,
                subpixel=subpixel and level == 0)
            if self.median:
                # The pixelwise band WTA has no smoothing term: a 3x3
                # median stops its speckle before it anchors the next
                # level's bands.
                disp = median_filter_3x3(disp)
        return disp[:height, :width]

    def _inputs(self, left_image, right_image, device):
        device = device if device is not None else self.device
        left = as_tensor(left_image, device)
        right = as_tensor(right_image, device)
        validation.check_stereo_pair(left, right)
        return left, right

    def estimate(self, left_image: Image, right_image: Image,
                 device: Device = None) -> torch.Tensor:
        """[H, W] int32 disparities on ``device``, else on ``self.device``
        (the card unless the pipeline was built for the CPU)."""
        return self._estimate(*self._inputs(left_image, right_image, device))

    def estimate_refined(self, left_image: Image, right_image: Image, *,
                         subpixel: bool = True, median: bool = True,
                         device: Device = None) -> torch.Tensor:
        """Estimate with parabolic sub-pixel output (float32), the vertex
        taken in the final band stage from the winner's neighbour costs;
        ``median`` is accepted for ``Pipeline.estimate_refined``'s sake
        (every level is median-filtered when the pipeline was built with
        ``median=True``)."""
        del median
        return self._estimate(*self._inputs(left_image, right_image, device),
                              subpixel=subpixel)
