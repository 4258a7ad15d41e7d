"""Guided-filter cost-volume aggregation (CVF), plain PyTorch version.

Port of the wedge path of ``stereomatch_tpu/ops/cvf.py``
(``guided_filter_aggregate(..., wedge_offset=k)``): edge-aware local
smoothing of every disparity slice by a guided filter (He et al. 2010)
with the left image as the guide, the "cost volume filtering" of Hosni
et al. (PAMI 2013).  It runs on any device and is the oracle of the CUDA
kernels in ``ops/cvf_cuda.py``; ``aggregation.CostFilter`` chooses
between the two.

Semantics (those of the JAX package):

* windows are symmetric (2r+1) x (2r+1) boxes, clipped at the image
  border, every mean normalised by the count of valid cells inside;
* the volume's invalid cells are exactly the wedge ``x < d + offset``
  (the +inf fill of the cost producers); they are left out of every
  window statistic and restored as +inf in the output;
* the three guide statistics of the masked filter (count, sum of I,
  sum of I^2) collapse to closed forms and to [H, W] prefix planes of
  the H-boxed guide, so only four volume statistics remain (p0, I*p0,
  a0, b0).

Association: every box sum is 2r+1 explicit shifted adds in window
order, the H axis first and then the W axis, the association of XLA's
``reduce_window`` on the CPU; the W prefix sums take the block
association of XLA's CPU cumsum (``utils.numeric.prefix_sum_w``).  With
``use_mxu=False`` the JAX package's result is then equal to this one
bit for bit.

``wedge_offset=None`` (the generic masked path), ``assume_finite`` and
``subsample > 1`` (the fast guided filter) are XLA-only in the JAX
package and not ported yet: they raise ``NotImplementedError`` naming
ROADMAP A.9.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.numeric import fma
from ..utils.numeric import prefix_sum_w as _prefix_sum_w

def _box_sum_sym(x: torch.Tensor, radius: int, axes=(0, 1)) -> torch.Tensor:
    """Separable clipped box sum over a symmetric (2r+1) window: per axis,
    zero-pad (r, r) and add the 2r+1 shifted views in window order."""
    r = radius
    for ax in axes:
        n = x.shape[ax]
        pad = list(x.shape)
        pad[ax] = r
        padded = torch.cat([x.new_zeros(pad), x, x.new_zeros(pad)], dim=ax)
        acc = padded.narrow(ax, 0, n).clone()
        for t in range(1, 2 * r + 1):
            acc.add_(padded.narrow(ax, t, n))
        x = acc
    return x


def _linear_model(mean_p, mean_i, corr_ip, corr_ii, eps):
    """Per-window linear model from windowed means: q ~= a*I + b, with
    each product-and-difference fused as XLA fuses it."""
    var_i = torch.clamp_min(fma(-mean_i, mean_i, corr_ii), 0.0)
    cov_ip = fma(-mean_i, mean_p, corr_ip)
    a = cov_ip / (var_i + eps)
    b = fma(-a, mean_i, mean_p)
    return a, b


def _prefix_planes_w(plane: torch.Tensor, radius: int):
    """Shifted W-prefix planes of an [H, W] plane.

    Returns (hi, lo, p) with ``p[y, k] = sum_{x < k} plane[y, x]`` (the
    zero-prepended prefix, [H, W+1]), ``hi[y, x] = p[y, min(x+r+1, W)]``
    and ``lo[y, x] = p[y, max(x-r, 0)]``, so ``hi - lo`` is the clipped
    symmetric W box sum.
    """
    height, width = plane.shape
    p = torch.cat([plane.new_zeros((height, 1)), _prefix_sum_w(plane)],
                  dim=1)
    x = torch.arange(width, device=plane.device)
    hi = p[:, (x + radius + 1).clamp(max=width)]
    lo = p[:, (x - radius).clamp(min=0)]
    return hi, lo, p


class GuidePlanes(NamedTuple):
    """The [H, W] and [H, D] guide statistics of the wedge filter, shared
    by the plain version and the CUDA kernels."""
    guide: torch.Tensor     # [H, W] float32 guide image
    hi1: torch.Tensor       # [H, W] prefix planes of boxH(I)
    lo1: torch.Tensor
    hi2: torch.Tensor       # [H, W] prefix planes of boxH(I^2)
    lo2: torch.Tensor
    pd1: torch.Tensor       # [H, D] prefix columns of boxH(I) at d + offset
    pd2: torch.Tensor       # [H, D] the same of boxH(I^2)


def guide_planes(guide: torch.Tensor, radius: int, wedge_offset: int,
                 max_disparity: int) -> GuidePlanes:
    """Guide planes of the wedge filter (the JAX package computes the
    same in XLA outside its kernels).  ``pd[y, d] = p[y, clip(d + offset,
    0, W)]``: the prefix column at the wedge's lower bound.

    I and I^2 go through one H box and one prefix sum, stacked: every
    element sees the same adds as on its own, in a third of the
    launches (on the card this preparation is bound by launches)."""
    i32 = guide.to(torch.float32)
    height, width = i32.shape
    boxed = _box_sum_sym(torch.stack([i32, i32 * i32]), radius, axes=(1,))
    hi, lo, p = _prefix_planes_w(boxed.view(2 * height, width), radius)
    lo_col = max(0, min(wedge_offset, width))
    cols = (torch.arange(max_disparity, device=guide.device)
            + lo_col).clamp(max=width)
    pd = p[:, cols]
    return GuidePlanes(i32.contiguous(), hi[:height], lo[:height],
                       hi[height:], lo[height:], pd[:height], pd[height:])


def _filter_body_wedge(volume: torch.Tensor, planes: GuidePlanes,
                       radius: int, eps: float,
                       wedge_offset: int) -> torch.Tensor:
    """Masked guided filter for a volume whose invalid set is the wedge
    ``x < d + wedge_offset``."""
    height, width, max_disp = volume.shape
    r = radius
    dev = volume.device
    box = lambda v: _box_sum_sym(v, r)  # noqa: E731

    x_id = torch.arange(width, device=dev)[:, None]
    d_id = torch.arange(max_disp, device=dev)[None, :] + wedge_offset
    valid = (x_id >= d_id)[None]                             # [1, W, D]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    p32 = volume.to(torch.float32)
    g = planes.guide[:, :, None]
    p0 = torch.where(valid, p32, zero)
    s_p = box(p0)
    s_gp = box(g * p0)

    cond = ((x_id - r) >= d_id)[None]                        # [1, W, D]
    s_g = planes.hi1[:, :, None] - torch.where(
        cond, planes.lo1[:, :, None], planes.pd1[:, None, :])
    s_gg = planes.hi2[:, :, None] - torch.where(
        cond, planes.lo2[:, :, None], planes.pd2[:, None, :])

    y_id = torch.arange(height, device=dev)
    count_h = ((y_id + r).clamp(max=height - 1)
               - (y_id - r).clamp(min=0) + 1).to(torch.float32)
    cnt_w = ((x_id + r).clamp(max=width - 1)
             - torch.maximum((x_id - r).clamp(min=0), d_id)
             + 1).clamp(min=0).to(torch.float32)             # [W, D]
    count = torch.clamp_min(count_h[:, None, None] * cnt_w[None], 1.0)

    eps32 = torch.tensor(eps, dtype=torch.float32, device=dev)
    a, b = _linear_model(s_p / count, s_g / count, s_gp / count,
                         s_gg / count, eps32)
    a0 = torch.where(valid, a, zero)
    b0 = torch.where(valid, b, zero)
    q = fma(box(a0) / count, g, box(b0) / count)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    return torch.where(valid, q, inf).to(volume.dtype)


def check_filter_args(radius: int, eps: float, subsample: int = 1,
                      assume_finite: bool = False, wedge_offset=None) -> None:
    """The JAX package's argument checks (``_filter_body``), then the
    refusal of what this slice does not port."""
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if not eps > 0:
        raise ValueError(f"eps must be > 0, got {eps} (zero divides by "
                         "the variance of constant-guide windows)")
    if subsample < 1:
        raise ValueError(f"subsample must be >= 1, got {subsample}")
    if wedge_offset is not None:
        if assume_finite:
            raise ValueError("wedge_offset and assume_finite are mutually "
                             "exclusive (a wedge volume is not finite)")
        if subsample > 1:
            raise ValueError("wedge_offset does not compose with the "
                             "subsampled fast path (use one or the other)")
        if wedge_offset < 0:
            raise ValueError(f"wedge_offset must be >= 0, got "
                             f"{wedge_offset}")
        return
    raise NotImplementedError(
        "guided filtering without wedge_offset (the generic masked path, "
        "assume_finite, subsample > 1) is not ported to "
        "stereomatch_tpu_torch yet (ROADMAP A.9)")


def check_volume_and_guide(cost_volume: torch.Tensor,
                           guide: torch.Tensor) -> None:
    if cost_volume.ndim != 3:
        raise ValueError(f"cost_volume must be [H, W, D], got "
                         f"{tuple(cost_volume.shape)}")
    if tuple(guide.shape) != tuple(cost_volume.shape[:2]):
        raise ValueError(f"guide {tuple(guide.shape)} does not match volume "
                         f"spatial dims {tuple(cost_volume.shape[:2])}")


def guided_filter_aggregate(cost_volume: torch.Tensor, guide: torch.Tensor,
                            *, radius: int = 8, eps: float = 1e-4,
                            assume_finite: bool = False, subsample: int = 1,
                            wedge_offset=None) -> torch.Tensor:
    """Edge-aware local aggregation: guided-filter each disparity slice of
    an [H, W, D] float volume whose +inf cells are exactly the wedge
    ``x < d + wedge_offset``; storage dtype preserved."""
    check_volume_and_guide(cost_volume, guide)
    check_filter_args(int(radius), float(eps), int(subsample),
                      bool(assume_finite), wedge_offset)
    radius, offset = int(radius), int(wedge_offset)
    planes = guide_planes(guide, radius, offset, cost_volume.shape[2])
    return _filter_body_wedge(cost_volume, planes, radius, float(eps),
                              offset)
