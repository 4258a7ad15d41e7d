"""Guided-filter cost-volume aggregation (CVF), plain PyTorch version.

Port of ``stereomatch_tpu/ops/cvf.py``.  The wedge path
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

The JAX package's other paths are XLA there (no Pallas kernel computes
them), and plain PyTorch on every device here:

* ``wedge_offset=None``, the generic masked path (``_filter_stats``):
  any +inf pattern, the mask applied with ``where`` (inf * 0 is NaN),
  every window count floored at 1.  Bit-equal to the JAX package's
  ``use_mxu=False`` lowering, except where XLA's CPU vectoriser
  interleaves a short D loop (D = 3..8 at the widths measured), which
  leaves the linear model's products unfused: there within 2e-7
  absolute on volumes in [0, 1);
* ``assume_finite``: the standard guided filter, its constant window
  counts folded into reciprocals as XLA folds them: bit-equal;
* ``subsample > 1``, the fast guided filter (``_filter_body_fast``):
  the statistics on a grid resized by the JAX package's bilinear
  weights (:func:`resize_weights`, antialiased), applied as explicit
  taps.  XLA's CPU computes those weights and their contraction with
  reassociated, vectorised sums, whose order changes with the sizes:
  within about 1e-4 relative of it, not bit-equal;
* ``guided_filter_from_padded``, the row-sharded body: equal to the
  masked path on the whole image bit for bit.

On the card every path equals the CPU bit for bit: elementwise float32
operations, explicit tap orders, and ``fma`` in float64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
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

    eps32 = torch.full((), eps, dtype=torch.float32, device=dev)
    a, b = _linear_model(s_p / count, s_g / count, s_gp / count,
                         s_gg / count, eps32)
    a0 = torch.where(valid, a, zero)
    b0 = torch.where(valid, b, zero)
    q = fma(box(a0) / count, g, box(b0) / count)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    return torch.where(valid, q, inf).to(volume.dtype)


def _filter_stats(p32: torch.Tensor, i32: torch.Tensor, radius: int,
                  eps: float, assume_finite: bool):
    """First guided-filter stage of the generic path: the per-window
    linear model (a, b).  Returns (a, b, finite, mean): ``finite`` the
    validity mask (None under ``assume_finite``), ``mean`` the window
    normalisation (a box sum -> its mean) that the second stage reuses.

    Under ``assume_finite`` the count of a window depends on the shape
    alone, and XLA folds it into a constant: each division by it becomes
    a product with its float32 reciprocal, ``mean_i * mean_i`` the
    product of ``s_i * s_i`` with the squared reciprocal, and each
    difference an FMA of its first product.  The port computes those
    forms."""
    box = lambda v: _box_sum_sym(v, radius)  # noqa: E731
    guide = i32[:, :, None]
    eps32 = torch.full((), eps, dtype=torch.float32, device=p32.device)
    if assume_finite:
        recip = 1.0 / box(torch.ones_like(i32))[:, :, None]   # [H, W, 1]
        s_p = box(p32)
        s_i = box(i32)[:, :, None]
        mean_p, mean_i = s_p * recip, s_i * recip
        var_i = fma(box(i32 * i32)[:, :, None], recip,
                    -((s_i * s_i) * (recip * recip)))
        cov_ip = fma(box(guide * p32), recip, -(mean_i * mean_p))
        a = cov_ip / (torch.clamp_min(var_i, 0.0) + eps32)
        b = fma(s_p, recip, -(a * mean_i))
        return a, b, None, lambda s: s * recip
    finite = torch.isfinite(p32)
    valid = finite.to(torch.float32)
    # where, never a multiply by the mask: inf * 0 is NaN.
    p0 = torch.where(finite, p32, torch.zeros((), dtype=torch.float32,
                                              device=p32.device))
    # Zero-valid windows lie deep inside the invalid set, whose cells the
    # caller restores to +inf: the floor only keeps 0/0 out.
    count = torch.clamp_min(box(valid), 1.0)
    a, b = _linear_model(box(p0) / count, box(guide * valid) / count,
                         box(guide * p0) / count,
                         box(guide * guide * valid) / count, eps32)
    return a, b, finite, lambda s: s / count


def _filter_body_masked(volume: torch.Tensor, guide: torch.Tensor,
                        radius: int, eps: float,
                        assume_finite: bool) -> torch.Tensor:
    """The generic masked filter (any +inf pattern), or the standard
    guided filter under ``assume_finite``: each output averages the
    linear models of the windows that hold it, only those centred at a
    valid cell under the mask."""
    p32 = volume.to(torch.float32)
    i32 = guide.to(torch.float32)
    a, b, finite, mean = _filter_stats(p32, i32, radius, eps, assume_finite)
    box = lambda v: _box_sum_sym(v, radius)  # noqa: E731
    g = i32[:, :, None]
    if finite is None:
        return fma(mean(box(a)), g, mean(box(b))).to(volume.dtype)
    valid = finite.to(torch.float32)
    q = fma(mean(box(a * valid)), g, mean(box(b * valid)))
    inf = torch.full((), float("inf"), dtype=torch.float32, device=q.device)
    return torch.where(finite, q, inf).to(volume.dtype)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The [in_size, out_size] float32 weights of the JAX package's
    bilinear resize along one axis (``jax.image.resize(..., "bilinear")``
    with its default ``antialias=True``: a triangle kernel widened by the
    scale factor when downsampling), built as ``jax/_src/image/scale.py``
    builds them (``compute_weight_mat``), one float32 rounding an
    operation, the column sums taken in index order."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.zeros(out_size, f32)
    for row in weights:
        total = total + row
    keep = np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(keep, weights / np.where(total != 0, total, f32(1)),
                       f32(0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_taps(in_size: int, out_size: int, device) -> tuple:
    """The banded form of :func:`resize_weights`, as (index, weight), each
    [taps, out_size]: output ``o`` sums ``weight[t, o] * x[index[t, o]]``
    over taps t, the nonzero weights of its column in index order (the
    band's clipped tail padded with zero weights).  Made on the host once
    per size pair and device and kept, so a frame makes no host-to-device
    copy for them (and a CUDA graph can capture the resize)."""
    return _resize_taps(int(in_size), int(out_size), torch.device(device))


@functools.lru_cache(maxsize=64)
def _resize_taps(in_size: int, out_size: int, device: torch.device) -> tuple:
    weights = resize_weights(in_size, out_size)
    nonzero = weights != 0
    lo = np.where(nonzero.any(0), nonzero.argmax(0), 0)
    hi = np.where(nonzero.any(0), in_size - 1 - nonzero[::-1].argmax(0), 0)
    taps = max(int((hi - lo).max()) + 1, 1)
    rows = lo[None, :] + np.arange(taps)[:, None]
    cols = np.broadcast_to(np.arange(out_size), rows.shape)
    clipped = np.minimum(rows, in_size - 1)
    weight = np.where(rows <= hi[None, :], weights[clipped, cols],
                      np.float32(0))
    return (torch.from_numpy(clipped.astype(np.int64)).to(device),
            torch.from_numpy(weight.astype(np.float32)).to(device))


def _resize_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Bilinear resize of one axis of ``x`` to ``size`` as explicit taps,
    each product added with one rounding (``fma``), in tap order."""
    if x.shape[axis] == size:
        return x
    index, weight = resize_taps(x.shape[axis], size, x.device)
    shape = [1] * x.ndim
    shape[axis] = size
    acc = None
    for t in range(index.shape[0]):
        tap = x.index_select(axis, index[t])
        w = weight[t].view(shape)
        acc = tap * w if acc is None else fma(tap, w, acc)
    return acc


def _resize2d(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize over the two leading (spatial) axes, in the order
    the JAX package's einsum contracts them (the cheaper first)."""
    h, w = x.shape[:2]
    rest = int(np.prod(x.shape[2:], dtype=np.int64))
    h_first = h * w * rest * height + height * w * rest * width
    w_first = h * w * rest * width + h * width * rest * height
    if h_first <= w_first:
        return _resize_axis(_resize_axis(x, 0, height), 1, width)
    return _resize_axis(_resize_axis(x, 1, width), 0, height)


def _filter_body_fast(volume: torch.Tensor, guide: torch.Tensor,
                      radius: int, eps: float, assume_finite: bool,
                      subsample: int) -> torch.Tensor:
    """Fast Guided Filter (He & Sun 2015): the window statistics on an
    s-times downsampled grid, the linear model upsampled and applied
    against the full-resolution guide.  Masked form: the zeroed volume
    and the validity mask are pooled by one resize (lanes independent),
    their ratio a kernel-weighted masked mean, windows whose pooled
    validity is below 1e-6 guarded like empty windows; +inf restored
    from the full-resolution mask."""
    s = subsample
    height, width = guide.shape
    lh, lw = max(1, height // s), max(1, width // s)
    p32 = volume.to(torch.float32)
    i32 = guide.to(torch.float32)
    low_r = max(1, radius // s)
    i_low = _resize2d(i32, lh, lw)
    box = lambda v: _box_sum_sym(v, low_r)  # noqa: E731
    finite = None
    if assume_finite:
        a, b, _, mean = _filter_stats(_resize2d(p32, lh, lw), i_low, low_r,
                                      eps, True)
        a_bar, b_bar = mean(box(a)), mean(box(b))
    else:
        finite = torch.isfinite(p32)
        zero = torch.zeros((), dtype=torch.float32, device=p32.device)
        ndisp = p32.shape[2]
        low = _resize2d(torch.cat([torch.where(finite, p32, zero),
                                   finite.to(torch.float32)], dim=2),
                        lh, lw)
        p_low, v_low = low[:, :, :ndisp], low[:, :, ndisp:]
        g_low = i_low[:, :, None]
        count = torch.clamp_min(box(v_low), 1e-6)
        eps32 = torch.full((), eps, dtype=torch.float32, device=p32.device)
        a, b = _linear_model(box(p_low) / count, box(g_low * v_low) / count,
                             box(g_low * p_low) / count,
                             box(g_low * g_low * v_low) / count, eps32)
        a_bar = box(a * v_low) / count
        b_bar = box(b * v_low) / count
    q = fma(_resize2d(a_bar, height, width), i32[:, :, None],
            _resize2d(b_bar, height, width))
    if finite is not None:
        q = torch.where(finite, q, torch.full((), float("inf"),
                                              device=q.device))
    return q.to(volume.dtype)


def check_filter_args(radius: int, eps: float, subsample: int = 1,
                      assume_finite: bool = False, wedge_offset=None) -> None:
    """The JAX package's argument checks (``_filter_body``)."""
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
    an [H, W, D] float volume; +inf cells survive, storage dtype kept.

    ``wedge_offset``: the volume's +inf cells are exactly the wedge
    ``x < d + wedge_offset`` (every registry cost family writes it), and
    the guide statistics collapse to plane algebra.  Else the generic
    masked path (any +inf pattern), or, with ``assume_finite``, the
    standard guided filter on an all-finite volume.  ``subsample > 1``:
    the fast guided filter on an s-times downsampled grid
    (approximate)."""
    check_volume_and_guide(cost_volume, guide)
    check_filter_args(int(radius), float(eps), int(subsample),
                      bool(assume_finite), wedge_offset)
    radius, eps = int(radius), float(eps)
    if wedge_offset is not None:
        offset = int(wedge_offset)
        planes = guide_planes(guide, radius, offset, cost_volume.shape[2])
        return _filter_body_wedge(cost_volume, planes, radius, eps, offset)
    if subsample > 1:
        return _filter_body_fast(cost_volume, guide, radius, eps,
                                 bool(assume_finite), int(subsample))
    return _filter_body_masked(cost_volume, guide, radius, eps,
                               bool(assume_finite))


def guided_filter_from_padded(volume_padded: torch.Tensor,
                              guide_padded: torch.Tensor, pad_before: int,
                              pad_after: int, *, radius: int = 8,
                              eps: float = 1e-4,
                              assume_finite: bool = False) -> torch.Tensor:
    """Row-sharded body: filter a tile carrying halo rows, crop the halo.

    Both filter stages are box means, so output row y reads input rows
    [y - 2r, y + 2r]: with ``pad_*`` >= 2r halo rows, and the rows beyond
    the image set to +inf (invalid: zero is the identity of the window
    sums but not of the window counts), the cropped rows equal the
    single-device masked filter bit for bit (every box sums in window
    order, the invalid taps adding exact zeros)."""
    check_volume_and_guide(volume_padded, guide_padded)
    check_filter_args(int(radius), float(eps), 1, bool(assume_finite))
    out = _filter_body_masked(volume_padded, guide_padded, int(radius),
                              float(eps), bool(assume_finite))
    return out[pad_before:out.shape[0] - pad_after]
