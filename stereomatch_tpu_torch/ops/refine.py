"""Disparity post-processing, the counterpart of
``stereomatch_tpu/ops/refine.py``: sub-pixel refinement, the 3x3 median,
the left-right check with occlusion fill, PKRN confidence, the
guide-weighted median, the fast global smoother and speckle
suppression.

No Pallas kernel reaches the JAX module, so none of these has a CUDA
kernel: each is plain PyTorch and runs on the device of its input.  The
JAX module works around Mosaic's lack of a gather (one-hot sums for the
sub-pixel samples, a scan of shifted planes for the LR check and the
right-view volume, bisection planes for the weighted median); here a
gather (``torch.gather``, a strided view, a ``cummax`` of valid
positions) or an evaluation at each tap's own bin computes the same
values.  Every function gives the JAX
package's XLA values bit for bit, with one reservation:

* XLA on the CPU contracts a product feeding an add into one fused
  multiply-add, and computes ``exp`` by its own polynomial.  The
  smoother's system and Thomas recurrences emulate each contraction, and
  the weighted median and the smoother weigh by that ``exp``
  (``utils/numeric.fma``, ``exp_f32``), where a double rounding can
  differ from one rounding in a halfway case: a median bin could then
  differ only where the cumulative weight lies within a rounding of half
  the total, and the smoother by the propagation of a last-place error.

The Thomas sweeps run as Python loops of column steps, each step
vectorised over the other axis, as ``lax.scan`` runs them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numeric import exp_f32, fma
from .disparity import winner_takes_all

_FAR = -(1 << 20)       # never within max_diff of a disparity


def _windows(padded: torch.Tensor, window: int) -> torch.Tensor:
    """[H + w - 1, W + w - 1] -> the [H, W, w * w] view of each pixel's
    window, taps in row-major (dy, dx) order."""
    taps = padded.unfold(-2, window, 1).unfold(-2, window, 1)
    return taps.reshape(*taps.shape[:-2], window * window)


def subpixel_refine(cost_volume: torch.Tensor,
                    disparity: torch.Tensor) -> torch.Tensor:
    """Parabolic sub-pixel interpolation around the winning disparity:
    d* = d + (c[d-1] - c[d+1]) / (2 (c[d-1] - 2 c[d] + c[d+1])), offset
    clamped to [-0.5, 0.5]; border disparities (0, D-1) and flat or
    non-finite parabolas keep d.  Returns float32 [H, W]."""
    max_disp = cost_volume.shape[-1]
    cost = cost_volume.to(torch.float32)
    d = disparity.to(torch.int64)

    def sample(shift):
        idx = (d + shift).clamp(0, max_disp - 1).unsqueeze(-1)
        return torch.gather(cost, -1, idx).squeeze(-1)

    c0, cm, cp = sample(0), sample(-1), sample(1)
    denom = cm - 2.0 * c0 + cp
    offset = torch.where(denom.abs() > 1e-12, (cm - cp) / (2.0 * denom), 0.0)
    offset = offset.clamp(-0.5, 0.5)
    valid = (d > 0) & (d < max_disp - 1) & torch.isfinite(denom)
    d = d.to(torch.float32)
    return torch.where(valid, d + offset, d)


def median3x3_from_padded(padded: torch.Tensor) -> torch.Tensor:
    """The 3x3 median of each pixel of a float [H + 2, W + 2] plane padded
    by one on each side (shared with the sharded pipeline, which fills
    the row pad from its neighbours' halo rows)."""
    return _windows(padded, 3).sort(dim=-1).values[..., 4]


def median_filter_3x3(disparity: torch.Tensor) -> torch.Tensor:
    """3x3 median (edge-replicated), in the input dtype."""
    x = disparity.to(torch.float32)
    padded = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return median3x3_from_padded(padded).to(disparity.dtype)


def left_right_consistency(disp_left: torch.Tensor,
                           disp_right: torch.Tensor, max_diff: int = 1,
                           max_disparity: Optional[int] = None
                           ) -> torch.Tensor:
    """Occlusion mask of the left-right cross check (True = consistent):
    |dL(x) - dR(x - dL(x))| <= max_diff, with dL(x) in [0, n_planes)
    (``max_disparity``, else the width, at most the width) and x - dL(x)
    in the image."""
    width = disp_left.shape[-1]
    d_r = disp_right.to(torch.int32)
    n_planes = width if max_disparity is None else min(max_disparity, width)
    far = torch.full(d_r.shape[:-1] + (width,), _FAR, dtype=torch.int32,
                     device=d_r.device)
    padded_r = torch.cat([far, d_r], dim=-1)
    return consistency_from_padded(disp_left, padded_r, pad=width,
                                   n_planes=n_planes, max_diff=max_diff)


def consistency_from_padded(d_l: torch.Tensor, padded_r: torch.Tensor, *,
                            pad: int, n_planes: int,
                            max_diff: int) -> torch.Tensor:
    """Core of :func:`left_right_consistency` given the right disparities
    padded with ``pad`` columns on the LEFT (out-of-image pad positions
    hold a value never within ``max_diff``, e.g. -2^20).  A pixel with
    dL = d reads column pad - d + x of the pad, the start taken as the
    JAX package's ``lax.dynamic_slice`` takes it (a negative start counts
    from the row's end, then clamps into the row: only where d > pad);
    leading (batch) dimensions broadcast through."""
    d_l = d_l.to(torch.int32)
    width, padded_width = d_l.shape[-1], padded_r.shape[-1]
    x = torch.arange(width, device=d_l.device)
    start = pad - d_l.to(torch.int64)
    start = torch.where(start < 0, start + padded_width, start)
    start = start.clamp(0, padded_width - width)
    shifted = torch.gather(padded_r.to(torch.int32), -1, start + x)
    return ((d_l >= 0) & (d_l < n_planes)
            & ((d_l - shifted).abs() <= max_diff))


def confidence_pkrn(cost_volume: torch.Tensor) -> torch.Tensor:
    """Peak-ratio confidence (c2 - c1) / max(c2, 1e-12) in [0, 1], c1 <= c2
    the two smallest finite costs (a duplicated minimum gives c2 = c1);
    pixels with fewer than two finite costs get 0."""
    cost = cost_volume.to(torch.float32)
    inf = float("inf")
    cost = torch.where(torch.isfinite(cost), cost, inf)
    c1 = cost.amin(dim=-1)
    is_min = cost == c1.unsqueeze(-1)
    duplicated = is_min.sum(dim=-1) > 1
    c2 = torch.where(is_min, inf, cost).amin(dim=-1)
    c2 = torch.where(duplicated & torch.isfinite(c1), c1, c2)
    conf = torch.where(torch.isfinite(c2),
                       (c2 - c1) / c2.clamp_min(1e-12), 0.0)
    return conf.clamp(0.0, 1.0)


def weighted_median_filter(disparity: torch.Tensor, guide: torch.Tensor, *,
                           window: int = 5, sigma: float = 0.1,
                           n_bins: int = 256) -> torch.Tensor:
    """Guide-weighted median of the rounded disparities (bins 0..n_bins-1):
    each pixel's weighted median over its ``window`` neighbourhood, a
    neighbour q weighing exp(-(G(q) - G(p))^2 / (2 sigma^2)) and
    out-of-image neighbours nothing.  Returns the smallest bin whose
    cumulative weight reaches half the total, in the input dtype."""
    r = window // 2
    bins = disparity.to(torch.float32).round().clamp(0, n_bins - 1)
    g = guide.to(torch.float32)
    g_pad = F.pad(g, (r, r, r, r), value=float("inf"))
    b_pad = F.pad(bins, (r, r, r, r)).to(torch.int32)
    return _wmf_from_padded(b_pad, g_pad, g, window=window, sigma=sigma,
                            n_bins=n_bins).to(disparity.dtype)


def wmf_weights(g_pad: torch.Tensor, g: torch.Tensor, *, window: int,
                sigma: float) -> torch.Tensor:
    """The [H, W, window^2] affinities of each pixel's taps, in tap order:
    exp((G(q) - G(p))^2 * (-0.5 / sigma^2)), 0 where the guide pad is
    +inf (out of the image)."""
    inv = float(np.float32(-0.5) / np.float32(sigma) ** 2)
    gq = _windows(g_pad, window)
    w = exp_f32((gq - g.unsqueeze(-1)) ** 2 * inv)
    return torch.where(torch.isfinite(gq), w, 0.0)


def _wmf_from_padded(b_pad, g_pad, g, *, window, sigma, n_bins):
    """Weighted-median core on (window//2)-padded bin and guide planes
    (guide pad +inf wherever out of the image), shared with the sharded
    pipeline; returns int32 [H, W] median bins.

    W(b), the weight of the taps of bins <= b, is monotone in b and
    changes only at the taps' own bins, so the smallest b with W(b) >=
    half the total is the smallest tap bin that passes.  Each tap's W is
    summed over the taps in tap order, as the JAX package sums it (its
    bisection evaluates the same sums at other bins).  The centre tap
    weighs 1, so half > 0 and some tap always passes.  ``n_bins`` bounds
    the bins already clipped into ``b_pad``."""
    del n_bins
    w = wmf_weights(g_pad, g, window=window, sigma=sigma)
    bins = _windows(b_pad, window)
    total = torch.zeros_like(g)
    cum = torch.zeros_like(w)
    for t in range(w.shape[-1]):
        total = total + w[..., t]
        cum = cum + torch.where(bins[..., t:t + 1] <= bins,
                                w[..., t:t + 1], 0.0)
    passed = torch.where(cum >= (0.5 * total).unsqueeze(-1), bins,
                         torch.iinfo(torch.int32).max)
    return passed.amin(dim=-1)


def _thomas_forward(diag, off, b, off_prev, cp0, dp0):
    """Thomas forward elimination over the LAST axis (vectorised over the
    leading axes): cp_x = off_x / (diag_x - off_prev_x cp_{x-1}),
    dp_x = (b_x - off_prev_x dp_{x-1}) / (same), seeded by ``cp0``/
    ``dp0`` (zeros at a true border; the previous tile's last values
    when the solve axis is split).  Each product-and-difference is one
    fused multiply-add, as XLA contracts it.  Returns (cps, dps)."""
    off = off.movedim(-1, 0).contiguous()
    # Loop-invariant float64 operands of the fused steps (numeric.fma).
    diag, b, neg_off_prev = (t.movedim(-1, 0).to(torch.float64).contiguous()
                             for t in (diag, b, -off_prev))
    cps, dps = torch.empty_like(off), torch.empty_like(off)
    cp, dp = cp0, dp0
    for x in range(off.shape[0]):
        denom = fma(neg_off_prev[x], cp, diag[x])
        cp = off[x] / denom
        dp = fma(neg_off_prev[x], dp, b[x]) / denom
        cps[x], dps[x] = cp, dp
    return cps.movedim(0, -1), dps.movedim(0, -1)


def _thomas_backward(cps, dps, u_next0):
    """Back substitution v_x = dp_x - cp_x v_{x+1} (one fused
    multiply-add), in reverse over the last axis, seeded by ``u_next0``
    from beyond the last element (zero at a true border; the next tile's
    first solution when split)."""
    neg_cps, dps = (t.movedim(-1, 0).to(torch.float64).contiguous()
                    for t in (-cps, dps))
    out = torch.empty(neg_cps.shape, dtype=torch.float32,
                      device=neg_cps.device)
    u = u_next0
    for x in range(out.shape[0] - 1, -1, -1):
        u = fma(neg_cps[x], u, dps[x])
        out[x] = u
    return out.movedim(0, -1)


def _fgs_confidence(u, confidence):
    """Data-term weights: ones, or the confidence floored at 1e-3 (an
    all-zero line stays well posed; the sharded pipeline shares it)."""
    if confidence is None:
        return torch.ones_like(u)
    return confidence.to(torch.float32).clamp_min(1e-3)


def _fgs_lambda_schedule(lam, total, t):
    """The attenuated lambda of round t of ``total``, telescoping to
    ``lam``: 1.5 lam 4^(T-t) / (4^T - 1), rounded as XLA rounds it under
    ``jit``, where ``lam`` is a float32 value and the rest constants: the
    division becomes a product with the float32 reciprocal, folded with
    the other constants into one float32 factor."""
    factor = (np.float32(1.5 * 4.0 ** (total - t))
              * np.float32(1.0 / (4.0 ** total - 1.0)))
    return lam * float(factor)


def _fgs_system(u, c, a_left, a_right, lam):
    """The tridiagonal normal equations of one 1-D WLS subproblem:
    (diag, off, b, off_prev), ``a_left``/``a_right`` the smoothness
    weights toward x-1 / x+1 (zero beyond true borders); the diagonal's
    product and sum are one fused multiply-add, as XLA contracts them."""
    diag = fma(lam.expand(c.shape), a_left + a_right, c)
    off = -lam * a_right
    off_prev = -lam * a_left
    return diag, off, c * u, off_prev


def _fgs_pass(u, c, a, lam):
    """One exact 1-D weighted-least-squares pass along the LAST axis:
    minimises sum c (v - u)^2 + lam sum a_x (v_x - v_{x+1})^2 per line;
    ``a`` has one fewer element along the last axis."""
    zero = torch.zeros_like(u[..., :1])
    a_right = torch.cat([a, zero], dim=-1)
    a_left = torch.cat([zero, a], dim=-1)
    diag, off, b, off_prev = _fgs_system(u, c, a_left, a_right, lam)
    z = torch.zeros_like(u[..., 0])
    cps, dps = _thomas_forward(diag, off, b, off_prev, z, z)
    return _thomas_backward(cps, dps, z)


def fgs_smooth(disparity: torch.Tensor, guide: torch.Tensor, *,
               lam: float = 128.0, sigma_color: float = 8.0,
               iterations: int = 3,
               confidence: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fast global smoother (Min et al., TIP 2014): ``iterations`` rounds
    of exact row then column WLS solves with the attenuated lambda,
    smoothness weights exp(-|dG| / sigma_color), data weights the
    ``confidence`` (zero-confidence pixels are inpainted).  float32."""
    u = disparity.to(torch.float32)
    g = guide.to(torch.float32)
    c = _fgs_confidence(u, confidence)
    inv_sigma = float(np.float32(-1.0) / np.float32(sigma_color))
    a_h = exp_f32((g[..., :, 1:] - g[..., :, :-1]).abs() * inv_sigma)
    a_v = exp_f32((g[..., 1:, :] - g[..., :-1, :]).abs() * inv_sigma)
    # A float32 0-d tensor: the schedule's arithmetic rounds in float32,
    # as JAX's does on its float32 lambda.
    lam = torch.tensor(lam, dtype=torch.float32, device=g.device)
    for t in range(1, iterations + 1):
        lam_t = _fgs_lambda_schedule(lam, iterations, t)
        u = _fgs_pass(u, c, a_h, lam_t)
        u = _fgs_pass(u.transpose(-1, -2), c.transpose(-1, -2),
                      a_v.transpose(-1, -2), lam_t).transpose(-1, -2)
    return u


def speckle_mask(disparity: torch.Tensor, *, max_diff: float = 1.0,
                 window: int = 9, min_frac: float = 0.25) -> torch.Tensor:
    """True where at least ceil(min_frac * n) of the n in-image pixels of
    the ``window`` around a pixel lie within ``max_diff`` of it."""
    r = window // 2
    d = disparity.to(torch.float32)
    padded = F.pad(d, (r, r, r, r), value=float("nan"))
    return _windowed_support(padded, d, max_diff=max_diff, window=window,
                            min_frac=min_frac)


def _windowed_support(padded, center, *, max_diff, window, min_frac):
    """Support test given a NaN-padded (window//2 per side) plane, shared
    with the sharded pipeline (neighbour-row halos, NaN at the image's
    edges)."""
    taps = padded.unfold(-2, window, 1).unfold(-2, window, 1)
    near = (taps - center[..., None, None]).abs() <= max_diff
    similar = near.sum(dim=(-2, -1))
    n_in = (~torch.isnan(taps)).sum(dim=(-2, -1))
    need = torch.ceil(min_frac * n_in.to(torch.float32)).to(torch.int64)
    return similar >= need


def filter_speckles(disparity: torch.Tensor, *, max_diff: float = 1.0,
                    window: int = 9, min_frac: float = 0.25,
                    fill: str = "zero",
                    invalid_value: float = 0) -> torch.Tensor:
    """Replace the pixels :func:`speckle_mask` rejects: with
    ``invalid_value`` (``fill="zero"``) or the smaller of the nearest
    supported disparities along the row (``fill="background"``, float)."""
    if fill not in ("zero", "background"):
        raise ValueError(f"unknown fill mode: {fill!r}")
    mask = speckle_mask(disparity, max_diff=max_diff, window=window,
                        min_frac=min_frac)
    return _apply_speckle_fill(disparity, mask, fill, invalid_value)


def _apply_speckle_fill(disparity, mask, fill, invalid_value=0):
    if fill == "zero":
        return torch.where(mask, disparity,
                           torch.tensor(invalid_value, dtype=disparity.dtype,
                                        device=disparity.device))
    return fill_inconsistent(disparity, mask).to(
        torch.promote_types(disparity.dtype, torch.float32))


def right_disparity(pipeline_fn: Callable, left: torch.Tensor,
                    right: torch.Tensor) -> torch.Tensor:
    """Right-image disparity from a left-disparity pipeline: match the
    mirrored pair (flip(right), flip(left)) and mirror the result back.
    ``torch.flip`` copies, so the kernels receive contiguous images."""
    return pipeline_fn(right.flip(-1), left.flip(-1)).flip(-1)


def right_volume_from_left(cost_volume: torch.Tensor) -> torch.Tensor:
    """The right view's volume C_R[y, x, d] = C_L[y, x + d, d] (+inf where
    x + d >= W), in the volume's dtype."""
    max_disp = cost_volume.shape[-1]
    pad = torch.full(cost_volume.shape[:-2] + (max_disp, max_disp),
                     float("inf"), dtype=cost_volume.dtype,
                     device=cost_volume.device)
    padded = torch.cat([cost_volume, pad], dim=-2)
    return right_volume_from_padded(padded, width=cost_volume.shape[-2])


def right_volume_from_padded(padded: torch.Tensor,
                             width: int) -> torch.Tensor:
    """Core of :func:`right_volume_from_left` given a volume extended on
    the RIGHT of the W axis by at least D - 1 columns: [..., width, D]
    with out[..., x, d] = padded[..., x + d, d], read as the diagonal of
    the width-long windows of the W axis."""
    max_disp = padded.shape[-1]
    windows = padded.unfold(-2, width, 1)[..., :max_disp, :, :]
    return torch.diagonal(windows, dim1=-3, dim2=-2).contiguous()


def right_disparity_from_volume(cost_volume: torch.Tensor) -> torch.Tensor:
    """WTA right disparity from the left volume (lowest-d ties)."""
    return winner_takes_all(right_volume_from_left(cost_volume))


def fill_inconsistent(disparity: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fill masked-out pixels with the SMALLER of the nearest consistent
    disparities to the left and right along the row (occlusions belong
    to the background); a side with none defers to the other, and a row
    with none keeps its values.  float32."""
    d = disparity.to(torch.float32)
    valid = mask.to(torch.bool)
    left_fill = propagate_last_valid(d, valid)
    right_fill = propagate_last_valid(d.flip(-1), valid.flip(-1)).flip(-1)
    fill = torch.fmin(left_fill, right_fill)
    filled = torch.where(valid, d, fill)
    return torch.where(torch.isnan(filled), d, filled)


def propagate_last_valid(vals: torch.Tensor,
                         ok: torch.Tensor) -> torch.Tensor:
    """Per row, the last valid value at or left of each position along the
    last axis (NaN where there is none yet): the ``cummax`` of the valid
    positions picks it."""
    pos = torch.arange(vals.shape[-1], device=vals.device)
    last = torch.where(ok, pos, -1).cummax(dim=-1).values
    picked = torch.gather(vals, -1, last.clamp_min(0))
    return torch.where(last >= 0, picked, float("nan"))
