"""Differentiable SGM surface: gradient-safe aggregation and soft-argmin,
the counterpart of ``stereomatch_tpu/ops/soft.py``.

Plain PyTorch on any device: autograd differentiates the same scans that
``jax.grad`` differentiates there.  No Pallas kernel reaches the JAX
module (its scan is XLA's ``lax.scan``), so none is ported; on the card
the forward pass equals the SGM kernels' aggregation bit for bit.

Two details make the stock recurrence (``ops/aggregation.py``) unsafe
to differentiate, and this one avoids both, as the JAX module does:

* Path starts: the stock scan seeds with a select against an all-+inf
  carry, whose discarded branch is NaN, and ``0 * NaN`` poisons the
  backward pass.  Here the carry seeds with uniform zeros, and the
  column a diagonal enters through reads a zero fill: after
  normalisation the band is ``min(0, P1, P1, P2_adj) = 0``, so the first
  step emits ``cost`` exactly, with no data-dependent select.
* The adaptive penalty ``P2 / |dI|`` divides by zero on flat rows
  (+inf drops the term, as in the forward pass).  Its backward pass would
  be ``cotangent / |dI|``, ``0 * inf = NaN``; ``|dI|`` is floored at
  1e-30 instead, which changes no selectable candidate.

The forward pass keeps ``sgm_scan_with_carry``'s association and equals
``ops.aggregation.semiglobal_aggregate`` bit for bit.  The function is
differentiable in (volume, penalties): the image is detached (torch's
``|x|`` has gradient 0 at 0 where JAX's has 1, and the division's
backward for the floored denominator would give ``0 * inf``).  Ties
split their cotangent as JAX splits it: ``torch.amin`` over D evenly,
``torch.minimum``/``torch.maximum`` half to each side.

Scenes batch into the scans: a [B, H, W, D] volume runs each sweep's
steps once for all B scenes (the JAX package vmaps the unbatched
function); every step is elementwise, so each scene's result is the one
it has alone.
"""

from __future__ import annotations

import torch

from .aggregation import TRAVERSALS, sgm_band

# The floor on |dI| of the adaptive penalty (the JAX module's _GRAD_EPS).
_GRAD_EPS = 1e-30


def _penalty(value, device) -> torch.Tensor:
    """A penalty as a float32 0-d tensor on ``device``; a tensor keeps its
    autograd graph."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _diff_scan(cost_sv, image_sv, p1, p2, carry_shift):
    """One gradient-safe SGM sweep over scan-major [S, B, N, D] inputs
    ([S, B, N] intensities); returns the contributions [S, B, N, D]."""
    n = cost_sv.shape[2]
    device = cost_sv.device
    edge = torch.zeros((n,), dtype=torch.bool, device=device)
    if carry_shift > 0:
        edge[0] = True
    elif carry_shift < 0:
        edge[n - 1] = True
    zero = torch.zeros((), dtype=torch.float32, device=device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
    eps = torch.full((), _GRAD_EPS, dtype=torch.float32, device=device)

    def shift_n(arr):
        # Zero fill at the diagonal's entry column: a uniform row
        # normalises to band = 0, the fresh-path re-seed, without a select.
        if carry_shift == 0:
            return arr
        mask = edge[:, None] if arr.ndim == 3 else edge
        return torch.where(mask, zero, torch.roll(arr, carry_shift, 1))

    prev = cost_sv.new_zeros(cost_sv.shape[1:], dtype=torch.float32)
    prev_int = cost_sv.new_zeros(cost_sv.shape[1:3], dtype=torch.float32)
    inf_col = inf.expand(*cost_sv.shape[1:3], 1)
    contributions = []
    for s in range(cost_sv.shape[0]):
        intensity = image_sv[s]
        prev = shift_n(prev)
        prev_int = shift_n(prev_int)

        prev = cost_sv[s] + sgm_band(prev, prev_int, intensity, p1, p2,
                                     inf_col, grad_floor=eps)
        prev_int = intensity
        contributions.append(prev)
    return torch.stack(contributions)


def _sweep(cost, image, p1, p2, step):
    """The traversal ``step`` = (dy, dx) of ``ops.aggregation.TRAVERSALS``
    over a [B, H, W, D] volume and [B, H, W] images."""
    dy, dx = step
    if dy == 0:                                   # horizontal: scan over W
        vol = cost.permute(2, 0, 1, 3)            # [W, B, H, D]
        img = image.permute(2, 0, 1)
        shift, dims = 0, (0,)
    else:                                         # scan over H
        vol = cost.permute(1, 0, 2, 3)            # [H, B, W, D]
        img = image.permute(1, 0, 2)
        shift = 0 if dx == 0 else (1 if dy == dx else -1)
        dims = (0,) if dx == 0 else (0, 2)
    reverse = (dx < 0) if dy == 0 else (dy < 0)
    if reverse:
        vol, img = vol.flip(dims), img.flip(dims)
    out = _diff_scan(vol, img, p1, p2, shift)
    if reverse:
        out = out.flip(dims)
    return out.permute(1, 2, 0, 3) if dy == 0 else out.permute(1, 0, 2, 3)


def semiglobal_aggregate_diff(cost_volume: torch.Tensor,
                              left_image: torch.Tensor,
                              penalty1, penalty2) -> torch.Tensor:
    """8-path SGM aggregation, differentiable in (volume, penalties).

    ``cost_volume`` is [H, W, D] (or [B, H, W, D], B scenes in one scan)
    and ``left_image`` [H, W] (or [B, H, W]); the penalties are floats or
    0-d tensors (tensors carry their gradients; one call serves every
    value).  Equal to ``ops.aggregation.semiglobal_aggregate`` in the
    forward pass bit for bit; the result has the volume's dtype.
    """
    batched = cost_volume.ndim == 4
    cost = cost_volume.to(torch.float32)
    image = left_image.detach().to(torch.float32)
    if not batched:
        cost, image = cost[None], image[None]
    p1 = _penalty(penalty1, cost.device)
    p2 = _penalty(penalty2, cost.device)
    out = None
    for step in TRAVERSALS:
        part = _sweep(cost, image, p1, p2, step)
        out = part if out is None else out + part
    if not batched:
        out = out[0]
    return out.to(cost_volume.dtype)


def soft_argmin(volume: torch.Tensor, tau=1.0) -> torch.Tensor:
    """Differentiable disparity: the softmax(-volume / tau) expectation of
    d over the last axis.

    The continuous relaxation of winner-takes-all: +inf cells (d > x)
    get exactly zero weight, and as ``tau -> 0`` the expectation
    approaches the hard argmin wherever the minimum is unique.  ``tau``
    is a float or a 0-d tensor.
    """
    tau = _penalty(tau, volume.device)
    d = torch.arange(volume.shape[-1], dtype=torch.float32,
                     device=volume.device)
    w = torch.softmax(-volume.to(torch.float32) / tau, dim=-1)
    return (w * d).sum(dim=-1)
