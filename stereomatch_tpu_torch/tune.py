"""Gradient-based SGM penalty tuning, the counterpart of
``stereomatch_tpu/tune.py``.

The scan-based SGM is differentiable (``ops/soft.py``), so the penalties
(P1, P2) become learnable parameters: Adam descends a Huber loss between
the soft-argmin disparity and ground truth.  The cost volumes do not
depend on the penalties, so they are built once; each step runs the
aggregation and soft-argmin of every scene forward (the scenes batched
into the scans' rows) and autograd takes it back.

The optimiser arithmetic is the JAX package's, in plain torch (optax is
not needed): ``jax.nn.softplus`` is ``logaddexp(x, 0)`` on XLA's CPU
polynomials (:func:`softplus`, whose backward is ``exp(x - softplus(x))``
as JAX's), ``optax.huber_loss`` is :func:`huber_loss`, and one
``optax.adam`` update is :func:`adam_step`, in the form XLA compiles it
(:func:`adam_step` says which).  Those three equal JAX's bit for bit;
the loss's sums and the softmax are torch's, so the histories agree with
the JAX package's within a tolerance (``tests/test_torch_tune.py``).

Typical use (the synthetic ground-truth scenes, offline)::

    from stereomatch_tpu_torch import tune
    result = tune.tune_penalties([(left, right, gt)], max_disparity=32,
                                 cost="census")
    pipeline = create_pipeline("census", "wta", "sgm",
                               penalty1=result.penalty1,
                               penalty2=result.penalty2)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .ops import cost as cost_ops
from .ops.soft import semiglobal_aggregate_diff, soft_argmin
from .pipeline import Device, as_tensor
from .utils.numeric import exp_f32, fma, log1p_f32, sqrt_f32


class TuneResult(NamedTuple):
    """Tuned penalties plus the optimisation trace."""
    penalty1: float
    penalty2: float
    loss_history: np.ndarray     # [steps]
    penalty_history: np.ndarray  # [steps, 2]


class _Softplus(torch.autograd.Function):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it on XLA's CPU, with
    JAX's derivative ``exp(x - softplus(x))``."""

    @staticmethod
    def forward(ctx, x):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        out = torch.maximum(x, zero) + log1p_f32(exp_f32(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * exp_f32(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), differentiable; not
    ``torch.nn.functional.softplus``, which turns linear above 20."""
    return _Softplus.apply(x.to(torch.float32))


def softplus_inv(y: float) -> float:
    """The inverse of softplus, in float64 numpy (linear from 20)."""
    y = float(y)
    return float(np.log(np.expm1(y))) if y < 20 else y


def huber_loss(errors: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss``: 0.5 q^2 + delta (|e| - q), q = min(|e|, delta)."""
    abs_errors = errors.abs()
    quadratic = torch.minimum(abs_errors, torch.full(
        (), delta, dtype=abs_errors.dtype, device=abs_errors.device))
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(theta: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(theta), torch.zeros_like(theta))


def adam_step(theta: torch.Tensor, grad: torch.Tensor, state: AdamState, *,
              learning_rate: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8):
    """One ``optax.adam`` update (eps_root = 0) applied to ``theta``, in
    the arithmetic XLA compiles for it on the CPU: the moments as
    ``fma(g, 1 - b, b m)``, the bias corrections ``1 - b**t`` in float32
    (``powf``), the update ``mu / ((1 - b1**t) (sqrt(nu / (1 - b2**t)) +
    eps))`` (XLA folds the first division into the denominator) and
    ``fma(update, -lr, theta)``.  Returns (theta, state)."""
    def const(value):
        return torch.full((), value, dtype=torch.float32, device=theta.device)

    count = state.count + 1
    mu = fma(grad, const(1 - b1), state.mu * const(b1))
    nu = fma(grad * grad, const(1 - b2), state.nu * const(b2))
    bc1 = const(1 - np.float32(b1) ** np.float32(count))
    bc2 = const(1 - np.float32(b2) ** np.float32(count))
    update = mu / (bc1 * (sqrt_f32(nu / bc2) + const(eps)))
    theta = fma(update, const(-learning_rate), theta)
    return theta, AdamState(count, mu, nu)


def _build_volumes(scenes, *, cost, max_disparity, kernel_size,
                   census_window, device):
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
    vols, imgs, gts = [], [], []
    for left, right, gt in scenes:
        left = as_tensor(left, device).to(torch.float32)
        right = as_tensor(right, device).to(torch.float32)
        kw = dict(max_disparity=max_disparity, kernel_size=kernel_size)
        if cost in ("ssd", "ssd-texture"):
            vol = cost_ops.ssd_cost_volume(left, right, **kw)
        elif cost == "sad":
            vol = cost_ops.sad_cost_volume(left, right, **kw)
        elif cost == "ncc":
            vol = cost_ops.zncc_cost_volume(left, right, **kw)
        elif cost == "census":
            vol = cost_ops.census_hamming_cost_volume(
                left, right, window_size=census_window, **kw)
        elif cost == "birchfield":
            vol = cost_ops.birchfield_cost_volume(left, right, **kw)
        else:
            raise ValueError(f"unknown cost {cost!r}")
        vols.append(vol)
        imgs.append(left)
        gts.append(as_tensor(np.asarray(gt), device).to(torch.float32))
    return torch.stack(vols), torch.stack(imgs), torch.stack(gts)


def tune_penalties(scenes: Sequence, *, max_disparity: int,
                   cost: str = "census",
                   kernel_size: Optional[int] = None,
                   census_window: int = 5,
                   steps: int = 60,
                   learning_rate: float = 0.05,
                   tau: float = 2.0,
                   init_penalty1: float = 0.1,
                   init_penalty2: float = 0.2,
                   huber_delta: float = 1.0,
                   valid_masks=None,
                   device: Device = "cuda") -> TuneResult:
    """Fit SGM penalties (P1, P2) by gradient descent on a disparity loss.

    Args:
      scenes: sequence of ``(left, right, gt_disparity)`` triples with one
        common shape; gt in pixels (float or int).
      max_disparity / cost / kernel_size / census_window: cost-volume
        configuration, as in the CLI registries (float32 volumes).
      steps / learning_rate: Adam schedule length and step size.
      tau: soft-argmin temperature, in cost units.
      init_penalty1/2: the starting point (the reference defaults).
      huber_delta: Huber loss transition point, in disparity pixels.
      valid_masks: optional [S, H, W] bool, the pixels scored.  Default:
        columns >= max_disparity (where every hypothesis is valid).
      device: where the volumes live and the steps run: the card unless
        ``"cpu"`` is asked for.

    Returns:
      TuneResult with positive tuned penalties and per-step histories.
    """
    vols, imgs, gts = _build_volumes(
        scenes, cost=cost, max_disparity=max_disparity,
        kernel_size=kernel_size, census_window=census_window, device=device)
    if valid_masks is None:
        mask = np.zeros(tuple(gts.shape), bool)
        mask[:, :, max_disparity:] = True
    else:
        mask = np.asarray(valid_masks, bool)
    denom = np.float32(max(int(mask.sum()), 1))
    mask = torch.from_numpy(mask).to(gts.device)
    zero = torch.zeros((), dtype=torch.float32, device=gts.device)

    def loss_fn(theta):
        penalties = softplus(theta)
        agg = semiglobal_aggregate_diff(vols, imgs, penalties[0],
                                        penalties[1])
        disp = soft_argmin(agg, tau)
        loss = huber_loss(disp - gts, delta=huber_delta)
        return torch.where(mask, loss, zero).sum() / float(denom)

    theta = torch.tensor([softplus_inv(init_penalty1),
                          softplus_inv(init_penalty2)],
                         dtype=torch.float32).to(gts.device)
    state = adam_init(theta)
    losses, penalties = [], []
    for _ in range(steps):
        theta = theta.detach().requires_grad_(True)
        loss = loss_fn(theta)
        (grad,) = torch.autograd.grad(loss, theta)
        theta, state = adam_step(theta.detach(), grad, state,
                                 learning_rate=learning_rate)
        losses.append(float(loss.detach()))
        penalties.append(softplus(theta).cpu().numpy())
    p1, p2 = (float(x) for x in softplus(theta).cpu())
    return TuneResult(penalty1=p1, penalty2=p2,
                      loss_history=np.asarray(losses, np.float32),
                      penalty_history=np.asarray(penalties, np.float32))
