"""Disparity quality metrics, the counterpart of
``stereomatch_tpu/metrics.py``: RMSE, average absolute error and the
bad-pixel ratio, each over the valid ground-truth pixels (finite and
> 0: Middlebury's PFMs, and the synthetic scenes, mark unknown pixels
with 0 or inf), plus the sparsification diagnostics of a confidence map
and the markdown table of ``stm-eval``.

The three metrics are PyTorch reductions on the predicted disparity's
device (numpy arrays go to the CPU); their float32 sums run in another
order than XLA's, so they agree with the JAX package's within 1e-6
relative.  The sparsification curve is host-side numpy, as there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .pipeline import as_tensor, host_array


def _tensors(predicted, gt_disparity):
    """Both as float32 tensors on the predicted disparity's device."""
    predicted = as_tensor(predicted).to(torch.float32)
    return predicted, as_tensor(gt_disparity, predicted.device).to(
        torch.float32)


def _valid_mask(gt: torch.Tensor) -> torch.Tensor:
    """Valid ground truth: finite and strictly positive."""
    return torch.isfinite(gt) & (gt > 0)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().clamp_min(1)


def rmse(predicted, gt_disparity) -> torch.Tensor:
    pred, gt = _tensors(predicted, gt_disparity)
    mask = _valid_mask(gt)
    diff = pred - gt
    sq = torch.where(mask, diff * diff, 0.0)
    return torch.sqrt(sq.sum() / _count(mask))


def avg_abs_error(predicted, gt_disparity) -> torch.Tensor:
    pred, gt = _tensors(predicted, gt_disparity)
    mask = _valid_mask(gt)
    return torch.where(mask, (pred - gt).abs(), 0.0).sum() / _count(mask)


def bad_pixel_ratio(predicted, gt_disparity,
                    threshold: float = 2.0) -> torch.Tensor:
    """Fraction of valid pixels whose |error| exceeds ``threshold`` (the
    Middlebury "bad2.0"-style metric)."""
    pred, gt = _tensors(predicted, gt_disparity)
    mask = _valid_mask(gt)
    bad = mask & ((pred - gt).abs() > threshold)
    return bad.sum().to(torch.float32) / _count(mask).to(torch.float32)


def evaluate(predicted, gt_disparity,
             threshold: float = 2.0) -> Dict[str, float]:
    """All three metrics as Python floats."""
    return {
        "rmse": float(rmse(predicted, gt_disparity)),
        "avg_abs_error": float(avg_abs_error(predicted, gt_disparity)),
        "bad_pixel_ratio": float(bad_pixel_ratio(predicted, gt_disparity,
                                                 threshold=threshold)),
    }


def sparsification_curve(predicted, gt_disparity, confidence,
                         threshold: float = 2.0, steps: int = 20):
    """Bad-pixel ratio of the kept pixels as the least-confident fraction
    is removed.  Host-side numpy.  Returns ``(fractions_removed, curve,
    oracle_curve)``: ``curve[i]`` after dropping ``fractions_removed[i]``
    of the valid pixels in ascending-confidence order, ``oracle_curve``
    dropping them in descending-|error| order."""
    pred = host_array(predicted).astype(np.float32)
    gt = host_array(gt_disparity).astype(np.float32)
    conf = host_array(confidence).astype(np.float32)
    mask = np.isfinite(gt) & (gt > 0)
    err = np.abs(pred - gt)[mask]
    bad = (err > threshold).astype(np.float64)
    conf = conf[mask]
    n = bad.size
    if n == 0:
        flat = np.zeros(steps + 1)
        return np.linspace(0.0, 1.0, steps + 1), flat, flat

    # Most-confident-first prefix: the suffix is what gets removed.
    by_conf = np.cumsum(bad[np.argsort(-conf, kind="stable")])
    by_err = np.cumsum(bad[np.argsort(err, kind="stable")])
    fractions = np.linspace(0.0, 1.0, steps + 1)
    keep = np.maximum((n * (1.0 - fractions)).astype(np.int64), 1)
    curve = by_conf[keep - 1] / keep
    oracle = by_err[keep - 1] / keep
    return fractions, curve, oracle


def sparsification_ause(predicted, gt_disparity, confidence,
                        threshold: float = 2.0, steps: int = 20) -> float:
    """Area under the sparsification error: the mean gap between the
    confidence-ordered and the oracle-ordered curves (0 = the confidence
    ranks pixels as well as knowing the true error)."""
    _, curve, oracle = sparsification_curve(predicted, gt_disparity,
                                            confidence, threshold=threshold,
                                            steps=steps)
    return float(np.mean(curve - oracle))


def metrics_markdown_table(rows) -> str:
    """Per-config metric rows (dicts with name/rmse/avg_abs_error/
    bad_pixel_ratio and optionally ause, which adds a column when any
    row carries it) as a markdown table."""
    with_ause = any("ause" in row for row in rows)
    header = "| config | rmse | avg abs err | bad pixel % |"
    rule = "|---|---|---|---|"
    if with_ause:
        header += " AUSE |"
        rule += "---|"
    lines = [header, rule]
    for row in rows:
        line = (f"| {row['name']} | {row['rmse']:.4f} | "
                f"{row['avg_abs_error']:.4f} | "
                f"{row['bad_pixel_ratio'] * 100:.2f} |")
        if with_ause:
            line += (f" {row['ause']:.4f} |" if "ause" in row else " — |")
        lines.append(line)
    return "\n".join(lines)
