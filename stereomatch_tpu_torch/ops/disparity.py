"""Disparity reducers: cost volume [H, W, D] -> disparity image [H, W] int32.

Port of ``stereomatch_tpu/ops/disparity.py::winner_takes_all``.  Like
``jnp.argmin`` there, ``torch.argmin`` is a library reduction and not a
kernel of this repository.  Ties break toward the LOWER disparity (the
reference CPU semantics, winners_take_all.cu:29-37): ``torch.argmin``
returns the first minimal index on the CPU and on CUDA.
"""

from __future__ import annotations

import torch


def winner_takes_all(cost_volume: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmin over disparity; ties -> lower disparity. int32 [H, W]."""
    return torch.argmin(cost_volume, dim=2).to(torch.int32)
