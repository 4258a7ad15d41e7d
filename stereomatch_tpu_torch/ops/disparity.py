"""Disparity reducers: cost volume [H, W, D] -> disparity image [H, W] int32.

Port of ``stereomatch_tpu/ops/disparity.py``: ``winner_takes_all`` and
the scanline dynamic programming (``dynamic_programming``,
``dynamic_programming_with_paths``, and the chunk forms
``dp_forward_chunk``/``dp_backward_chunk`` that the 2-D tiles hand
across column tiles).  These are plain PyTorch and run on
any device; for the DP they are the oracle of the CUDA kernels in
``ops/dp_cuda.py``.

Winner-takes-all: like ``jnp.argmin`` there, ``torch.argmin`` is a
library reduction and not a kernel of this repository.  Ties break
toward the LOWER disparity (the reference CPU semantics,
winners_take_all.cu:29-37): ``torch.argmin`` returns the first minimal
index on the CPU and on CUDA.

Dynamic programming (reference ``src/dynamic_programming.cu:184-225``):
a per-row forward pass over W,
    acc[w, d] = C[w, d] + min(acc[w-1, d-1], acc[w-1, d], acc[w-1, d+1])
(+inf beyond the band), recording int8 back-pointers by the reference's
comparison chain (dynamic_programming.cu:50-59):
    -1 if c(d-1) <  c(d) and c(d-1) < c(d+1)
     0 elif c(d)  <  c(d+1)
    +1 otherwise;
then the argmin of the final column (ties to the lowest d) and a
right-to-left walk d[w] = clip(d[w+1] + ptr[w, d[w+1]], 0, D-1).
Column 0 seeds from the raw cost and its pointers are 0 (the JAX
package's documented deviation from the reference, whose column-0
pointers are uninitialised).  Every step is one float32 add after exact
comparisons, so the result equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch


def winner_takes_all(cost_volume: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmin over disparity; ties -> lower disparity. int32 [H, W]."""
    return torch.argmin(cost_volume, dim=2).to(torch.int32)


def dp_forward_chunk(cost_volume: torch.Tensor, init_acc=None):
    """DP forward pass over a chunk of columns of a float32 [H, Wc, D]
    volume, exposing the accumulator (the JAX ``dp_forward_chunk``).

    ``init_acc`` [H, D] is the accumulator after the column left of the
    chunk (the hand-off from the tile that holds those columns); None
    marks the scanline start, where column 0 seeds from the raw cost and
    gets pointer 0.  Returns (back-pointers int8 [H, Wc, D], final
    accumulator [H, D]).
    """
    height, width, max_disp = cost_volume.shape
    cost = cost_volume.to(torch.float32)
    ptr = torch.zeros((height, width, max_disp), dtype=torch.int8,
                      device=cost.device)
    inf_col = torch.full((height, 1), float("inf"), dtype=torch.float32,
                         device=cost.device)
    minus = torch.full((), -1, dtype=torch.int8, device=cost.device)
    zero = torch.full((), 0, dtype=torch.int8, device=cost.device)
    plus = torch.full((), 1, dtype=torch.int8, device=cost.device)
    if init_acc is None:
        acc, first = cost[:, 0].clone(), 1
    else:
        acc, first = init_acc.to(device=cost.device,
                                 dtype=torch.float32), 0
    for w in range(first, width):
        c1 = torch.cat([inf_col, acc[:, :-1]], dim=1)        # acc[d-1]
        c2 = acc
        c3 = torch.cat([acc[:, 1:], inf_col], dim=1)         # acc[d+1]
        take1 = (c1 < c2) & (c1 < c3)
        take2 = c2 < c3
        ptr[:, w] = torch.where(take1, minus, torch.where(take2, zero, plus))
        acc = cost[:, w] + torch.where(take1, c1, torch.where(take2, c2, c3))
    return ptr, acc


def dp_forward(cost_volume: torch.Tensor):
    """DP forward pass over a float32 [H, W, D] volume.

    Returns (back-pointers int8 [H, W, D], final accumulator [H, D]).
    """
    return dp_forward_chunk(cost_volume)


def dp_end_disparities(final_costs: torch.Tensor) -> torch.Tensor:
    """Argmin of the final column per row, ties -> lowest d. int32 [H]."""
    return torch.argmin(final_costs, dim=1).to(torch.int32)


def dp_backward_chunk(path_volume: torch.Tensor, current: torch.Tensor,
                      emit_current: bool):
    """Right-to-left pointer walk over a chunk of columns (the JAX
    ``dp_backward_chunk``).

    ``current`` [H] is the disparity decided for the column right of the
    chunk (the scanline end's argmin for the rightmost chunk).  With
    ``emit_current`` (the rightmost chunk) it is written at the last
    column and the walk reads pointer columns Wc-2..0; otherwise the
    walk reads all Wc columns.  Returns (disparities int32 [H, Wc], the
    leftmost decided disparity [H], the next chunk's ``current``).
    """
    height, width, max_disp = path_volume.shape
    rows = torch.arange(height, device=path_volume.device)
    disp = torch.empty((height, width), dtype=torch.int32,
                       device=path_volume.device)
    cur = current.to(device=path_volume.device, dtype=torch.int64)
    last = width - 1
    if emit_current:
        disp[:, last] = cur.to(torch.int32)
        last -= 1
    for w in range(last, -1, -1):
        step = path_volume[rows, w, cur].to(torch.int64)
        cur = (cur + step).clamp(0, max_disp - 1)
        disp[:, w] = cur.to(torch.int32)
    return disp, cur.to(torch.int32)


def dp_backward(path_volume: torch.Tensor,
                end_disparities: torch.Tensor) -> torch.Tensor:
    """Right-to-left pointer walk from the end disparities. int32 [H, W]."""
    return dp_backward_chunk(path_volume, end_disparities,
                             emit_current=True)[0]


def dynamic_programming(cost_volume: torch.Tensor) -> torch.Tensor:
    """Scanline dynamic-programming disparity. int32 [H, W]."""
    return dynamic_programming_with_paths(cost_volume)[0]


def dynamic_programming_with_paths(cost_volume: torch.Tensor):
    """The DP exposing its intermediates, as the JAX package's variant:
    (disparity int32 [H, W], pointers int8 [H, W, D], final costs
    float32 [H, D])."""
    path_volume, final_costs = dp_forward(cost_volume)
    disparity = dp_backward(path_volume, dp_end_disparities(final_costs))
    return disparity, path_volume, final_costs
