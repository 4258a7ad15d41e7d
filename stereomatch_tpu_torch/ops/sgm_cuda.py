"""Launchers of the SGM path-traversal CUDA kernels (``csrc/sgm.cu``).

Replace, in ``stereomatch_tpu/ops/sgm_pallas.py``, ``_sweep_kernel``
(vertical and diagonal families: ``sgm_rows_kernel``) and
``_hsweep_kernel_natural`` (horizontal family:
``sgm_horizontal_kernel``).  The plain PyTorch version, and oracle, is
``ops/aggregation.py::semiglobal_aggregate``; on the same inputs the two
are equal bit for bit: the recurrence is only IEEE-rounded sub/add/div
and exact min/max, and the eight traversals accumulate in the plain
version's order, one launch each.

``ROW_LAUNCHES`` and ``HORIZONTAL_LAUNCHES`` count the launches of the
two kernels, so a run can show that it went through both.
"""

from __future__ import annotations

import torch

from . import _build
from .aggregation import TRAVERSALS

ROW_LAUNCHES = 0
HORIZONTAL_LAUNCHES = 0

MAX_DISPARITY = 512         # 32 lanes x 16 registers per lane


def _check(cost: torch.Tensor, image: torch.Tensor) -> None:
    if not (cost.is_cuda and image.is_cuda):
        raise ValueError("the SGM kernels need CUDA tensors, got "
                         f"{cost.device} and {image.device}")
    if cost.device != image.device:
        raise ValueError(f"tensors on two devices: {cost.device}, "
                         f"{image.device}")
    if cost.dtype != torch.float32 or image.dtype != torch.float32:
        raise TypeError(f"SGM kernels take float32 tensors, got "
                        f"{cost.dtype} and {image.dtype}")
    if cost.ndim != 3 or tuple(cost.shape[:2]) != tuple(image.shape):
        raise ValueError(f"cost volume {tuple(cost.shape)} does not match "
                         f"image {tuple(image.shape)}")
    if not (cost.is_contiguous() and image.is_contiguous()):
        raise ValueError("SGM kernels take contiguous tensors")
    if cost.shape[2] > MAX_DISPARITY:
        raise ValueError(f"D={cost.shape[2]} exceeds the kernels' "
                         f"{MAX_DISPARITY}")


def traverse_cuda(cost: torch.Tensor, image: torch.Tensor,
                  out: torch.Tensor, step: tuple, penalty1: float,
                  penalty2: float, accumulate: bool) -> None:
    """One traversal with pixel step ``step`` = (dy, dx): writes its path
    costs into ``out`` (``accumulate=False``) or adds them in place."""
    global ROW_LAUNCHES, HORIZONTAL_LAUNCHES
    _check(cost, image)
    if out.shape != cost.shape or out.dtype != torch.float32 \
            or out.device != cost.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor shaped "
                         "and placed like the cost volume")
    if cost.numel() == 0:
        return
    dy, dx = step
    lib = _build.library()
    if dy == 0:
        name, fn = "stm_sgm_horizontal", lib.stm_sgm_horizontal_f32
    else:
        name, fn = "stm_sgm_rows", lib.stm_sgm_rows_f32
    height, width, max_disp = cost.shape
    with torch.cuda.device(cost.device):
        status = fn(cost.data_ptr(), image.data_ptr(), out.data_ptr(),
                    height, width, max_disp, dy, dx, float(penalty1),
                    float(penalty2), int(accumulate),
                    torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)
    if dy == 0:
        HORIZONTAL_LAUNCHES += 1
    else:
        ROW_LAUNCHES += 1


def semiglobal_aggregate_cuda(cost_volume: torch.Tensor,
                              left_image: torch.Tensor, *,
                              penalty1: float = 0.1,
                              penalty2: float = 0.2) -> torch.Tensor:
    """8-direction SGM aggregation [H, W, D] float32 on the card: the
    traversals of ``TRAVERSALS`` in order, accumulated in place."""
    cost = cost_volume.contiguous()
    image = left_image.to(torch.float32).contiguous()
    _check(cost, image)
    out = torch.empty_like(cost)
    for i, step in enumerate(TRAVERSALS):
        traverse_cuda(cost, image, out, step, penalty1, penalty2,
                      accumulate=i > 0)
    return out
