"""Launchers of the SGM path-traversal CUDA kernels (``csrc/sgm.cu``).

Replace, in ``stereomatch_tpu/ops/sgm_pallas.py``, ``_sweep_kernel``
(vertical and diagonal families: ``sgm_rows_kernel``),
``_hsweep_kernel_natural`` (horizontal family:
``sgm_horizontal_kernel``) and ``_chunk_kernel`` with its W-on-grid form
``_chunk_kernel_wgrid`` (a row traversal over a chunk of rows with carry
in and carry out: ``sgm_chunk_kernel``).  The plain PyTorch versions, and
oracles, are ``ops/aggregation.py::semiglobal_aggregate`` and
``::sweep_chunk_with_carry``; on the same inputs each kernel equals its
plain version bit for bit: the recurrence is only IEEE-rounded
sub/add/div and exact min/max, and the traversals accumulate in the
plain version's order, one launch each.

All three kernels walk their paths the same way: operands come through a
ring of asynchronous copies eight steps deep, one path per one-warp
block; the chunk kernel adds the carry hand-off at a path's first and
last step.

``ROW_LAUNCHES``, ``HORIZONTAL_LAUNCHES`` and ``CHUNK_LAUNCHES`` count
the launches of the three kernels, so a run can show that it went
through them.
"""

from __future__ import annotations

import torch

from . import _build
from .aggregation import TRAVERSALS

ROW_LAUNCHES = 0
HORIZONTAL_LAUNCHES = 0
CHUNK_LAUNCHES = 0

MAX_DISPARITY = 512         # 32 lanes x 16 registers per lane


def _check_out(out: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if out.shape != like.shape or out.dtype != torch.float32 \
            or out.device != like.device or not out.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor "
                         f"shaped {tuple(like.shape)} on {like.device}")


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
    _check_out(out, cost, "out")
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


def sweep_chunk_with_carry_cuda(cost: torch.Tensor, image: torch.Tensor,
                                step: tuple, carry=None, carry_image=None, *,
                                penalty1: float, penalty2: float, seed: bool,
                                out: torch.Tensor = None,
                                accumulate: bool = False):
    """One row traversal over a chunk of rows with carry hand-off, on the
    card: the counterpart of ``ops/aggregation.py::sweep_chunk_with_carry``
    (same arguments and results), plus ``out``/``accumulate`` as
    :func:`traverse_cuda` takes them: the contributions are written into
    ``out`` (allocated when None) or added to it in place.

    Returns (out [Hc, W, D], (carry [W, D], intensities [W]) of the
    chunk's last row in scan order); the intensities are a view of that
    row of ``image``.
    """
    global CHUNK_LAUNCHES
    _check(cost, image)
    dy, dx = step
    if dy not in (1, -1) or dx not in (-1, 0, 1):
        raise ValueError(f"a chunk sweep takes a row traversal, got {step}")
    height, width, max_disp = cost.shape
    if not seed:
        if carry is None or carry_image is None:
            raise ValueError("a chunk that does not seed needs the carry and "
                             "intensities of the row before it")
        _check(carry[None], carry_image[None])
        if tuple(carry.shape) != (width, max_disp) \
                or carry.device != cost.device:
            raise ValueError(f"carry {tuple(carry.shape)} on {carry.device} "
                             f"does not match the chunk's [W, D] = "
                             f"{(width, max_disp)} on {cost.device}")
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True needs an out to add to")
        out = torch.empty_like(cost)
    _check_out(out, cost, "out")
    carry_out = torch.empty((width, max_disp), dtype=torch.float32,
                            device=cost.device)
    last = image[height - 1 if dy > 0 else 0]
    if cost.numel() == 0:
        return out, (carry_out, last)
    carry_ptr = 0 if seed else carry.data_ptr()
    image_ptr = 0 if seed else carry_image.data_ptr()
    with torch.cuda.device(cost.device):
        status = _build.library().stm_sgm_chunk_f32(
            cost.data_ptr(), image.data_ptr(), carry_ptr, image_ptr,
            out.data_ptr(), carry_out.data_ptr(), height, width, max_disp,
            dy, dx, float(penalty1), float(penalty2), int(seed),
            int(accumulate), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("stm_sgm_chunk", status)
    CHUNK_LAUNCHES += 1
    return out, (carry_out, last)
