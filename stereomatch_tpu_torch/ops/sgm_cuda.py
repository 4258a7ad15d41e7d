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

A bf16 cost volume goes through the same kernels' bf16 instantiations
(in ``csrc/sgm.cu``): they read bf16 costs, keep the recurrence, the
carries and the partial sum ``out`` in float32, and the launch of the
last traversal stores ``out + L`` rounded once to bf16 into a separate
``result``, as the plain version (and XLA) round the float32 sum once.

``_build.LAUNCHES`` counts the launches of each entry point
(``stm_sgm_{rows,horizontal,chunk}_{f32,bf16}``), so a run can show that
it went through them.
"""

from __future__ import annotations

import torch

from . import _build
from .aggregation import TRAVERSALS

VOLUME_DTYPES = (torch.float32, torch.bfloat16)

MAX_DISPARITY = 512         # 32 lanes x 16 registers per lane


def fits(shape) -> bool:
    """Whether the kernels serve an [H, W, D] cost volume (or a chunk of
    one): D within the ``MAX_DISPARITY`` registers of a warp.  The
    launchers raise ``ValueError`` exactly where this is false, and
    ``backend="auto"`` sends such volumes to the plain version."""
    return shape[-1] <= MAX_DISPARITY


def _check_out(out: torch.Tensor, like: torch.Tensor, name: str,
               dtype: torch.dtype = torch.float32) -> None:
    if out.shape != like.shape or out.dtype != dtype \
            or out.device != like.device or not out.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                         f"shaped {tuple(like.shape)} on {like.device}")


def _check_result(result, out, cost, accumulate) -> None:
    """A result (the last traversal of a bf16 volume) is a bf16 tensor
    beside ``out``, which the launch adds onto and does not write."""
    if result is None:
        return
    if cost.dtype != torch.bfloat16 or not accumulate:
        raise ValueError("a result takes the accumulated sum of a bf16 "
                         "volume's traversals: accumulate=True on bf16 costs")
    _check_out(result, out, "result", torch.bfloat16)


def _check(cost: torch.Tensor, image: torch.Tensor) -> None:
    if not (cost.is_cuda and image.is_cuda):
        raise ValueError("the SGM kernels need CUDA tensors, got "
                         f"{cost.device} and {image.device}")
    if cost.device != image.device:
        raise ValueError(f"tensors on two devices: {cost.device}, "
                         f"{image.device}")
    if cost.dtype not in VOLUME_DTYPES or image.dtype != torch.float32:
        raise TypeError(f"SGM kernels take float32 or bfloat16 costs and a "
                        f"float32 image, got {cost.dtype} and {image.dtype}")
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
                  penalty2: float, accumulate: bool,
                  result: torch.Tensor = None) -> None:
    """One traversal with pixel step ``step`` = (dy, dx): writes its path
    costs into ``out`` (float32; ``accumulate=False``) or adds them in
    place.  For a bf16 ``cost``, ``result`` (bf16) takes the accumulated
    sum rounded to bf16 instead of ``out``, which is then only read: the
    last traversal of a row family."""
    _check(cost, image)
    _check_out(out, cost, "out")
    _check_result(result, out, cost, accumulate)
    if cost.numel() == 0:
        return
    dy, dx = step
    bf16 = cost.dtype == torch.bfloat16
    if dy == 0 and result is not None:
        raise ValueError("the last traversal is a row traversal; a "
                         "horizontal one takes no result")
    lib = _build.library()
    family = "horizontal" if dy == 0 else "rows"
    name = f"stm_sgm_{family}_{'bf16' if bf16 else 'f32'}"
    fn = getattr(lib, name)
    args = [cost.data_ptr(), image.data_ptr(), out.data_ptr()]
    if bf16 and dy != 0:
        args.append(0 if result is None else result.data_ptr())
    height, width, max_disp = cost.shape
    with torch.cuda.device(cost.device):
        status = fn(*args, height, width, max_disp, dy, dx, float(penalty1),
                    float(penalty2), int(accumulate),
                    torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)


def semiglobal_aggregate_cuda(cost_volume: torch.Tensor,
                              left_image: torch.Tensor, *,
                              penalty1: float = 0.1,
                              penalty2: float = 0.2) -> torch.Tensor:
    """8-direction SGM aggregation [H, W, D] on the card, in the cost's
    dtype: the traversals of ``TRAVERSALS`` in order, accumulated in place
    into a float32 volume; for a bf16 cost the last traversal rounds the
    sum into the bf16 result."""
    cost = cost_volume.contiguous()
    image = left_image.to(torch.float32).contiguous()
    _check(cost, image)
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    result = None
    if cost.dtype == torch.bfloat16:
        result = torch.empty_like(cost)
    last = len(TRAVERSALS) - 1
    for i, step in enumerate(TRAVERSALS):
        traverse_cuda(cost, image, out, step, penalty1, penalty2,
                      accumulate=i > 0, result=result if i == last else None)
    return out if result is None else result


def sweep_chunk_with_carry_cuda(cost: torch.Tensor, image: torch.Tensor,
                                step: tuple, carry=None, carry_image=None, *,
                                penalty1: float, penalty2: float, seed: bool,
                                out: torch.Tensor = None,
                                accumulate: bool = False,
                                result: torch.Tensor = None):
    """One row traversal over a chunk of rows with carry hand-off, on the
    card: the counterpart of ``ops/aggregation.py::sweep_chunk_with_carry``
    (same arguments and results), plus ``out``/``accumulate``/``result``
    as :func:`traverse_cuda` takes them: the contributions are written
    into ``out`` (float32, allocated when None) or added to it in place,
    or, with ``result`` (a bf16 cost's last traversal), added to it and
    stored rounded into ``result``.  The carries are float32.

    Returns (out, or result when given, [Hc, W, D], (carry [W, D],
    intensities [W]) of the chunk's last row in scan order); the
    intensities are a view of that row of ``image``.
    """
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
                or carry.device != cost.device \
                or carry.dtype != torch.float32:
            raise ValueError(f"carry {carry.dtype} {tuple(carry.shape)} on "
                             f"{carry.device} is not the chunk's float32 "
                             f"[W, D] = {(width, max_disp)} on {cost.device}")
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True needs an out to add to")
        out = torch.empty(cost.shape, dtype=torch.float32,
                          device=cost.device)
    _check_out(out, cost, "out")
    _check_result(result, out, cost, accumulate)
    carry_out = torch.empty((width, max_disp), dtype=torch.float32,
                            device=cost.device)
    last = image[height - 1 if dy > 0 else 0]
    done = out if result is None else result
    if cost.numel() == 0:
        return done, (carry_out, last)
    bf16 = cost.dtype == torch.bfloat16
    name = f"stm_sgm_chunk_{'bf16' if bf16 else 'f32'}"
    args = [out.data_ptr()]
    if bf16:
        args.append(0 if result is None else result.data_ptr())
    carry_ptr = 0 if seed else carry.data_ptr()
    image_ptr = 0 if seed else carry_image.data_ptr()
    with torch.cuda.device(cost.device):
        status = getattr(_build.library(), name)(
            cost.data_ptr(), image.data_ptr(), carry_ptr, image_ptr, *args,
            carry_out.data_ptr(), height, width, max_disp, dy, dx,
            float(penalty1), float(penalty2), int(seed), int(accumulate),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)
    return done, (carry_out, last)
