"""Launcher of the windowed SSD/SAD CUDA kernel (``csrc/ssd.cu``).

Replaces ``stereomatch_tpu/ops/ssd_pallas.py::_cost_kernel``.  Its plain
PyTorch version, and oracle, is ``ops/cost.py::_diff_cost_volume``; on
the same inputs the two are equal bit for bit (the kernel keeps the
plain version's summation order and rounds every operation on its own).

The launcher takes CUDA tensors only: it checks device, dtype and shape,
allocates the output with ``torch.empty``, launches on the current
stream and raises if the launch failed.  A ``kernel_size`` whose tile
fits no block's shared memory is refused with a ``ValueError`` before any
launch.  A bf16 volume is the float32 chain with each output rounded once
as it is stored (``stm_ssd_bf16``), as the plain version rounds it.
``_build.LAUNCHES`` counts the launches of each entry point, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .cost import compute_dtype

_ENTRIES = {torch.float32: "stm_ssd_f32", torch.int32: "stm_ssd_i32",
            torch.bfloat16: "stm_ssd_bf16"}

_REFUSED = -1               # csrc/ssd.cu: no tile of the k fits shared memory

_MAX_GRID_Y = 65535         # the block grid's y extent carries the rows


def diff_cost_volume_cuda(left: torch.Tensor, right: torch.Tensor, *,
                          max_disparity: int, kernel_size: int,
                          cost_dtype: torch.dtype,
                          absolute: bool) -> torch.Tensor:
    """SSD (``absolute=False``) or SAD cost volume [H, W, D] on the card."""
    if not (left.is_cuda and right.is_cuda):
        raise ValueError("diff_cost_volume_cuda needs CUDA tensors, got "
                         f"{left.device} and {right.device}")
    if left.device != right.device:
        raise ValueError(f"images on two devices: {left.device}, "
                         f"{right.device}")
    if left.ndim != 2 or left.shape != right.shape:
        raise ValueError("images must be two [H, W] tensors of one shape, "
                         f"got {tuple(left.shape)} and {tuple(right.shape)}")
    if cost_dtype not in _ENTRIES:
        raise TypeError(f"cost_dtype must be float32, bfloat16 or int32, "
                        f"got {cost_dtype}")
    if max_disparity < 1 or kernel_size < 1:
        raise ValueError("max_disparity and kernel_size must be positive")
    height, width = left.shape
    if height > _MAX_GRID_Y:
        raise ValueError(f"height {height} exceeds the kernel's "
                         f"{_MAX_GRID_Y}-row grid")
    cdt = compute_dtype(cost_dtype)
    left_c = left.to(cdt).contiguous()
    right_c = right.to(cdt).contiguous()
    out = torch.empty((height, width, max_disparity), dtype=cost_dtype,
                      device=left.device)
    if out.numel() == 0:
        return out
    name = _ENTRIES[cost_dtype]
    fn = getattr(_build.library(), name)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(left_c.data_ptr(), right_c.data_ptr(), out.data_ptr(),
                    height, width, max_disparity, kernel_size,
                    int(absolute), stream)
    if status == _REFUSED:
        raise ValueError(f"{name}: kernel_size {kernel_size} needs more "
                         "shared memory than one block has, even at the "
                         "smallest tile")
    _build.check_launch(name, status)
    return out
