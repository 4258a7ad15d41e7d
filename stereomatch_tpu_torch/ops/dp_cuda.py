"""Launchers of the scanline DP CUDA kernels (``csrc/dp.cu``).

Replace, in ``stereomatch_tpu/ops/dp_pallas.py``, ``_forward_kernel``
(``dp_forward_kernel``) and ``_backward_kernel`` (``dp_backward_kernel``).
The plain PyTorch version, and oracle, is ``ops/disparity.py``
(``dp_forward``, ``dp_backward``); on the same inputs the two are equal
bit for bit: the forward pass is exact comparisons and one float32 add
per step, the walk integer arithmetic.

The launchers take CUDA tensors only, check them, allocate their outputs
with ``torch.empty``, launch on the current stream and raise if a launch
failed.  A bf16 cost volume goes to the forward kernel as it is
(``stm_dp_forward_bf16`` widens each cost as it reads it, where the plain
version widens the volume first); any other dtype (the int32 chain) is
widened to float32 first, as the plain version widens it; the pointers
and final costs do not change.  ``_build.LAUNCHES`` counts the launches
of each entry point, so a run can show that it went through both
kernels.
"""

from __future__ import annotations

import torch

from . import _build

MAX_DISPARITY = 512         # 32 lanes x 16 registers per lane


def fits(shape) -> bool:
    """Whether the kernels serve an [H, W, D] cost volume: D within the
    ``MAX_DISPARITY`` registers of a warp.  The launchers raise
    ``ValueError`` exactly where this is false, and ``backend="auto"``
    sends such volumes to the plain version."""
    return shape[-1] <= MAX_DISPARITY


def _check_volume(name: str, t: torch.Tensor, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
    if t.dtype not in dtypes or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous "
                         f"{' or '.join(str(d) for d in dtypes)} [H, W, D] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.shape[2] > MAX_DISPARITY:
        raise ValueError(f"D={t.shape[2]} exceeds the kernels' "
                         f"{MAX_DISPARITY}")


def dp_forward_cuda(cost_volume: torch.Tensor):
    """Forward pass on the card: (pointers int8 [H, W, D], final costs
    float32 [H, D]).  A float32 or bf16 volume is read as it is, any other
    is widened to float32."""
    cost = cost_volume
    if cost.dtype not in (torch.float32, torch.bfloat16):
        cost = cost.to(torch.float32)
    cost = cost.contiguous()
    _check_volume("dp_forward_cuda", cost, (torch.float32, torch.bfloat16))
    height, width, max_disp = cost.shape
    ptr = torch.empty((height, width, max_disp), dtype=torch.int8,
                      device=cost.device)
    final = torch.empty((height, max_disp), dtype=torch.float32,
                        device=cost.device)
    if cost.numel() == 0:
        return ptr, final
    bf16 = cost.dtype == torch.bfloat16
    name = f"stm_dp_forward_{'bf16' if bf16 else 'f32'}"
    with torch.cuda.device(cost.device):
        status = getattr(_build.library(), name)(
            cost.data_ptr(), ptr.data_ptr(), final.data_ptr(), height, width,
            max_disp, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)
    return ptr, final


def dp_backward_cuda(path_volume: torch.Tensor,
                     final_costs: torch.Tensor) -> torch.Tensor:
    """Final-column argmin and pointer walk on the card: int32 [H, W]."""
    _check_volume("dp_backward_cuda", path_volume, (torch.int8,))
    height, width, max_disp = path_volume.shape
    if (final_costs.device != path_volume.device
            or final_costs.dtype != torch.float32
            or tuple(final_costs.shape) != (height, max_disp)
            or not final_costs.is_contiguous()):
        raise ValueError(f"final costs must be a contiguous float32 "
                         f"[{height}, {max_disp}] tensor beside the pointers")
    disp = torch.empty((height, width), dtype=torch.int32,
                       device=path_volume.device)
    if path_volume.numel() == 0:
        return disp
    lib = _build.library()
    with torch.cuda.device(path_volume.device):
        status = lib.stm_dp_backward(
            path_volume.data_ptr(), final_costs.data_ptr(), disp.data_ptr(),
            height, width, max_disp,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("stm_dp_backward", status)
    return disp


def dynamic_programming_cuda(cost_volume: torch.Tensor) -> torch.Tensor:
    """Scanline DP disparity int32 [H, W] on the card: both kernels."""
    return dp_backward_cuda(*dp_forward_cuda(cost_volume))
