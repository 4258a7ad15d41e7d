"""Launcher of the guided-filter aggregation CUDA kernels (``csrc/cvf.cu``).

Replaces ``stereomatch_tpu/ops/cvf_pallas.py::_fused_wedge_ring_kernel``
in both its forms (full width, and W-chunked at HD): one design serves
every geometry.  The plain PyTorch version, and oracle, is
``ops/cvf.py::guided_filter_aggregate``; the guide planes
(``ops/cvf.guide_planes``) are the same PyTorch code for both, and the
kernels keep the plain version's association (window-order box sums, H
then W, and fused multiply-adds where it fuses), so ``chip_smoke.py`` and
the card tests hold the two equal bit for bit, +inf placement included.

A bf16 volume goes through the kernels' bf16 instantiations: the stats
kernel reads it as it is and the filter kernel rounds q once to bf16 as
it stores it; a0 and b0 stay float32.  ``_build.LAUNCHES`` counts the
launches of each entry point of the two kernels (stage 1 -> a0, b0:
``stm_cvf_stats_*``; stage 2 -> q: ``stm_cvf_filter_*``).
"""

from __future__ import annotations

import torch

from . import _build
from .cvf import (GuidePlanes, check_filter_args, check_volume_and_guide,
                  guide_planes)

VOLUME_DTYPES = (torch.float32, torch.bfloat16)

_REFUSED = -1       # csrc/cvf.cu: no tile of the radius fits shared memory

# The largest radius whose tiles fit one block's shared memory in both
# kernels (csrc/cvf.cu:73, tile_of: the filter kernel's smallest tile
# outgrows the card's 227 KB at r = 35; the stats kernel's, at r = 45).
MAX_RADIUS = 34


def fits(radius: int) -> bool:
    """Whether the kernels serve a filter of ``radius`` (any volume
    shape, either dtype).  The launcher raises ``ValueError`` exactly
    where this is false, and ``backend="auto"`` sends such filters to the
    plain version."""
    return radius <= MAX_RADIUS


def guided_filter_aggregate_cuda(cost_volume: torch.Tensor,
                                 guide: torch.Tensor, *, radius: int = 8,
                                 eps: float = 1e-4,
                                 wedge_offset: int = 0) -> torch.Tensor:
    """Wedge guided filter of a float32 or bf16 [H, W, D] CUDA volume:
    [H, W, D] in its dtype with +inf on the wedge ``x < d + wedge_offset``."""
    check_volume_and_guide(cost_volume, guide)
    if wedge_offset is None:
        raise ValueError("the CVF kernels serve the wedge path only; the "
                         "generic masked path is ops.cvf."
                         "guided_filter_aggregate(wedge_offset=None)")
    check_filter_args(int(radius), float(eps), wedge_offset=wedge_offset)
    r, off = int(radius), int(wedge_offset)
    planes = guide_planes(guide, r, off, cost_volume.shape[2])
    return _launch_kernels(cost_volume, planes, r, float(eps), off)


def _check_cuda(cost_volume: torch.Tensor, guide: torch.Tensor) -> None:
    if not (cost_volume.is_cuda and guide.is_cuda):
        raise ValueError("guided_filter_aggregate_cuda needs CUDA tensors, "
                         f"got {cost_volume.device} and {guide.device}")
    if cost_volume.device != guide.device:
        raise ValueError(f"tensors on two devices: {cost_volume.device}, "
                         f"{guide.device}")
    if cost_volume.dtype not in VOLUME_DTYPES:
        raise TypeError("the CVF kernels take float32 or bfloat16 volumes, "
                        f"got {cost_volume.dtype}")


def _launch_kernels(cost_volume: torch.Tensor, planes: GuidePlanes,
                    radius: int, eps: float,
                    wedge_offset: int) -> torch.Tensor:
    """The stats and filter launches on precomputed guide planes
    (``guide_planes(guide, radius, wedge_offset, D)``)."""
    _check_cuda(cost_volume, planes.guide)
    height, width, max_disp = cost_volume.shape
    vol = cost_volume.contiguous()
    a0 = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    b0 = torch.empty_like(a0)
    out = torch.empty_like(vol)
    if vol.numel() == 0:
        return out
    bf16 = vol.dtype == torch.bfloat16
    stats, filt = (f"stm_cvf_{stage}_{'bf16' if bf16 else 'f32'}"
                   for stage in ("stats", "filter"))
    lib = _build.library()
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, stats)(
            vol.data_ptr(), planes.guide.data_ptr(), planes.hi1.data_ptr(),
            planes.lo1.data_ptr(), planes.hi2.data_ptr(),
            planes.lo2.data_ptr(), planes.pd1.data_ptr(),
            planes.pd2.data_ptr(), a0.data_ptr(), b0.data_ptr(), height,
            width, max_disp, radius, wedge_offset, eps, stream)
        _check_status(stats, status, radius)
        status = getattr(lib, filt)(
            a0.data_ptr(), b0.data_ptr(), planes.guide.data_ptr(),
            out.data_ptr(), height, width, max_disp, radius, wedge_offset,
            stream)
        _check_status(filt, status, radius)
    return out


def _check_status(name: str, status: int, radius: int) -> None:
    if status == _REFUSED:
        raise ValueError(f"{name}: radius {radius} needs more shared memory "
                         "than one block has, even at the smallest tile")
    _build.check_launch(name, status)
