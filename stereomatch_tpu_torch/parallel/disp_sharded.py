"""Disparity-block sharding, the counterpart of
``stereomatch_tpu/parallel/disp_sharded.py``: the D axis of cost (+ CVF)
+ WTA split into blocks over the devices of a one-axis ``disp`` mesh.

Each block [offset, offset + D/n) is built on its device from the whole
images (copied there: they are small against the volume), so no halo
crosses blocks.  SGM and DP reduce over all of D at every step and stay
whole-D (the row and 2-D tile partitioners); guided-filter aggregation
is per disparity slice, so it composes.  The blocks' minima and arg
minima cross to the mesh's first device (over processes, to each
device's owner, for that device's rows), where

    global_min = min over blocks of local_min
    disparity  = min over blocks of (local_argmin + offset
                                     where local_min == global_min)

gives the single-device ``winner_takes_all`` bit for bit, ties to the
lowest disparity included: the lowest block holding the minimum wins,
and a pixel that is +inf in every block gets 0.

On the card a block's SSD/SAD volume is one launch of the SSD kernel
(``ssd_cuda``, K1) on the offset crop, and its guided filter the CVF
kernels (``cvf_cuda``, K9) with ``wedge_offset`` = the block's offset:
a block's +inf cells are exactly ``x < d + offset``.  That is the
single-card registry's wedge path restricted to the block.  On the CPU
the filter is the plain masked path, as the JAX package filters each
block (its ``guided_filter_aggregate`` with no ``wedge_offset``).
Census, Birchfield and ZNCC have no kernel (plain PyTorch on any
device).  In one process, one process drives every block; with one card
a block, the blocks run concurrently.  Over processes (``make_disp_mesh``
of the world's devices), each rank builds only its own blocks, the rows
of every block's (minimum, argmin) that a device's output rows need move
to that device's owner (``transport.exchange``: JAX's ``pmin``, whose
result each device slices to its rows), are combined there in block
order, and each rank returns its shards: its devices' rows of [H, W],
as JAX's output spec ``P(disp, None)`` lays them out.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..aggregation import CostFilter
from ..cost import _diff_cost_dispatch
from ..ops import cost as cost_ops
from ..pipeline import as_tensor
from . import transport
from .mesh import Mesh, world_layout
from .sharded import _cost_dtype

DISP_AXIS = "disp"
_COSTS = ("ssd", "ssd-texture", "birchfield", "census", "sad", "ncc")


def make_disp_mesh(devices: Optional[Sequence] = None,
                   n_disp: Optional[int] = None) -> Mesh:
    """A one-axis ``disp`` mesh over the first ``n_disp`` of ``devices``
    (this process's; devices may repeat, e.g. ``[torch.device("cpu")] *
    8``), by default of the world's devices (every visible card of one
    process).  With no card and no ``devices`` it raises: there is no CPU
    fallback.  In a world of several processes the default spans them,
    each rank owning its own devices' blocks."""
    processes = None
    if devices is None:
        devices, processes = world_layout("make_disp_mesh()")
    devices = list(devices)
    if n_disp is None:
        n_disp = len(devices)
    return Mesh(devices[:n_disp], axis_names=(DISP_AXIS,),
                processes=None if processes is None else processes[:n_disp])


def make_disp_sharded_wta(mesh: Mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          cost_dtype=torch.float32,
                          aggregation: Optional[str] = None,
                          cvf_radius: int = 8,
                          cvf_eps: float = 1e-4) -> Callable:
    """Cost (+ CVF) + WTA with the disparity axis split over ``mesh``.

    Returns ``fn(left, right) -> disparity``: two [H, W] images (numpy or
    tensors, any device) -> [H, W] int32 on the mesh's first device,
    equal to the single-device ``winner_takes_all(cost(...))`` (with
    ``aggregation="cvf"``, of the filtered volume) bit for bit.  Over
    processes: this rank's shards, one ``(index, tensor)`` pair per mesh
    device it owns, ``index`` = (its H / n_disp rows, ``slice(None)``),
    the tensor on the device.  CUDA
    blocks run the kernels where they serve the shape (``backend="auto"``
    of the cost and filter classes), CPU blocks the plain versions.
    """
    if cost not in _COSTS:
        raise ValueError(f"unknown cost {cost!r}")
    if aggregation not in (None, "cvf"):
        raise ValueError(f"unknown aggregation {aggregation!r} (disparity "
                         "sharding supports None or 'cvf')")
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
    dtype = _cost_dtype(cost_dtype)
    devices = mesh.devices
    n_disp = mesh.shape[DISP_AXIS]
    if max_disparity % n_disp:
        raise ValueError(f"max_disparity {max_disparity} not divisible by "
                         f"disp axis {n_disp}")
    block = max_disparity // n_disp

    def volume(left, right, offset):
        kw = dict(max_disparity=block, disparity_offset=offset)
        if cost in ("ssd", "ssd-texture", "sad"):
            return _diff_cost_dispatch(
                left, right, kernel_size=kernel_size, cost_dtype=dtype,
                absolute=cost == "sad", backend="auto", **kw)
        if cost == "ncc":
            return cost_ops.zncc_cost_volume(
                left, right, kernel_size=kernel_size, cost_dtype=dtype, **kw)
        if cost == "census":
            return cost_ops.census_hamming_cost_volume(
                left, right, kernel_size=kernel_size, cost_dtype=dtype, **kw)
        return cost_ops.birchfield_cost_volume(
            left, right, kernel_size=kernel_size, **kw)

    def local(left, right, offset):
        """One block's (minimum, global argmin) maps on its device."""
        vol = volume(left, right, offset).to(torch.float32)
        if aggregation == "cvf":
            # The block's wedge on the card (the CVF kernels); the masked
            # path on the CPU, as the JAX package filters a block.
            wedge = offset if vol.is_cuda else None
            vol = CostFilter(cvf_radius, cvf_eps,
                             wedge_offset=wedge)(vol, left)
        low, arg = torch.min(vol, dim=2)     # the first minimum's index
        return low, arg.to(torch.int32) + offset

    def fn(left, right) -> torch.Tensor:
        left = as_tensor(left).to(torch.float32)
        right = as_tensor(right).to(torch.float32)
        if left.ndim != 2 or left.shape != right.shape:
            raise ValueError(f"expected two [H, W] images of one shape, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        height, width = left.shape
        if height % n_disp:
            raise ValueError(f"height {height} not divisible by disp axis "
                             f"{n_disp} (output row slicing)")
        if cost == "ncc" and max_disparity > width + 1:
            raise ValueError(
                f"disparity-sharded ncc needs max_disparity {max_disparity} "
                f"<= W + 1 = {width + 1} (a block's offset would overrun "
                "the [H, W+1] prefix plane)")
        parts = [local(left.to(dev), right.to(dev), i * block)
                 if mesh.owns((i,)) else transport.Remote(owner, dev)
                 for i, (dev, owner) in enumerate(zip(devices,
                                                      mesh.processes))]
        if not mesh.spans_processes:
            first = devices[0]
            return global_argmin([tuple(x.to(first) for x in part)
                                  for part in parts])
        rows = height // n_disp
        moves = []
        for i, (dev, owner) in enumerate(zip(devices, mesh.processes)):
            there = transport.Remote(owner, dev)
            for part in parts:
                for x in (part if transport.is_local(part) else (part,) * 2):
                    if transport.is_local(x):
                        x = x[i * rows:(i + 1) * rows]
                    moves.append((x, there))
        landed = transport.exchange(moves, "disp_minima")
        shards = []
        for i in range(n_disp):
            if mesh.owns((i,)):
                mine = landed[2 * n_disp * i:2 * n_disp * (i + 1)]
                shards.append(((slice(i * rows, (i + 1) * rows),
                                slice(None)),
                               global_argmin(list(zip(mine[::2],
                                                      mine[1::2])))))
        return shards

    return fn


def global_argmin(parts) -> torch.Tensor:
    """The disparity map from the blocks' (minimum, global argmin) maps,
    in block order on one device: the lowest global argmin among the
    blocks whose minimum is the least, which is the single-device
    ``argmin``'s first minimum (every block +inf: block 0's argmin,
    0)."""
    global_min = parts[0][0]
    for part_min, _ in parts[1:]:
        global_min = torch.minimum(global_min, part_min)
    far = torch.full((), 2 ** 30, dtype=torch.int32,
                     device=global_min.device)
    disparity = None
    for part_min, part_arg in parts:
        candidate = torch.where(part_min == global_min, part_arg, far)
        disparity = (candidate if disparity is None
                     else torch.minimum(disparity, candidate))
    return disparity
