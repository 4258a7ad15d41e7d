"""Device meshes for the row-sharded pipeline, the counterpart of
``stereomatch_tpu/parallel/mesh.py``.

Mesh axes, as in the JAX package:
  * ``batch`` — data parallelism over independent stereo frames; nothing
    crosses it.
  * ``tile``  — spatial parallelism over image rows (the H axis of the
    [H, W, D] cost volume); halo rows and the SGM carry hand-off move
    along it, from each tile to its neighbour.

The mesh is a grid of ``torch.device``s owned by one process: what
crosses tiles is a point-to-point chain, which cross-device ``.to()``
copies express and PyTorch orders against the streams of both devices.
A device may repeat, so several tiles can share one card (or the CPU,
as the tests run it); the same code runs over N cards unchanged.
Meshes of more than one process wait for ROADMAP A.14.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

BATCH_AXIS = "batch"
TILE_AXIS = "tile"

MULTI_PROCESS_REFUSAL = ("meshes over more than one process are not ported "
                         "to stereomatch_tpu_torch yet (ROADMAP A.14)")


def batch_tile_axes(n_devices: int, n_batch: Optional[int] = None):
    """Pick a (batch, tile) factorization of ``n_devices``.

    Defaults to the largest power-of-two batch axis that still leaves at
    least 2 tiles when possible; single-device meshes are (1, 1).
    """
    if n_batch is not None:
        if n_devices % n_batch:
            raise ValueError(
                f"n_batch={n_batch} does not divide n_devices={n_devices}")
        return n_batch, n_devices // n_batch
    if n_devices == 1:
        return 1, 1
    n_batch = 1
    while (n_devices // n_batch) % 2 == 0 and (n_devices // n_batch) > 4:
        n_batch *= 2
    return n_batch, n_devices // n_batch


class Mesh:
    """A grid of torch devices with named axes, by default the
    [n_batch, n_tile] grid of the row-sharded pipeline.

    ``devices`` nests one tuple level per axis: ``devices[b][t]`` holds
    tile ``t`` (rows ``t*Hl .. (t+1)*Hl``) of the frames of batch row
    ``b``; a one-axis mesh (``make_disp_mesh``) is a tuple of devices and
    the 2-D tile mesh (``make_mesh_2d``) a [batch][tile][tile_w] grid.
    ``shape`` is keyed by axis name like the JAX mesh's.
    """

    def __init__(self, devices, axis_names=(BATCH_AXIS, TILE_AXIS)):
        self.axis_names = tuple(axis_names)

        def grid(level, rank):
            if rank == 0:
                return torch.device(level)
            return tuple(grid(item, rank - 1) for item in level)

        def dims(level, rank):
            if rank == 0:
                return ()
            inner = {dims(item, rank - 1) for item in level}
            if not level or len(inner) != 1:
                raise ValueError("a mesh is a non-empty rectangular grid "
                                 "of devices")
            return (len(level),) + inner.pop()

        rank = len(self.axis_names)
        if rank == 0:
            raise ValueError("a mesh needs at least one axis")
        self.devices = grid(devices, rank)
        sizes = dims(self.devices, rank)
        if 0 in sizes:
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.shape = dict(zip(self.axis_names, sizes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(devices: Optional[Sequence] = None,
              n_batch: Optional[int] = None,
              n_tile: Optional[int] = None) -> Mesh:
    """Build a (batch, tile) mesh over the given devices, by default every
    visible card.  With no card and no ``devices`` it raises: there is no
    CPU fallback (pass ``[torch.device("cpu")] * n`` to run the plain
    versions on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device; pass devices= (for "
                "example [torch.device('cpu')] * 8) to build a mesh "
                "without a card")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_tile is not None and n_batch is None:
        if n % n_tile:
            raise ValueError(f"n_tile={n_tile} does not divide {n} devices")
        n_batch = n // n_tile
    n_batch, n_tile = batch_tile_axes(n, n_batch)
    return Mesh([devices[b * n_tile:(b + 1) * n_tile]
                 for b in range(n_batch)])


def process_count() -> int:
    """The processes of this job: ``torch.distributed``'s world when it is
    initialised, else the ``WORLD_SIZE`` a launcher sets, else 1."""
    import os

    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def make_hybrid_mesh(n_batch_hosts: Optional[int] = None,
                     n_tile: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Batch over hosts, tiles within a host.  In one process it is
    :func:`make_mesh` over ``devices`` (default: every visible card), the
    JAX package's single-host branch; more processes are refused."""
    if process_count() > 1:
        raise NotImplementedError(MULTI_PROCESS_REFUSAL)
    return make_mesh(devices, n_batch=n_batch_hosts, n_tile=n_tile)


def initialize_distributed(**kwargs) -> None:
    """Multi-host process bootstrap.  With no coordinator (no initialised
    ``torch.distributed`` and no ``WORLD_SIZE`` above 1) there is nothing
    to set up and it returns, as the JAX package's does; more processes
    are refused."""
    del kwargs
    if process_count() > 1:
        raise NotImplementedError(MULTI_PROCESS_REFUSAL)
