"""Device meshes for the row-sharded pipeline, the counterpart of
``stereomatch_tpu/parallel/mesh.py``.

Mesh axes, as in the JAX package:
  * ``batch`` — data parallelism over independent stereo frames; nothing
    crosses it, so it may span processes (hosts).
  * ``tile``  — spatial parallelism over image rows (the H axis of the
    [H, W, D] cost volume); halo rows and the SGM carry hand-off move
    along it, from each tile to its neighbour.

The mesh is a grid of ``torch.device``s beside a grid of the same shape
naming the process that owns each device.  Within a process, what
crosses tiles is a point-to-point chain, which cross-device ``.to()``
copies express and PyTorch orders against the streams of both devices.
A device may repeat, so several tiles can share one card (or the CPU,
as the tests run it); the same code runs over N cards unchanged.

Over several processes (``initialize_distributed``, a gloo group of
``torch.distributed``), only the batch axis may span them, as JAX's
``make_hybrid_mesh`` lays it out: each process computes the frames of
its own batch rows and no collective runs on the compute path.  A mesh
whose tile axis (or any axis but ``batch``) spans processes is refused:
that needs the halos and the carry over ``torch.distributed``
(ROADMAP A.14).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
TILE_AXIS = "tile"

# Every rank's local devices, in rank order, recorded when this process
# joined the world (initialize_distributed): the port's jax.devices().
# It mirrors the process group, which is itself state of the process.
_WORLD: Optional[List[List[torch.device]]] = None


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


def process_count() -> int:
    """The processes of this job: the size of the initialised
    ``torch.distributed`` world, else 1, as ``jax.process_count()`` is 1
    until ``jax.distributed.initialize`` runs.  A launcher's
    ``WORLD_SIZE`` alone starts no world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the initialised world, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _gather_devices(local: Sequence) -> List[List[torch.device]]:
    """Every rank's device list, in rank order (one collective)."""
    lists = [None] * process_count()
    dist.all_gather_object(lists, [str(torch.device(d)) for d in local])
    return [[torch.device(d) for d in names] for names in lists]


def world_devices() -> List[List[torch.device]]:
    """Every process's local devices, in rank order: the visible cards of
    this one process, or the lists recorded by ``initialize_distributed``
    in a world of several."""
    if process_count() == 1:
        return [_visible_cards()]
    if _WORLD is None or len(_WORLD) != process_count():
        raise RuntimeError("this torch.distributed world was not joined "
                           "through initialize_distributed(), which records "
                           "each process's devices")
    return _WORLD


def _flat(per_rank: Sequence[Sequence[torch.device]]):
    """Devices and their owners, ordered by (rank, local index), as JAX's
    multi-process fallback orders ``jax.devices()``."""
    devices = [d for local in per_rank for d in local]
    ranks = [r for r, local in enumerate(per_rank) for _ in local]
    return devices, ranks


def world_layout(caller: str):
    """The world's devices and their owners in (rank, local index) order,
    the default of ``make_mesh``, ``make_mesh_2d`` and ``make_disp_mesh``
    (``caller``); with none (no card, no recorded devices) it raises:
    there is no CPU fallback."""
    devices, ranks = _flat(world_devices())
    if not devices:
        raise RuntimeError(
            f"{caller} found no CUDA device; pass devices= (for example "
            "[torch.device('cpu')] * 8) to build a mesh without a card")
    return devices, ranks


def _rows(items: Sequence, n_batch: int, n_tile: int) -> list:
    return [list(items[b * n_tile:(b + 1) * n_tile]) for b in range(n_batch)]


class Mesh:
    """A grid of torch devices with named axes, by default the
    [n_batch, n_tile] grid of the row-sharded pipeline.

    ``devices`` nests one tuple level per axis: ``devices[b][t]`` holds
    tile ``t`` (rows ``t*Hl .. (t+1)*Hl``) of the frames of batch row
    ``b``; a one-axis mesh (``make_disp_mesh``) is a tuple of devices and
    the 2-D tile mesh (``make_mesh_2d``) a [batch][tile][tile_w] grid.
    ``shape`` is keyed by axis name like the JAX mesh's.  ``processes``,
    a grid of the same shape, holds the rank that owns each device (by
    default this process, for every device); only the batch axis may
    span processes.
    """

    def __init__(self, devices, axis_names=(BATCH_AXIS, TILE_AXIS),
                 processes=None):
        self.axis_names = tuple(axis_names)

        def grid(level, rank, leaf):
            if rank == 0:
                return leaf(level)
            return tuple(grid(item, rank - 1, leaf) for item in level)

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
        self.devices = grid(devices, rank, torch.device)
        sizes = dims(self.devices, rank)
        if 0 in sizes:
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.shape = dict(zip(self.axis_names, sizes))
        if processes is None:
            here = process_index()
            processes = grid(self.devices, rank, lambda _: here)
        self.processes = grid(processes, rank, int)
        owners = np.asarray(self.processes)
        if owners.shape != sizes:
            raise ValueError(f"processes {owners.shape} do not match the "
                             f"devices {sizes}")
        for i, name in enumerate(self.axis_names):
            if name != BATCH_AXIS and (owners != owners.take([0],
                                                             axis=i)).any():
                raise NotImplementedError(
                    f"the mesh's {name!r} axis spans processes; only the "
                    f"batch axis may (a {name} axis across processes needs "
                    "its halos and carries over torch.distributed, ROADMAP "
                    "A.14)")

    @property
    def spans_processes(self) -> bool:
        """Whether more than one process owns devices of this mesh."""
        return len(set(np.asarray(self.processes).flat)) > 1

    def owned_rows(self) -> List[int]:
        """The batch rows whose devices this process owns (every row in
        one process), the counterpart of JAX's addressable shards."""
        here = process_index()
        owners = np.asarray(self.processes)
        return [b for b in range(owners.shape[0])
                if owners[b].flat[0] == here]

    def frame_indices(self, n_frames: int) -> List[int]:
        """The global indices of this process's frames among ``n_frames``
        split over the batch axis (frames ``b * per_row ..`` belong to
        row ``b``), in frame order: JAX's shard ``.index`` of them."""
        rows = self.owned_rows()
        if not rows:
            raise ValueError("this process owns no batch row of the mesh")
        per_row = n_frames // self.shape[self.axis_names[0]]
        return [f for b in rows for f in range(b * per_row,
                                               (b + 1) * per_row)]

    @property
    def local_device(self) -> torch.device:
        """This process's first device in grid order, where its results
        are gathered."""
        here = process_index()
        flat_devices = np.asarray(self.devices, dtype=object).reshape(-1)
        for device, owner in zip(flat_devices,
                                 np.asarray(self.processes).reshape(-1)):
            if owner == here:
                return device
        raise ValueError("this process owns no device of the mesh")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"


def make_mesh(devices: Optional[Sequence] = None,
              n_batch: Optional[int] = None,
              n_tile: Optional[int] = None) -> Mesh:
    """Build a (batch, tile) mesh over the given devices (this process's),
    by default every device of the world: every visible card of one
    process, or each process's recorded devices in rank order.  With no
    card and no ``devices`` it raises: there is no CPU fallback (pass
    ``[torch.device("cpu")] * n`` to run the plain versions on the
    CPU)."""
    processes = None
    if devices is None:
        devices, processes = world_layout("make_mesh()")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_tile is not None and n_batch is None:
        if n % n_tile:
            raise ValueError(f"n_tile={n_tile} does not divide {n} devices")
        n_batch = n // n_tile
    n_batch, n_tile = batch_tile_axes(n, n_batch)
    return Mesh(_rows(devices, n_batch, n_tile),
                processes=(None if processes is None
                           else _rows(processes, n_batch, n_tile)))


def make_hybrid_mesh(n_batch_hosts: Optional[int] = None,
                     n_tile: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """(batch, tile) mesh for several processes: batch over processes,
    tiles within one.

    In one process it is :func:`make_mesh` over ``devices`` (default:
    every visible card), the JAX package's single-host branch.  In a
    world of several, ``devices`` is this process's list (default: its
    recorded devices), gathered over the ranks (every rank calls this);
    ``n_tile`` defaults to the per-process count, the devices are ordered
    by (rank, local index) and the grid is ``(n_batch_hosts, n_tile)``,
    as JAX lays it out.  A tile axis longer than one process's devices
    is refused (ROADMAP A.14).
    """
    n_hosts = process_count()
    if n_hosts == 1:
        return make_mesh(devices, n_batch=n_batch_hosts, n_tile=n_tile)
    per_rank = (world_devices() if devices is None
                else _gather_devices(devices))
    per_host = len(per_rank[process_index()])
    if per_host == 0 or any(len(local) != per_host for local in per_rank):
        raise ValueError(f"every process must bring the same number of "
                         f"devices, at least one; got "
                         f"{[len(local) for local in per_rank]}")
    if n_tile is None:
        n_tile = per_host
    total = n_hosts * per_host
    if n_batch_hosts is None:
        n_batch_hosts = total // n_tile
    if n_batch_hosts * n_tile != total:
        raise ValueError(f"a ({n_batch_hosts}, {n_tile}) grid does not lay "
                         f"out {total} devices of {n_hosts} processes")
    flat_devices, ranks = _flat(per_rank)
    return Mesh(_rows(flat_devices, n_batch_hosts, n_tile),
                processes=_rows(ranks, n_batch_hosts, n_tile))


def initialize_distributed(*, coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           local_devices: Optional[Sequence] = None,
                           initialization_timeout: int = 300) -> None:
    """Multi-process bootstrap (idempotent), with the keywords of
    ``jax.distributed.initialize``.

    Starts a gloo ``torch.distributed`` group at ``coordinator_address``
    ("host:port", rank 0 listens there) of ``num_processes`` ranks, this
    one ``process_id``; without a coordinator it reads torch's ``env://``
    variables when ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` are all
    set (``MASTER_PORT`` too), and otherwise returns: one process needs
    no bootstrap.  A second call in an initialised world returns.

    Then it records every rank's local devices in rank order (one
    ``all_gather_object``), the world that ``make_mesh``,
    ``make_hybrid_mesh`` and ``make_mesh_2d`` lay out by default: the
    cards ``local_device_ids`` names (JAX's keyword), or the
    ``local_devices`` given (e.g. ``[torch.device("cpu")] * 4``, what
    XLA's forced host device count gives a JAX process), else every
    visible card.

    gloo, not NCCL: the batch axis carries no collectives, so the group
    serves only this bootstrap; and NCCL refuses two ranks on one card.
    """
    global _WORLD
    if local_devices is not None and local_device_ids is not None:
        raise ValueError("pass local_devices or local_device_ids, not both")
    if local_devices is not None:
        local = [torch.device(d) for d in local_devices]
    elif local_device_ids is not None:
        local = [torch.device("cuda", int(i)) for i in local_device_ids]
    else:
        local = _visible_cards()
    if not dist.is_initialized():
        if coordinator_address is None:
            if not all(os.environ.get(name)
                       for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
                return
            where = dict(init_method="env://")
        elif num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        else:
            where = dict(init_method=f"tcp://{coordinator_address}",
                         world_size=int(num_processes),
                         rank=int(process_id))
        dist.init_process_group(
            "gloo", timeout=datetime.timedelta(
                seconds=initialization_timeout), **where)
    elif _WORLD is not None and len(_WORLD) == process_count():
        return
    _WORLD = _gather_devices(local)
