"""Moves of blocks between the tiles of a mesh, within a process or
across processes: the counterpart of ``lax.ppermute`` (and of the
``all_gather``, ``pmin`` and ``psum`` built from it here) under the JAX
package's ``shard_map``.

Every process walks the same loop over a frame's tiles in the same
order.  A tile it owns is a tensor on the tile's device; a tile another
process owns is a :class:`Remote` placeholder naming that process and
the tile's device, and so is every block derived from it (``each``).  A
*move* of a block from one tile to another is

* ``.to(device)`` of the receiving tile when one process owns both (the
  one-process path, unchanged);
* a send by the owner of the source and a receive by the owner of the
  destination otherwise, over the ``torch.distributed`` world
  (``mesh.initialize_distributed``, gloo); every other process skips
  it.

gloo sends CPU tensors, so a CUDA block is staged through a pinned host
buffer on each side.  A block travels as its raw bytes (any dtype,
bf16 included, keeps its bit patterns), after a small header of its
dtype and shape, so the receiver needs to know nothing of it in
advance.  ``exchange`` posts all of one exchange's headers and payloads
at once (``isend``/``irecv``) and waits for them together; a chain (the
SGM carry, the Thomas hand-off, the DP and fill chains) is an exchange
of one step's moves before the stage that needs them.  The moves of an
exchange are issued in one order on every process (the caller's: tile
order, then slice order) under the exchange's tag, and gathers are
built from moves, so no collective runs that only some processes call.
A failed send or receive, a dead partner or the group's timeout raises
on every process that waits on it; nothing is caught here.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import process_index

# Header: dtype index, rank, then the dims (a block has at most 6).
_MAX_DIMS = 6
_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64,
           torch.uint8, torch.bool, torch.int8, torch.float16,
           torch.float64, torch.int16)


class Remote:
    """A tile, or a block derived from one, that process ``owner`` holds
    on its ``device``: what this process knows of it."""

    __slots__ = ("owner", "device")

    def __init__(self, owner: int, device=None):
        self.owner = int(owner)
        self.device = None if device is None else torch.device(device)

    def __repr__(self) -> str:
        return f"Remote(owner={self.owner}, device={self.device})"


def is_local(block) -> bool:
    return not isinstance(block, Remote)


def owner(block) -> int:
    """The process that holds ``block``: this one for a tensor."""
    return block.owner if isinstance(block, Remote) else process_index()


def each(fn, *tiles) -> list:
    """``fn`` on each tile this process owns (and the blocks beside it in
    the other lists); a tile another process owns stays its placeholder."""
    return [fn(*blocks) if is_local(blocks[0]) else blocks[0]
            for blocks in zip(*tiles)]


def first_local(blocks) -> Optional[torch.Tensor]:
    """The first block in ``blocks`` this process holds, or None."""
    for block in blocks:
        if is_local(block):
            return block
    return None


def _place(destination) -> Tuple[int, Optional[torch.device]]:
    if isinstance(destination, Remote):
        return destination.owner, destination.device
    return process_index(), destination.device


def _tag(name: str) -> int:
    """Two gloo tags an exchange of this name (headers even, payloads
    odd), the same on every process."""
    return 2 * (zlib.crc32(name.encode()) & 0x3FFFFFFF)


def _header(block: torch.Tensor) -> torch.Tensor:
    if block.ndim > _MAX_DIMS:
        raise ValueError(f"a moved block has at most {_MAX_DIMS} dims, got "
                         f"{tuple(block.shape)}")
    head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
    head[0] = _DTYPES.index(block.dtype)
    head[1] = block.ndim
    head[2:2 + block.ndim] = torch.tensor(block.shape, dtype=torch.int64)
    return head


def _staged(block: torch.Tensor) -> torch.Tensor:
    """The block's bytes in host memory (pinned for a CUDA block)."""
    data = block.detach().contiguous().reshape(-1).view(torch.uint8)
    if data.device.type == "cpu":
        return data
    host = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(data)
    return host


def exchange(moves: Sequence, name: str) -> list:
    """Perform the ``(block, destination)`` moves of one exchange.

    ``block``: a tensor this process holds or a placeholder; a
    ``destination``: a tensor (a tile, or a block of it, this process
    holds: the block lands on its device) or a :class:`Remote` (the
    block lands on that process, on ``device`` when the process is this
    one).  Returns, per move, the block on its destination where this
    process is it, else a placeholder of the destination.  Every process
    that owns a source or a destination of a move must call this with
    the same moves in the same order and the same ``name``."""
    me = process_index()
    tag = _tag(name)
    out: List = [None] * len(moves)
    sends, recvs = [], []
    for i, (block, destination) in enumerate(moves):
        src = owner(block)
        dst, device = _place(destination)
        if src == dst == me:
            out[i] = block.to(device)
        elif src == me:
            sends.append((block, dst))
            out[i] = Remote(dst, device)
        elif dst == me:
            recvs.append((i, src, device))
        else:
            out[i] = Remote(dst, device)
    if not sends and not recvs:
        return out
    staged = [(_header(block), _staged(block)) for block, _ in sends]
    works = []
    for (_, dst), (head, data) in zip(sends, staged):
        works.append(dist.isend(head, dst, tag=tag))
        if data.numel():
            works.append(dist.isend(data, dst, tag=tag + 1))
    heads = [torch.empty(2 + _MAX_DIMS, dtype=torch.int64) for _ in recvs]
    for head, (_, src, _) in zip(heads, recvs):
        dist.irecv(head, src, tag=tag).wait()
    landed = []
    for head, (i, src, device) in zip(heads, recvs):
        dtype = _DTYPES[int(head[0])]
        shape = tuple(int(x) for x in head[2:2 + int(head[1])])
        n_bytes = (torch.Size(shape).numel()
                   * torch.empty((), dtype=dtype).element_size())
        cuda = device is not None and device.type == "cuda"
        data = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=cuda)
        if n_bytes:
            works.append(dist.irecv(data, src, tag=tag + 1))
        landed.append((i, data, dtype, shape, device))
    for work in works:
        work.wait()
    for i, data, dtype, shape, device in landed:
        out[i] = data.view(dtype).reshape(shape).to(device)
    return out


def move(blocks: Sequence, destination, name: str) -> list:
    """The blocks of one chain step (a carry) moved to ``destination``:
    one exchange, waited on before the step that reads them."""
    return exchange([(block, destination) for block in blocks], name)


def gather(parts: Sequence, device, name: str) -> Optional[list]:
    """Every part, in order, on ``device`` of each process that holds one
    (an all-gather built from moves): this process's list, or None where
    it holds no part."""
    me = process_index()
    ranks = sorted({owner(p) for p in parts})
    moves = [(part, Remote(r, device if r == me else None))
             for part in parts for r in ranks if r != owner(part) or r == me]
    landed = exchange(moves, name)
    if me not in ranks:
        return None
    return [x for (_, dst), x in zip(moves, landed) if dst.owner == me]
