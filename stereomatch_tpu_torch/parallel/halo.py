"""Halo (edge-row) exchange between neighbouring row tiles, the
counterpart of ``stereomatch_tpu/parallel/halo.py``.

Every function takes the list of one frame's per-tile blocks, in tile
order, each on its tile's device, and returns one tensor per tile on
that tile's device: rows move with ``.to(device)`` of the receiving
tile.  Positions beyond the ring ends are zeros, as ``lax.ppermute``
fills them there: the additive identity the clipped cost windows want,
and the cold-start identity of the SGM warm-up scan (``sharded.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

Blocks = Sequence[torch.Tensor]


def _slab(block: torch.Tensor, start: int, count: int, axis: int,
          device: torch.device) -> torch.Tensor:
    return block.narrow(axis, start, count).to(device)


def _zeros(block: torch.Tensor, count: int, axis: int) -> torch.Tensor:
    shape = list(block.shape)
    shape[axis] = count
    return block.new_zeros(shape)


def _join(parts, block: torch.Tensor, axis: int) -> torch.Tensor:
    """The pieces of one halo in order; a single piece is returned as it
    is (no copy)."""
    if not parts:
        return _zeros(block, 0, axis)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _check_one_hop(blocks: Blocks, count: int, axis: int) -> None:
    if any(count > b.shape[axis] for b in blocks):
        raise ValueError(f"a halo of {count} slices reaches past the "
                         "neighbouring tile; use the _multi form")


def pull_from_prev(blocks: Blocks, count: int,
                   axis: int = 0) -> List[torch.Tensor]:
    """For each tile, the last ``count`` slices (along ``axis``) of the
    previous tile's block; tile 0 receives zeros."""
    _check_one_hop(blocks, count, axis)
    return pull_from_prev_multi(blocks, count, axis)


def pull_from_next(blocks: Blocks, count: int,
                   axis: int = 0) -> List[torch.Tensor]:
    """For each tile, the first ``count`` slices of the next tile's
    block; the last tile receives zeros."""
    _check_one_hop(blocks, count, axis)
    return pull_from_next_multi(blocks, count, axis)


def pull_from_prev_multi(blocks: Blocks, count: int,
                         axis: int = 0) -> List[torch.Tensor]:
    """For each tile, the ``count`` slices immediately BEFORE its block,
    from as many predecessors as needed (``count`` may exceed a block);
    positions before tile 0 are zeros.  Ordered as the global axis."""
    out = []
    for i, block in enumerate(blocks):
        local = block.shape[axis]
        hops = -(-count // local) if count else 0
        parts = []
        for j in range(hops, 0, -1):                 # farthest tile first
            width = min(local, count - (j - 1) * local)
            if i - j < 0:
                parts.append(_zeros(block, width, axis))
            else:
                parts.append(_slab(blocks[i - j], local - width, width, axis,
                                   block.device))
        out.append(_join(parts, block, axis))
    return out


def pull_from_next_multi(blocks: Blocks, count: int,
                         axis: int = 0) -> List[torch.Tensor]:
    """For each tile, the ``count`` slices immediately AFTER its block,
    from as many successors as needed; positions beyond the last tile
    are zeros."""
    n = len(blocks)
    out = []
    for i, block in enumerate(blocks):
        local = block.shape[axis]
        hops = -(-count // local) if count else 0
        parts = []
        for j in range(1, hops + 1):                 # nearest tile first
            width = min(local, count - (j - 1) * local)
            if i + j >= n:
                parts.append(_zeros(block, width, axis))
            else:
                parts.append(_slab(blocks[i + j], 0, width, axis,
                                   block.device))
        out.append(_join(parts, block, axis))
    return out


def out_of_image_mask(rank: int, n_shards: int, local_len: int, before: int,
                      after: int = None, device=None) -> torch.Tensor:
    """Which positions of tile ``rank``'s halo-extended block lie beyond
    the true image: a bool [before + local_len + after] vector (``after``
    defaults to ``before``), True where the global coordinate falls
    outside [0, n_shards * local_len).  Zero is the identity of window
    sums but not of window counts, so count-normalised statistics must
    exclude these positions."""
    if after is None:
        after = before
    g = (torch.arange(before + local_len + after, device=device)
         + rank * local_len - before)
    return (g < 0) | (g >= n_shards * local_len)


def pad_with_halos(blocks: Blocks, before: int, after: int,
                   axis: int = 0) -> List[torch.Tensor]:
    """Each tile's block with ``before`` slices of its predecessors and
    ``after`` of its successors around it along ``axis``; out-of-image
    positions are zeros.  ``before``/``after`` may be 0."""
    heads = pull_from_prev_multi(blocks, before, axis)
    tails = pull_from_next_multi(blocks, after, axis)
    return [_join([p for p in (h, b, t) if p.shape[axis]], b, axis)
            for h, b, t in zip(heads, blocks, tails)]
