"""Halo (edge-row) exchange between neighbouring row tiles, the
counterpart of ``stereomatch_tpu/parallel/halo.py``.

Every function takes the list of one frame's per-tile blocks, in tile
order, each on its tile's device (a ``transport.Remote`` placeholder for
a tile another process owns), and returns one tensor per tile this
process owns, on that tile's device (the placeholder for the others).
Slices move as one exchange (``transport.exchange``): ``.to(device)`` of
the receiving tile within a process, a send and a receive between
processes.  Positions beyond the ring ends are zeros, as ``lax.ppermute``
fills them there: the additive identity the clipped cost windows want,
and the cold-start identity of the SGM warm-up scan (``sharded.py``).
Every tile's block has the same length along ``axis``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import transport
from .transport import each, first_local, is_local

Blocks = Sequence


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
    if any(count > b.shape[axis] for b in blocks if is_local(b)):
        raise ValueError(f"a halo of {count} slices reaches past the "
                         "neighbouring tile; use the _multi form")


def pull_from_prev(blocks: Blocks, count: int, axis: int = 0) -> list:
    """For each tile, the last ``count`` slices (along ``axis``) of the
    previous tile's block; tile 0 receives zeros."""
    _check_one_hop(blocks, count, axis)
    return pull_from_prev_multi(blocks, count, axis)


def pull_from_next(blocks: Blocks, count: int, axis: int = 0) -> list:
    """For each tile, the first ``count`` slices of the next tile's
    block; the last tile receives zeros."""
    _check_one_hop(blocks, count, axis)
    return pull_from_next_multi(blocks, count, axis)


def _pull(blocks: Blocks, count: int, axis: int, forward: bool) -> list:
    """Each tile's ``count`` slices before (``forward``: from its
    predecessors, farthest first) or after it (from its successors,
    nearest first), zeros beyond the ring ends, in one exchange."""
    ref = first_local(blocks)
    if ref is None:                       # no tile here: nothing to do
        return list(blocks)
    n, local = len(blocks), ref.shape[axis]
    hops = -(-count // local) if count else 0
    moves, layout = [], []
    for i, block in enumerate(blocks):
        pieces = []
        steps = range(hops, 0, -1) if forward else range(1, hops + 1)
        for j in steps:
            width = min(local, count - (j - 1) * local)
            src = i - j if forward else i + j
            if not 0 <= src < n:
                pieces.append(("zeros", width))
                continue
            start = local - width if forward else 0
            part = blocks[src]
            if is_local(part):
                part = part.narrow(axis, start, width)
            pieces.append(("moved", len(moves)))
            moves.append((part, block))
        layout.append(pieces)
    landed = transport.exchange(moves, "halo")
    out = []
    for block, pieces in zip(blocks, layout):
        if not is_local(block):
            out.append(block)
            continue
        parts = [landed[v] if kind == "moved" else _zeros(block, v, axis)
                 for kind, v in pieces]
        out.append(_join(parts, block, axis))
    return out


def pull_from_prev_multi(blocks: Blocks, count: int, axis: int = 0) -> list:
    """For each tile, the ``count`` slices immediately BEFORE its block,
    from as many predecessors as needed (``count`` may exceed a block);
    positions before tile 0 are zeros.  Ordered as the global axis."""
    return _pull(blocks, count, axis, forward=True)


def pull_from_next_multi(blocks: Blocks, count: int, axis: int = 0) -> list:
    """For each tile, the ``count`` slices immediately AFTER its block,
    from as many successors as needed; positions beyond the last tile
    are zeros."""
    return _pull(blocks, count, axis, forward=False)


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
                   axis: int = 0) -> list:
    """Each tile's block with ``before`` slices of its predecessors and
    ``after`` of its successors around it along ``axis``; out-of-image
    positions are zeros.  ``before``/``after`` may be 0."""
    heads = pull_from_prev_multi(blocks, before, axis)
    tails = pull_from_next_multi(blocks, after, axis)
    return each(lambda b, h, t: _join([p for p in (h, b, t)
                                       if p.shape[axis]], b, axis),
                blocks, heads, tails)
