"""Row-sharded temporal tracking step for stereo video, the counterpart
of ``stereomatch_tpu/parallel/temporal_sharded.py``.

The tracked-frame path of :class:`~stereomatch_tpu_torch.temporal.
TemporalPipeline` over a (batch, tile) mesh: the batch axis carries
independent streams (a multi-camera rig), the tile axis image rows.  The
census band stage takes +-window//2 image-row halos
(``pyramid_sharded._band_sharded``), the 3x3 median one disparity row a
side, and the drift statistic is the tiles' poor and scorable counts
summed in float32 (integers below 2^24, so any order gives the same
sums) and divided once per stream, as one device divides them.  Over
processes each rank computes its own tiles; where the tile axis spans
them, every tile's counts move to each rank that owns a tile of the
stream's batch row and are summed there in tile order (JAX's ``psum``
over ``tile``), and each rank returns its shards of both outputs.
``TemporalPipeline`` reads every stream's fraction on one host, so it
takes a one-process mesh (it refuses one over processes).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..temporal import poor_counts, poor_fraction
from . import transport
from .mesh import BATCH_AXIS, TILE_AXIS, Mesh
from .pyramid_sharded import _band_sharded
from .sharded import (_median3x3_rows, assemble, check_frames, frame_shards,
                      map_frames)
from .transport import each, first_local


def make_temporal_track_sharded(mesh: Mesh, *, max_disparity: int,
                                band_radius: int = 6,
                                window_size: int = 5,
                                poor_bits: int = 8,
                                median: bool = True) -> Callable:
    """The tracked-frame step over a (batch, tile) mesh.

    Returns ``fn(left, right, prev) -> (disparity, poor_frac)``: [B, H, W]
    x3 -> ([B, H, W] int32, [B] float32), on the mesh's first device, with
    B divisible by the batch axis and H by the tile axis; per stream
    equal to ``TemporalPipeline._track`` bit for bit.  Where the tile
    axis spans processes: this rank's shards of each, one ``(index,
    tensor)`` pair per mesh device it owns (``sharded.frame_shards``;
    the fraction's index is its batch row's slice of [B]).
    """
    n_tiles = mesh.shape[TILE_AXIS]

    def frame(lefts, rights, prevs):
        results = _band_sharded(lefts, rights, prevs,
                                band_radius=band_radius,
                                max_disparity=max_disparity,
                                window_size=window_size,
                                return_best_cost=True)
        disps = [d for d, _ in results]
        if median:
            disps = _median3x3_rows(disps)
        counts = transport.gather(
            each(lambda best: poor_counts(best, poor_bits),
                 [best for _, best in results]),
            first_local(disps).device, "poor_counts")
        return disps, poor_fraction(torch.stack(counts).sum(dim=0))

    def fn(left, right, prev):
        left, right = check_frames(left, right, mesh, n_tiles)
        prev = torch.as_tensor(prev)
        if tuple(prev.shape) != tuple(left.shape):
            raise ValueError(f"prev {tuple(prev.shape)} does not match the "
                             f"frames {tuple(left.shape)}")
        b = left.shape[0]
        results = map_frames(mesh, frame, left, right, prev)
        disps = {f: tiles for f, (tiles, _) in results.items()}
        if not mesh.splits_frames:
            return (assemble(mesh, disps, b),
                    torch.stack([frac.to(mesh.local_device)
                                 for _, frac in results.values()]))
        per_row = b // mesh.shape[BATCH_AXIS]
        fracs = []
        for row, t in mesh.owned_positions():
            frames = range(row * per_row, (row + 1) * per_row)
            fracs.append(((slice(frames.start, frames.stop),),
                          torch.stack([results[f][1] for f in frames])
                          .to(mesh.devices[row][t])))
        return frame_shards(mesh, disps, b), fracs

    return fn
