"""Row-sharded temporal tracking step for stereo video, the counterpart
of ``stereomatch_tpu/parallel/temporal_sharded.py``.

The tracked-frame path of :class:`~stereomatch_tpu_torch.temporal.
TemporalPipeline` over a (batch, tile) mesh: the batch axis carries
independent streams (a multi-camera rig), the tile axis image rows.  The
census band stage takes +-window//2 image-row halos
(``pyramid_sharded._band_sharded``), the 3x3 median one disparity row a
side, and the drift statistic is the tiles' poor and scorable counts
summed in float32 (integers below 2^24, so any order gives the same
sums) and divided once per stream, as one device divides them.  A mesh
over several processes is refused (ROADMAP A.14).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..temporal import poor_counts, poor_fraction
from .mesh import TILE_AXIS, Mesh
from .pyramid_sharded import _band_sharded
from .sharded import _median3x3_rows, check_frames, join_tiles, map_frames


def make_temporal_track_sharded(mesh: Mesh, *, max_disparity: int,
                                band_radius: int = 6,
                                window_size: int = 5,
                                poor_bits: int = 8,
                                median: bool = True) -> Callable:
    """The tracked-frame step over a (batch, tile) mesh.

    Returns ``fn(left, right, prev) -> (disparity, poor_frac)``: [B, H, W]
    x3 -> ([B, H, W] int32, [B] float32), on the mesh's first device, with
    B divisible by the batch axis and H by the tile axis; per stream
    equal to ``TemporalPipeline._track`` bit for bit.
    """
    if mesh.spans_processes:
        raise NotImplementedError(
            "the temporal tracker over a mesh of several processes: its "
            "keyframe decision reads every stream's drift fraction on one "
            "host each frame (a collective a frame here; the JAX package's "
            "TemporalPipeline fetches it with np.asarray, which refuses an "
            "array spanning another process's devices), ROADMAP A.14")
    n_tiles = mesh.shape[TILE_AXIS]
    first = mesh.devices[0][0]

    def frame(lefts, rights, prevs):
        results = _band_sharded(lefts, rights, prevs,
                                band_radius=band_radius,
                                max_disparity=max_disparity,
                                window_size=window_size,
                                return_best_cost=True)
        disps = [d for d, _ in results]
        if median:
            disps = _median3x3_rows(disps)
        total = torch.stack([poor_counts(best, poor_bits).to(first)
                             for _, best in results]).sum(dim=0)
        return join_tiles(mesh, disps), poor_fraction(total)

    def fn(left, right, prev):
        left, right = check_frames(left, right, mesh, n_tiles)
        prev = torch.as_tensor(prev)
        if tuple(prev.shape) != tuple(left.shape):
            raise ValueError(f"prev {tuple(prev.shape)} does not match the "
                             f"frames {tuple(left.shape)}")
        disps, fracs = zip(*map_frames(mesh, frame, left, right, prev))
        return torch.stack(disps), torch.stack(fracs)

    return fn
