"""Multi-device execution: device meshes, halo exchange and the
row-sharded pipeline, the counterpart of ``stereomatch_tpu/parallel/``.

* ``mesh``    — a (batch, tile) grid of torch devices owned by one process:
  ``batch`` data-parallel over frames, ``tile`` over image rows.  Devices
  may repeat (several tiles on one card, or the CPU).
* ``halo``    — edge-row exchange between neighbouring tiles by
  cross-device copies, zero-filled at the ring ends.
* ``sharded`` — the row-sharded pipeline: cost with image-row halos,
  8-path SGM with exact carry hand-off (the chunk kernel) or warm-up
  overlap, WTA or scanline DP.

The JAX package's other partitioners (2-D tiles, disparity blocks,
pyramid, temporal) and multi-host meshes are not ported yet (ROADMAP
A.14).
"""

from .mesh import (BATCH_AXIS, TILE_AXIS, Mesh, batch_tile_axes,
                   initialize_distributed, make_hybrid_mesh, make_mesh)
from .sharded import ShardedPipeline, make_sharded_estimate

__all__ = ["BATCH_AXIS", "TILE_AXIS", "Mesh", "ShardedPipeline",
           "batch_tile_axes", "initialize_distributed", "make_hybrid_mesh",
           "make_mesh", "make_sharded_estimate"]
