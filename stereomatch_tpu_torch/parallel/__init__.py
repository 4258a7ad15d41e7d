"""Multi-device execution: device meshes, halo exchange and the
partitioners, the counterpart of ``stereomatch_tpu/parallel/``.

* ``mesh``    — grids of torch devices with named axes and the process
  that owns each: (batch, tile) for the row-sharded paths, ``batch``
  data-parallel over frames and ``tile`` over image rows.  Devices may
  repeat (several tiles on one card, or the CPU).
  ``initialize_distributed`` joins a gloo ``torch.distributed`` world;
  ``make_hybrid_mesh``, ``make_mesh``, ``make_mesh_2d`` and
  ``make_disp_mesh`` lay any axis over its processes, each computing
  only the tiles (or blocks) of its own devices and returning its
  shards where a frame's tiles span processes.
* ``transport`` — the moves between tiles: ``.to()`` within a process,
  point-to-point sends and receives (staged through host memory)
  between processes, and the gathers built from them.
* ``ici_model`` — the interconnect model behind ``sgm_mode="auto"``,
  with the H100's measured rates.
* ``halo``    — edge-slice exchange between neighbouring tiles along any
  axis through the transport, zero-filled at the ring ends.
* ``sharded`` — the row-sharded pipeline: cost with image-row halos,
  8-path SGM with exact carry hand-off (the chunk kernel) or warm-up
  overlap, WTA or scanline DP, the post-processing.
* ``pyramid_sharded``, ``temporal_sharded`` — the coarse-to-fine pyramid
  and the temporal tracking step over the same row tiles.
* ``disp_sharded`` — cost (+ CVF) + WTA with the disparity axis split
  into blocks over a one-axis ``disp`` mesh.
* ``tiled2d`` — 2-D image tiles over a (batch, tile, tile_w) mesh: SGM on
  overlap-extended blocks, exact CVF, exact DP across column tiles.
"""

from .disp_sharded import DISP_AXIS, make_disp_mesh, make_disp_sharded_wta
from .mesh import (BATCH_AXIS, TILE_AXIS, Mesh, batch_tile_axes,
                   initialize_distributed, make_hybrid_mesh, make_mesh)
from .pyramid_sharded import make_pyramid_sharded_estimate
from .sharded import ShardedPipeline, make_sharded_estimate
from .temporal_sharded import make_temporal_track_sharded
from .tiled2d import TILE_W_AXIS, make_mesh_2d, make_tiled2d_estimate

__all__ = ["BATCH_AXIS", "DISP_AXIS", "TILE_AXIS", "TILE_W_AXIS", "Mesh",
           "ShardedPipeline", "batch_tile_axes", "initialize_distributed",
           "make_disp_mesh", "make_disp_sharded_wta", "make_hybrid_mesh",
           "make_mesh", "make_mesh_2d", "make_pyramid_sharded_estimate",
           "make_sharded_estimate", "make_temporal_track_sharded",
           "make_tiled2d_estimate"]
