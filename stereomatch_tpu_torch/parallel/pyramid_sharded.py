"""Row-sharded coarse-to-fine pyramid over a (batch, tile) mesh, the
counterpart of ``stereomatch_tpu/parallel/pyramid_sharded.py``.

Every stage of :class:`~stereomatch_tpu_torch.pyramid.PyramidPipeline`
maps onto the row-sharding of ``parallel/sharded.py``:

* 2x2 mean pooling and nearest upsampling never split a row pair when a
  tile's height divides by 2**levels: tile-local.
* The coarse census volume takes +-window//2 image-row halos
  (``sharded.local_cost``; the zero rows beyond the image are census's
  own out-of-image value).
* The coarse SGM is ``sharded.sharded_semiglobal``: the exact carry
  hand-off (the chunk kernel, the TPU's K5/K6, on the card) or the
  overlap warm-up (K2).
* The band stage reads census codes of window//2 more image rows a side,
  and the windowed Hamming option (band_kernel_size > 1) k//2 rows of
  Hamming planes on top; rows beyond the true image are flagged by
  ``row_valid`` so its box sums treat them as the single-device zero
  padding.  Halo rows' outputs are dropped.
* The inter-level 3x3 median and the speckle test read neighbour rows
  (``sharded._median3x3_rows``, ``sharded._speckle_rows``).

So ``sgm_mode="exact"`` equals the single-device pyramid bit for bit.
``sgm_mode="auto"`` resolves from the coarse level's geometry, where the
SGM runs (``sharded.sgm_mode_resolver``).  Over processes each rank
computes its own tiles of the frames of the batch rows it has a device
in (``sharded.map_frames``), the halos and the coarse SGM's carry moving
between ranks where the tile axis spans them.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Sequence

import torch

from ..cost import Census
from ..ops.disparity import winner_takes_all
from ..pyramid import (_cost_dtype, band_refine_census, downsample2,
                       upsample2_nearest)
from . import halo
from .mesh import TILE_AXIS, Mesh
from .sharded import (_median3x3_rows, _speckle_rows, assemble,
                      check_frames, local_cost, map_frames, sgm_mode_resolver,
                      sharded_semiglobal)
from .transport import each, is_local


def _band_sharded(lefts: Sequence[torch.Tensor],
                  rights: Sequence[torch.Tensor],
                  predicted: Sequence[torch.Tensor], *, band_radius: int,
                  max_disparity: int, window_size: int,
                  band_kernel_size: int = 1, subpixel: bool = False,
                  return_best_cost: bool = False) -> List:
    """``band_refine_census`` over one frame's row tiles: each tile's
    images with ``window_size // 2 + band_kernel_size // 2`` halo rows a
    side (zeros beyond the image), its anchors zero-padded there, the
    halo rows' outputs cropped.  Returns the per-tile results (with
    ``return_best_cost``, (disparity, best cost) pairs; two placeholders
    for another process's tile)."""
    h = window_size // 2 + band_kernel_size // 2
    n = len(lefts)
    lpad = halo.pad_with_halos(lefts, h, h)
    rpad = halo.pad_with_halos(rights, h, h)
    out = []
    for t, (lp, rp, pred) in enumerate(zip(lpad, rpad, predicted)):
        if not is_local(lp):
            out.append((lp, lp) if return_best_cost else lp)
            continue
        h_loc = pred.shape[0]
        pp = torch.nn.functional.pad(pred, (0, 0, h, h))
        row_valid = None
        if band_kernel_size > 1:
            row_valid = ~halo.out_of_image_mask(t, n, h_loc, h,
                                                device=lp.device)
        res = band_refine_census(lp, rp, pp, band_radius=band_radius,
                                 max_disparity=max_disparity,
                                 window_size=window_size,
                                 band_kernel_size=band_kernel_size,
                                 row_valid=row_valid, subpixel=subpixel,
                                 return_best_cost=return_best_cost)
        if return_best_cost:
            out.append(tuple(x[h:h + h_loc] for x in res))
        else:
            out.append(res[h:h + h_loc])
    return out


def make_pyramid_sharded_estimate(mesh: Mesh, *, max_disparity: int,
                                  levels: int = 1,
                                  band_radius: int = 24,
                                  window_size: int = 5,
                                  band_kernel_size: int = 5,
                                  cost_dtype=torch.float32,
                                  penalty1: float = 0.1,
                                  penalty2: float = 0.2,
                                  sgm_mode: str = "exact",
                                  overlap: int = 64,
                                  backend: str = "auto",
                                  subpixel: bool = False,
                                  median: bool = True,
                                  speckle: bool = False,
                                  speckle_fill: str = "zero") -> Callable:
    """The coarse-to-fine pyramid over a (batch, tile) mesh, with the JAX
    package's keywords (``interpret`` is the JAX side's Pallas interpret
    mode and has no counterpart).

    Returns ``fn(left, right) -> disparity``: [B, H, W] images (numpy or
    tensors) -> [B, H, W] on the mesh's first device (int32; float32 with
    ``subpixel``), with B divisible by the batch axis and H by
    ``tiles * 2**levels`` (pooling must not split a row pair at a tile
    boundary).  ``sgm_mode`` "exact", "overlap" (``overlap`` warm-up
    rows) or "auto" (the interconnect model's pick for the coarse
    level).  Over processes each rank returns its own frames
    (``mesh.frame_indices(B)``), or its shards where the tile axis spans
    processes (``sharded.frame_shards``).  ``backend`` is the coarse
    SGM's ("auto", "cuda" or "torch").
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if max_disparity % (2 ** levels):
        raise ValueError(f"max_disparity {max_disparity} not divisible "
                         f"by 2**levels = {2 ** levels}")
    if sgm_mode not in ("exact", "overlap", "auto"):
        raise ValueError(f"unknown sgm_mode: {sgm_mode!r}")
    if speckle_fill not in ("zero", "background"):
        raise ValueError(f"unknown fill mode: {speckle_fill!r}")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'cuda' or 'torch'")
    dtype = _cost_dtype(cost_dtype)
    d_coarse = max_disparity // (2 ** levels)
    census = Census(d_coarse, window_size=window_size,
                    cost_volume_dtype=dtype)
    n_tiles = mesh.shape[TILE_AXIS]
    resolve = sgm_mode_resolver(mesh, sgm_mode, overlap=overlap,
                                logger=logging.getLogger(__name__))

    def frame(lefts, rights, mode):
        pyr = [(lefts, rights)]
        for _ in range(levels):
            ls, rs = pyr[-1]
            pyr.append((each(downsample2, ls), each(downsample2, rs)))
        coarse_l, coarse_r = pyr[-1]
        vols = local_cost(coarse_l, coarse_r, census, window_size // 2,
                          window_size // 2)
        aggs = sharded_semiglobal(vols, coarse_l, penalty1=penalty1,
                                  penalty2=penalty2, mode=mode,
                                  overlap=overlap, backend=backend)
        disps = each(winner_takes_all, aggs)
        for level in range(levels - 1, -1, -1):
            fine_l, fine_r = pyr[level]
            disps = _band_sharded(
                fine_l, fine_r, each(upsample2_nearest, disps),
                band_radius=band_radius,
                max_disparity=max_disparity // (2 ** level),
                window_size=window_size, band_kernel_size=band_kernel_size,
                subpixel=subpixel and level == 0)
            if median:
                disps = _median3x3_rows(disps)
        if speckle:
            disps = _speckle_rows(disps, max_diff=1.0, window=9,
                                  min_frac=0.25, fill=speckle_fill)
        return disps

    def fn(left, right):
        left, right = check_frames(left, right, mesh, n_tiles * 2 ** levels)
        b, h, w = left.shape
        scale = 2 ** levels
        mode = resolve(h // scale, w // scale, d_coarse, b)
        return assemble(mesh, map_frames(
            mesh, functools.partial(frame, mode=mode), left, right), b)

    return fn
