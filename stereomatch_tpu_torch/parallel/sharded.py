"""Row-sharded stereo pipeline, the counterpart of
``stereomatch_tpu/parallel/sharded.py`` (``make_sharded_estimate``,
``ShardedPipeline``).

Partitioning, as in the JAX package: each frame's [H, W, D] cost volume
is split over image rows along the mesh's ``tile`` axis, and frames over
its ``batch`` axis; W and D stay whole on every tile.  One process
drives the whole mesh: a frame is a list of per-tile blocks, each on its
tile's device, and what crosses tiles moves with ``.to()`` of the
receiving tile's device (``halo.py``).  Nothing here synchronises the
host: with one card per tile, traversal t on tile r + 1 overlaps
traversal t + 1 on tile r.

What crosses tile boundaries, and how:

* The cost windows (SSD/SAD: [y-k, y+k) rows; census: +-window//2) pull
  image-row halos from the neighbours, compute the existing cost on the
  halo-extended block and crop it.  Each output's window taps are the
  same values in the same order as on one device, and the zero halo at
  the ring ends is the clipped window's own zero padding, so the crop
  equals the single-device volume bit for bit.
* The horizontal SGM traversals and both reducers (WTA, scanline DP)
  never leave an image row: tile-local.
* The six row traversals cross every tile boundary.  Two modes:
  - ``exact``: for each traversal the tiles run in scan order, each
    continuing every path from the carry ([W, D] path costs and the [W]
    intensity row) of its predecessor in scan order, with the chunk
    kernel (``sgm_cuda.sweep_chunk_with_carry_cuda``, the TPU's K5/K6)
    on the card and ``ops.aggregation.sweep_chunk_with_carry`` on the
    CPU.  Each tile accumulates into its own block in ``TRAVERSALS``
    order, so the volume equals the single-device ``semiglobal_aggregate``
    bit for bit, for any tiling.
  - ``overlap``: each tile prepends (in scan order) ``overlap`` warm-up
    rows of its predecessors, sweeps the extended block from a cold
    start with the whole-image row kernel (K2) and drops the warm-up
    rows.  A zero halo row is the recurrence's identity, so an overlap
    that covers every predecessor is exact; a shorter one is not.

``sgm_schedule`` is accepted with the JAX names ("auto", "wavefront",
"naive"); all three make the same launches in the same order.  On the
TPU the naive fill was only an A/B baseline of the wavefront, and the
JAX package asserts the two give identical outputs.

Refused with ``NotImplementedError`` naming the ROADMAP item, never
substituted: ``sgm_mode="auto"`` (it resolves from the TPU's ICI model),
``aggregation="cvf"`` (A.9), the costs "birchfield", "ncc" and
"ssd-texture" (A.8) and every post-processing flag (A.10).

bf16 volumes (``cost_dtype="bfloat16"``): each tile's cost volume is
bf16, the image halos float32; the kernels read the bf16 tiles, the
partial sums and the carries stay float32, and each tile's sum is
rounded to bf16 once, after its last traversal (exact mode: inside the
chunk kernel's last launch; overlap mode: as the partial sum is cast),
so the result equals the single-device bf16 aggregation bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..cost import SAD, SSD, Census
from ..disparity_reduce import DynamicProgramming
from ..ops import sgm_cuda
from ..ops.aggregation import TRAVERSALS, sweep, sweep_chunk_with_carry
from ..ops.disparity import winner_takes_all
from ..pipeline import tensor_from_numpy
from ..utils import profiling, validation
from ..utils.backend import resolve_backend
from . import halo
from .mesh import BATCH_AXIS, TILE_AXIS, Mesh

_COSTS = ("ssd", "sad", "census")
_REDUCERS = ("wta", "dynamic_programming")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}
_NOT_PORTED_COSTS = ("birchfield", "ncc", "ssd-texture")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to stereomatch_tpu_torch's sharded pipeline "
        f"yet (ROADMAP {item})")


def _cost_dtype(dtype) -> torch.dtype:
    """A torch, numpy or JAX dtype (or its name) -> torch.float32 /
    bfloat16 / int32."""
    name = validation.dtype_name(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unknown cost dtype {dtype!r}; expected float32, "
                         "bfloat16 or int32")
    return _DTYPES[name]


def _effective_overlap(overlap: int, h_loc: int, n_tiles: int) -> int:
    """Clamp the warm-up window to the longest useful span: the deepest
    tile has (n_tiles - 1) * Hl true predecessor rows."""
    return min(overlap, max((n_tiles - 1) * h_loc, 0))


# --------------------------------------------------------------------------
# Cost (local + halo)
# --------------------------------------------------------------------------

def local_cost(lefts: Sequence[torch.Tensor], rights: Sequence[torch.Tensor],
               cost_fn: Callable, before: int,
               after: int) -> List[torch.Tensor]:
    """Per-tile cost volumes: ``cost_fn`` on each [Hl, W] image block
    extended by ``before``/``after`` halo rows, cropped back to the
    block's rows (a contiguous view)."""
    lpad = halo.pad_with_halos(lefts, before, after)
    rpad = halo.pad_with_halos(rights, before, after)
    return [cost_fn(lp, rp)[before:before + block.shape[0]]
            for lp, rp, block in zip(lpad, rpad, lefts)]


# --------------------------------------------------------------------------
# SGM under row sharding
# --------------------------------------------------------------------------

def _accumulate(out: Optional[torch.Tensor],
                part: torch.Tensor) -> torch.Tensor:
    return part if out is None else out + part


def _whole_traversal(vol, img, out, step, p1, p2, on_card):
    """One traversal of a whole block, added to ``out`` (float32; None:
    the first)."""
    if not on_card:
        return _accumulate(out, sweep(vol, img, p1, p2, step))
    first = out is None
    if first:
        out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    sgm_cuda.traverse_cuda(vol, img, out, step, p1, p2, accumulate=not first)
    return out


def _exact_traversal(vols, imgs, outs, step, p1, p2, on_card, last):
    """One row traversal over every tile in scan order, each continuing
    from its predecessor's carry.  ``last``: the final traversal, whose
    chunk launches round a bf16 tile's sum into its bf16 result."""
    order = range(len(vols)) if step[0] > 0 else range(len(vols) - 1, -1, -1)
    carry = (None, None)
    for rank, t in enumerate(order):
        device = vols[t].device
        carry = tuple(c if c is None else c.to(device) for c in carry)
        kw = dict(penalty1=p1, penalty2=p2, seed=rank == 0)
        if on_card:
            result = None
            if last and vols[t].dtype == torch.bfloat16:
                result = torch.empty_like(vols[t])
            outs[t], carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vols[t], imgs[t], step, *carry, out=outs[t],
                accumulate=outs[t] is not None, result=result, **kw)
        else:
            part, carry = sweep_chunk_with_carry(vols[t], imgs[t], step,
                                                 *carry, **kw)
            outs[t] = _accumulate(outs[t], part)


def _overlap_traversal(vols, imgs, outs, step, p1, p2, on_card, overlap):
    """One row traversal over every tile from a cold start ``overlap``
    rows early in scan order, in parallel."""
    if step[0] > 0:        # warm-up rows precede the block
        halo_v = halo.pull_from_prev_multi(vols, overlap)
        halo_i = halo.pull_from_prev_multi(imgs, overlap)
        pieces = zip(halo_v, vols), zip(halo_i, imgs)
        start = overlap
    else:                  # they follow it
        halo_v = halo.pull_from_next_multi(vols, overlap)
        halo_i = halo.pull_from_next_multi(imgs, overlap)
        pieces = zip(vols, halo_v), zip(imgs, halo_i)
        start = 0
    for t, (vol_parts, img_parts) in enumerate(zip(*pieces)):
        vol_x, img_x = torch.cat(vol_parts), torch.cat(img_parts)
        rows = slice(start, start + vols[t].shape[0])
        if on_card:
            ext = torch.empty(vol_x.shape, dtype=torch.float32,
                              device=vol_x.device)
            sgm_cuda.traverse_cuda(vol_x, img_x, ext, step, p1, p2,
                                   accumulate=False)
            part = ext[rows]
            outs[t] = part.clone() if outs[t] is None else outs[t].add_(part)
        else:
            outs[t] = _accumulate(outs[t],
                                  sweep(vol_x, img_x, p1, p2, step)[rows])


def sharded_semiglobal(vols: Sequence[torch.Tensor],
                       imgs: Sequence[torch.Tensor], *, penalty1: float,
                       penalty2: float, mode: str = "exact",
                       overlap: int = 64,
                       backend: str = "auto") -> List[torch.Tensor]:
    """8-direction SGM over one frame's row tiles.

    ``vols``: float32 or bf16 [Hl, W, D] blocks in tile order, each on its
    tile's device; ``imgs``: the [Hl, W] left-image blocks beside them.
    Returns the aggregated blocks in the volumes' dtype (bf16: summed in
    float32, rounded once per tile).  ``mode="exact"`` equals
    ``ops.aggregation.semiglobal_aggregate`` of the whole volume bit for
    bit; so does ``"overlap"`` when ``overlap`` covers every predecessor
    ((n_tiles - 1) * Hl rows).  ``backend`` as ``aggregation.Semiglobal``
    takes it: "auto" runs the kernels on CUDA blocks and the plain
    versions on CPU blocks.
    """
    if mode not in ("exact", "overlap"):
        raise ValueError(f"unknown SGM sharding mode: {mode!r}")
    p1, p2 = float(penalty1), float(penalty2)
    on_card = resolve_backend(backend, vols[0]) == "cuda"
    dtype = torch.bfloat16 if vols[0].dtype == torch.bfloat16 \
        else torch.float32
    vols = [v.to(dtype).contiguous() for v in vols]
    imgs = [i.to(torch.float32).contiguous() for i in imgs]
    overlap = _effective_overlap(overlap, vols[0].shape[0], len(vols))
    outs = [None] * len(vols)
    for i, step in enumerate(TRAVERSALS):
        if step[0] == 0:                         # horizontal: tile-local
            for t, (vol, img) in enumerate(zip(vols, imgs)):
                outs[t] = _whole_traversal(vol, img, outs[t], step, p1, p2,
                                           on_card)
        elif mode == "exact":
            _exact_traversal(vols, imgs, outs, step, p1, p2, on_card,
                             last=i == len(TRAVERSALS) - 1)
        else:
            _overlap_traversal(vols, imgs, outs, step, p1, p2, on_card,
                               overlap)
    # The one rounding of a bf16 tile's float32 sum, where the chunk
    # kernel did not already store it rounded (overlap mode, the CPU).
    return [o.to(dtype) for o in outs]


# --------------------------------------------------------------------------
# Whole-pipeline assembly
# --------------------------------------------------------------------------

def _as_frames(images) -> torch.Tensor:
    """Image stacks as float32 tensors: the halo rows cross as float32,
    whatever the volumes' dtype."""
    if isinstance(images, np.ndarray):
        images = tensor_from_numpy(images)
    return images.to(torch.float32)


def make_sharded_estimate(mesh: Mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          cost_dtype=torch.float32,
                          census_window: int = 5,
                          aggregation: Optional[str] = "sgm",
                          reducer: str = "wta",
                          penalty1: float = 0.1, penalty2: float = 0.2,
                          cvf_radius: int = 8, cvf_eps: float = 1e-4,
                          sgm_mode: str = "exact",
                          sgm_schedule: str = "auto",
                          overlap: int = 64,
                          backend: str = "auto",
                          median: bool = False,
                          subpixel: bool = False,
                          lr_check: bool = False,
                          lr_mode: str = "mirror",
                          lr_max_diff: int = 1,
                          weighted_median: bool = False,
                          wmf_sigma: float = 10.0,
                          wmf_window: int = 5,
                          fgs_lambda: Optional[float] = None,
                          fgs_sigma: float = 8.0,
                          min_confidence: Optional[float] = None,
                          speckle: bool = False,
                          speckle_fill: str = "zero",
                          interpret: bool = False) -> Callable:
    """The pipeline over a (batch, tile) mesh, with the JAX package's
    keywords.

    Returns ``fn(left, right) -> disparity``: [B, H, W] images (numpy or
    tensors, any device) -> [B, H, W] int32 on the mesh's first device,
    with B divisible by the batch axis and H by the tile axis.  Frames
    ``b * B/n_batch ..`` run on batch row ``b``; each tile's rows go to
    its device.  ``backend`` takes the port's names: "auto" (kernels on
    CUDA tiles, plain versions on CPU tiles), "cuda" or "torch".
    ``cvf_radius``/``cvf_eps`` and the post-processing options'
    parameters (``lr_mode``, ``lr_max_diff``, ``wmf_sigma``,
    ``wmf_window``, ``fgs_sigma``, ``speckle_fill``) are accepted for the
    keywords' sake; the options themselves raise (module docstring).
    ``interpret`` exists on the JAX side only (Pallas interpret mode):
    CPU tiles run the plain versions, so True raises.
    """
    del cvf_radius, cvf_eps, lr_max_diff, wmf_sigma, wmf_window, fgs_sigma
    if lr_mode not in ("mirror", "volume"):
        raise ValueError(f"unknown lr_mode: {lr_mode!r}")
    if speckle_fill not in ("zero", "background"):
        raise ValueError(f"unknown fill mode: {speckle_fill!r}")
    if sgm_mode not in ("exact", "overlap", "auto"):
        raise ValueError(f"unknown sgm_mode: {sgm_mode!r} (expected "
                         "'exact', 'overlap' or 'auto')")
    if sgm_schedule not in ("auto", "wavefront", "naive"):
        raise ValueError(f"unknown sgm_schedule: {sgm_schedule!r} "
                         "(expected 'auto', 'wavefront' or 'naive')")
    if cost not in _COSTS + _NOT_PORTED_COSTS:
        raise ValueError(f"unknown cost: {cost!r}")
    if reducer not in _REDUCERS:
        raise ValueError(f"unknown reducer: {reducer!r}")
    if aggregation not in (None, "sgm", "cvf"):
        raise ValueError(f"unknown aggregation: {aggregation!r}")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'cuda' or 'torch'")
    if interpret:
        raise ValueError("interpret=True is the JAX package's Pallas "
                         "interpret mode; the port runs its plain versions "
                         "on CPU tiles instead")
    if sgm_mode == "auto" and aggregation == "sgm":
        raise _not_ported(
            "sgm_mode='auto' (it resolves from the TPU's ICI model, "
            "parallel/ici_model.py; choose 'exact' or 'overlap')", "A.14")
    if aggregation == "cvf":
        raise _not_ported("sharded cvf aggregation", "A.9")
    if cost in _NOT_PORTED_COSTS:
        raise _not_ported(f"the {cost!r} cost", "A.8")
    dtype = _cost_dtype(cost_dtype)
    refused = [name for name, on in (
        ("median", median), ("subpixel", subpixel), ("lr_check", lr_check),
        ("weighted_median", weighted_median),
        ("fgs_lambda", fgs_lambda is not None),
        ("min_confidence", min_confidence is not None),
        ("speckle", speckle)) if on]
    if refused:
        raise _not_ported(f"post-processing ({', '.join(refused)})", "A.10")
    if dtype == torch.int32 and aggregation is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2 is a float quantity)")
    if kernel_size is None:
        kernel_size = 1 if cost == "census" else 7
    if cost == "census":
        if kernel_size != 1:
            raise ValueError(
                "sharded census supports kernel_size=1 (pixelwise Hamming) "
                "only: a box window across row-tile boundaries cannot "
                "reproduce the single-device clipped sum at true image "
                "edges")
        cost_fn = Census(max_disparity, window_size=census_window,
                         cost_volume_dtype=dtype)
        halo_rows = (census_window // 2, census_window // 2)
    else:
        cls = SSD if cost == "ssd" else SAD
        cost_fn = cls(max_disparity, kernel_size=kernel_size,
                      cost_volume_dtype=dtype, backend=backend)
        halo_rows = (kernel_size, kernel_size - 1)
    dp = DynamicProgramming(backend=backend)
    n_batch, n_tiles = mesh.shape[BATCH_AXIS], mesh.shape[TILE_AXIS]

    def frame(left, right, devices):
        h_loc = left.shape[0] // n_tiles
        rows = [slice(t * h_loc, (t + 1) * h_loc) for t in range(n_tiles)]
        lefts = [left[r].to(d) for r, d in zip(rows, devices)]
        rights = [right[r].to(d) for r, d in zip(rows, devices)]
        with profiling.annotate("stm/cost"):
            vols = local_cost(lefts, rights, cost_fn, *halo_rows)
        if aggregation == "sgm":
            with profiling.annotate("stm/aggregation"):
                vols = sharded_semiglobal(vols, lefts, penalty1=penalty1,
                                          penalty2=penalty2, mode=sgm_mode,
                                          overlap=overlap, backend=backend)
        with profiling.annotate("stm/disparity_reduce"):
            if reducer == "wta":
                return [winner_takes_all(v) for v in vols]
            return [dp(v) for v in vols]

    def fn(left, right) -> torch.Tensor:
        left, right = _as_frames(left), _as_frames(right)
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError(f"expected two [B, H, W] stacks of one shape, "
                             f"got {tuple(left.shape)} and "
                             f"{tuple(right.shape)}")
        if left.shape[0] % n_batch or left.shape[1] % n_tiles:
            raise ValueError(
                f"batch {left.shape[0]} / height {left.shape[1]} not "
                f"divisible by mesh axes {(n_batch, n_tiles)}")
        per_row = left.shape[0] // n_batch
        out_device = mesh.devices[0][0]
        frames = []
        for f in range(left.shape[0]):
            tiles = frame(left[f], right[f], mesh.devices[f // per_row])
            frames.append(torch.cat([t.to(out_device) for t in tiles]))
        return torch.stack(frames)

    return fn


class ShardedPipeline:
    """Batched, mesh-sharded counterpart of :class:`Pipeline`, configured
    by name like the JAX package's ``ShardedPipeline`` (same keywords;
    see :func:`make_sharded_estimate`)."""

    def __init__(self, mesh: Mesh, max_disparity: int, **kwargs):
        self.mesh = mesh
        self.max_disparity = max_disparity
        self._fn = make_sharded_estimate(mesh, max_disparity=max_disparity,
                                         **kwargs)

    def estimate(self, left, right) -> torch.Tensor:
        """[B, H, W] (or [H, W], auto-batched) -> [B, H, W] int32 on the
        mesh's first device."""
        left, right = _as_frames(left), _as_frames(right)
        squeeze = left.ndim == 2
        if squeeze:
            n_batch = self.mesh.shape[BATCH_AXIS]
            left = left.expand((n_batch,) + tuple(left.shape))
            right = right.expand((n_batch,) + tuple(right.shape))
        out = self._fn(left, right)
        return out[0] if squeeze else out
