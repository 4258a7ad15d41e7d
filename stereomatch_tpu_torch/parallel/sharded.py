"""Row-sharded stereo pipeline, the counterpart of
``stereomatch_tpu/parallel/sharded.py`` (``make_sharded_estimate``,
``ShardedPipeline``).

Partitioning, as in the JAX package: each frame's [H, W, D] cost volume
is split over image rows along the mesh's ``tile`` axis, and frames over
its ``batch`` axis; W and D stay whole on every tile.  A frame is a list
of per-tile blocks, each on its tile's device; every process that owns
a tile of the frame walks the same tile loop, computing only its own
tiles (another process's tile is a ``transport.Remote`` placeholder),
and what crosses tiles moves through ``transport.exchange``: ``.to()``
of the receiving tile's device within a process, a send and a receive
between processes (``halo.py``).  Within a process nothing here
synchronises the host: with one card per tile, traversal t on tile
r + 1 overlaps traversal t + 1 on tile r.

What crosses tile boundaries, and how:

* The cost windows (SSD/SAD/SSD over textures: [y-k, y+k) rows; census:
  +-window//2) pull image-row halos from the neighbours, compute the
  existing cost on the halo-extended block and crop it.  Each output's
  window taps are the same values in the same order as on one device,
  and the zero halo at the ring ends is the clipped window's own zero
  padding, so the crop equals the single-device volume bit for bit.
  Birchfield never leaves a row: no halo.  ZNCC takes the (k, k-1)
  halos, a row-validity mask (rows beyond the image stay out of the
  window count, for which zero is no identity) and the whole images'
  sums, from the tiles' per-row ``pairwise_sum_last`` sums gathered into
  the [H] vector and summed again as one device sums it
  (``ops.cost.zncc_cost_from_padded``).
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

Post-processing, in ``Pipeline.estimate_refined``'s order (LR check and
fill, weighted median, 3x3 median, sub-pixel, fast global smoother,
confidence gate), then speckle suppression.  The LR check's mirrored run
flips W, which the tiles never split, and its volume mode, the sub-pixel
step and the confidence gate never leave a row: tile-local.  The medians
and the speckle test read window//2 rows of each neighbour (halos), the
rows beyond the image filled as the single-device filters pad them
(edge rows for the 3x3 median, +inf guide rows for the weighted median,
NaN for the speckle test).  The smoother's row solves are tile-local;
its column solves chain the Thomas forward carry (cp, dp) down through
the tiles and the back-substitution's first row up through them, from
guide halo rows, so every step is the single-device step.  Each flag
gives the single-device ``estimate_refined`` (then ``filter_speckles``)
bit for bit.

Guided-filter aggregation (``aggregation="cvf"``, ``sharded_cvf``):
both filter stages are (2r+1) box means, so an output row reads the
input rows within 2r of it.  Each tile pulls 2r halo rows of the volume
and the guide, the rows beyond the image set to +inf (invalid: zero is
the identity of the window sums, not of the window counts), filters the
extended block with the generic masked path
(``ops.cvf.guided_filter_from_padded``) and crops it: every window sums
the same values in the same order as on one device, so each tile equals
the rows of the single-device masked filter bit for bit (the registry's
single-device pipeline takes the wedge path instead, within about 3e-6
relative of it, as in the JAX package).

``sgm_mode="auto"`` resolves to "exact" or "overlap" at the first call
of each frame shape, through ``ici_model.select_sgm_mode`` (the H100's
measured rates) with the frames a batch row holds, as the JAX package
resolves it at trace time.

Over processes (a mesh from ``make_hybrid_mesh`` or ``make_mesh`` in a
world of several), every rank is given the same global [B, H, W] stacks
and computes only the tiles whose devices it owns, of the frames of the
batch rows it has a device in (``Mesh.frame_indices``); the other tiles
never reach a device.  Where the tile axis spans processes, the halos,
the exact mode's carry (the chunk kernel's chain crosses the rank
boundary), ZNCC's row sums and the smoother's Thomas hand-off travel
between them, and each rank returns its shards (:func:`frame_shards`).
Where only the batch axis spans them, nothing crosses processes.

bf16 volumes (``cost_dtype="bfloat16"``): each tile's cost volume is
bf16, the image halos float32; the kernels read the bf16 tiles, the
partial sums and the carries stay float32, and each tile's sum is
rounded to bf16 once, after its last traversal (exact mode: inside the
chunk kernel's last launch; overlap mode: as the partial sum is cast),
so the result equals the single-device bf16 aggregation bit for bit.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..cost import SAD, SSD, Census
from ..disparity_reduce import DynamicProgramming
from ..ops import cost as cost_ops
from ..ops import refine, sgm_cuda
from ..ops.aggregation import TRAVERSALS, sweep, sweep_chunk_with_carry
from ..ops.cvf import guided_filter_from_padded
from ..ops.disparity import winner_takes_all
from ..pipeline import disparity_bins, tensor_from_numpy
from ..utils.numeric import exp_f32, pairwise_sum_last
from ..utils import profiling, validation
from ..utils.backend import resolve_backend
from . import halo, transport
from .ici_model import select_sgm_mode
from .mesh import BATCH_AXIS, TILE_AXIS, Mesh
from .transport import each, first_local, is_local

_COSTS = ("ssd", "ssd-texture", "birchfield", "census", "sad", "ncc")
_REDUCERS = ("wta", "dynamic_programming")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


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
    return each(lambda block, lp, rp: cost_fn(lp, rp)[
                    before:before + block.shape[0]], lefts, lpad, rpad)


def local_zncc(lefts: Sequence[torch.Tensor], rights: Sequence[torch.Tensor],
               *, max_disparity: int, kernel_size: int,
               cost_dtype: torch.dtype) -> List[torch.Tensor]:
    """Per-tile ZNCC volumes, equal to the rows of the single-device
    ``ops.cost.zncc_cost_volume`` bit for bit: (k, k-1) image-row halos,
    the rows beyond the image marked invalid, and each image's sum from
    the tiles' per-row sums (``pairwise_sum_last``, whose association
    depends on W alone) gathered into the [H] vector on this process's
    first tile's device (from every tile, over processes too) and summed
    there in tile order, as one device sums it."""
    k, n = kernel_size, len(lefts)
    ref = first_local(lefts)
    if ref is None:
        return list(lefts)
    h_loc, width = ref.shape

    def total(blocks):
        rows = transport.gather(
            each(lambda b: pairwise_sum_last(b.to(torch.float32)), blocks),
            ref.device, "zncc_sums")
        return pairwise_sum_last(torch.cat(rows))

    totals = total(lefts), total(rights)
    lpad = halo.pad_with_halos(lefts, k, k - 1)
    rpad = halo.pad_with_halos(rights, k, k - 1)
    return each(lambda lp, rp, t: cost_ops.zncc_cost_from_padded(
                    lp, rp, pad_before=k, pad_after=k - 1,
                    max_disparity=max_disparity, kernel_size=k,
                    cost_dtype=cost_dtype,
                    row_valid=~halo.out_of_image_mask(t, n, h_loc, k, k - 1,
                                                      device=lp.device),
                    left_total=totals[0], right_total=totals[1],
                    image_size=n * h_loc * width),
                lpad, rpad, range(n))


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
        if rank:                 # the predecessor's carry (between ranks too)
            carry = transport.move(carry, vols[t], "sgm_carry")
        if not is_local(vols[t]):
            carry = (vols[t], vols[t])
            continue
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


def _warmup_halos(vols, imgs, overlap) -> dict:
    """The ``overlap`` warm-up rows of the volume and the image before
    each tile (key 1, for the downward traversals) and after it (key -1),
    pulled once for the three traversals of each direction."""
    return {1: (halo.pull_from_prev_multi(vols, overlap),
                halo.pull_from_prev_multi(imgs, overlap)),
            -1: (halo.pull_from_next_multi(vols, overlap),
                 halo.pull_from_next_multi(imgs, overlap))}


def _overlap_traversal(vols, imgs, outs, step, p1, p2, on_card, overlap,
                       halos):
    """One row traversal over every tile from a cold start ``overlap``
    rows early in scan order, in parallel (``halos``: _warmup_halos)."""
    halo_v, halo_i = halos[step[0]]
    if step[0] > 0:        # warm-up rows precede the block
        pieces = zip(halo_v, vols), zip(halo_i, imgs)
        start = overlap
    else:                  # they follow it
        pieces = zip(vols, halo_v), zip(imgs, halo_i)
        start = 0
    for t, (vol_parts, img_parts) in enumerate(zip(*pieces)):
        if not is_local(vols[t]):
            continue
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
    ref = first_local(vols)
    if ref is None:
        return list(vols)
    fits = sgm_cuda.fits(ref.shape)
    on_card = resolve_backend(backend, ref, fits) == "cuda"
    dtype = torch.bfloat16 if ref.dtype == torch.bfloat16 \
        else torch.float32
    vols = each(lambda v: v.to(dtype).contiguous(), vols)
    imgs = each(lambda i: i.to(torch.float32).contiguous(), imgs)
    overlap = _effective_overlap(overlap, ref.shape[0], len(vols))
    halos = _warmup_halos(vols, imgs, overlap) if mode == "overlap" else None
    outs = [None] * len(vols)
    for i, step in enumerate(TRAVERSALS):
        if step[0] == 0:                         # horizontal: tile-local
            for t, (vol, img) in enumerate(zip(vols, imgs)):
                if is_local(vol):
                    outs[t] = _whole_traversal(vol, img, outs[t], step, p1,
                                               p2, on_card)
        elif mode == "exact":
            _exact_traversal(vols, imgs, outs, step, p1, p2, on_card,
                             last=i == len(TRAVERSALS) - 1)
        else:
            _overlap_traversal(vols, imgs, outs, step, p1, p2, on_card,
                               overlap, halos)
    # The one rounding of a bf16 tile's float32 sum, where the chunk
    # kernel did not already store it rounded (overlap mode, the CPU).
    return each(lambda v, o: o.to(dtype), vols, outs)


# --------------------------------------------------------------------------
# Guided-filter aggregation under row sharding
# --------------------------------------------------------------------------

def sharded_cvf(vols: Sequence[torch.Tensor], imgs: Sequence[torch.Tensor],
                *, radius: int, eps: float) -> List[torch.Tensor]:
    """The masked guided filter over one frame's row tiles: 2r halo rows
    of the volume and the guide a side, +inf beyond the image, filtered
    and cropped.  Equal to ``ops.cvf.guided_filter_aggregate(volume,
    guide, wedge_offset=None)`` of the whole frame bit for bit, in the
    volumes' dtype."""
    ref = first_local(imgs)
    if ref is None:
        return list(vols)
    rows, n, h_loc = 2 * radius, len(vols), ref.shape[0]
    if rows > h_loc:
        raise ValueError(
            f"cvf radius {radius} needs {rows} halo rows but tiles are only "
            f"{h_loc} rows tall; use fewer tiles or a smaller radius")
    vpad = halo.pad_with_halos(vols, rows, rows)
    gpad = halo.pad_with_halos(imgs, rows, rows)

    def filtered(vp, gp, t):
        outside = halo.out_of_image_mask(t, n, h_loc, rows, device=vp.device)
        vp = torch.where(outside[:, None, None],
                         torch.full((), float("inf"), dtype=vp.dtype,
                                    device=vp.device), vp)
        return guided_filter_from_padded(vp, gp, rows, rows, radius=radius,
                                         eps=eps)

    return each(filtered, vpad, gpad, range(n))


# --------------------------------------------------------------------------
# Post-processing under row sharding
# --------------------------------------------------------------------------

def _halo_padded(blocks: Sequence[torch.Tensor], rows: int,
                 beyond: float) -> List[torch.Tensor]:
    """Each tile's block with ``rows`` rows of its neighbours above and
    below, the rows beyond the image set to ``beyond``."""
    n = len(blocks)
    padded = halo.pad_with_halos(blocks, rows, rows)
    return each(lambda p, t: torch.where(
                    halo.out_of_image_mask(t, n, p.shape[0] - 2 * rows, rows,
                                           device=p.device)[:, None],
                    beyond, p), padded, range(n))


def _median3x3_rows(disps):
    """3x3 median over row tiles: one halo row a side, the image's first
    and last rows replicated beyond it, as ``refine.median_filter_3x3``
    pads (edge mode)."""
    x = each(lambda d: d.to(torch.float32), disps)
    padded = halo.pad_with_halos(x, 1, 1)
    if is_local(padded[0]):
        padded[0][0] = padded[0][1]
    if is_local(padded[-1]):
        padded[-1][-1] = padded[-1][-2]
    return each(lambda p, d: refine.median3x3_from_padded(
                    F.pad(p[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
                ).to(d.dtype), padded, disps)


def _wmf_rows(disps, guides, *, window, sigma, n_bins):
    """Guide-weighted median over row tiles: window//2 halo rows of the
    bins and of the guide, the guide +inf beyond the image (no weight),
    as ``refine.weighted_median_filter`` pads."""
    r = window // 2
    inf = float("inf")
    bins = each(lambda d: d.to(torch.float32).round().clamp(0, n_bins - 1),
                disps)
    g = each(lambda i: i.to(torch.float32), guides)
    b_pad = each(lambda b: F.pad(b, (r, r)).to(torch.int32),
                 _halo_padded(bins, r, 0.0))
    g_pad = each(lambda x: F.pad(x, (r, r), value=inf),
                 _halo_padded(g, r, inf))
    return each(lambda bp, gp, gl, d: refine._wmf_from_padded(
                    bp, gp, gl, window=window, sigma=sigma,
                    n_bins=n_bins).to(d.dtype), b_pad, g_pad, g, disps)


def _speckle_rows(disps, *, max_diff, window, min_frac, fill):
    """Speckle suppression over row tiles: window//2 halo rows, NaN beyond
    the image (no neighbour there), as ``refine.speckle_mask`` pads; the
    background fill never leaves a row."""
    r = window // 2
    nan = float("nan")
    d = each(lambda x: x.to(torch.float32), disps)
    padded = each(lambda p: F.pad(p, (r, r), value=nan),
                  _halo_padded(d, r, nan))
    masks = each(lambda p, c: refine._windowed_support(
                     p, c, max_diff=max_diff, window=window,
                     min_frac=min_frac), padded, d)
    return each(lambda x, m: refine._apply_speckle_fill(x, m, fill),
                disps, masks)


def _fgs_rows(disps, guides, confidences, *, lam, sigma_color, iterations):
    """The fast global smoother (``refine.fgs_smooth``) over row tiles.

    Row solves never leave a row.  Column solves span the tiles: each
    tile's system comes from its rows and one guide halo row a side (0
    weight beyond the image, as at the single-device border); the Thomas
    forward elimination runs down the tiles in order, each from the last
    (cp, dp) of the one above it, and the back substitution up them,
    each from the first solution row of the one below: the single-device
    recurrence, step for step."""
    n = len(disps)
    ref = first_local(disps)
    if ref is None:
        return list(disps)
    u = each(lambda d: d.to(torch.float32), disps)
    g = each(lambda i: i.to(torch.float32), guides)
    c = each(refine._fgs_confidence, u, confidences)
    inv_sigma = float(np.float32(-1.0) / np.float32(sigma_color))

    def weights(x):
        return exp_f32((x[..., 1:] - x[..., :-1]).abs() * inv_sigma)

    a_h = each(weights, g)
    # a_ext[i]: the weight between halo-extended rows i and i + 1, i.e.
    # between local rows i - 1 and i; 0 across the image's top and bottom.
    a_ext = each(lambda x: weights(x.T).T, halo.pad_with_halos(g, 1, 1))
    if is_local(a_ext[0]):
        a_ext[0][0] = 0.0
    if is_local(a_ext[-1]):
        a_ext[-1][-1] = 0.0
    a_up = each(lambda a: a[:-1].T, a_ext)        # toward y - 1, [W, Hl]
    a_down = each(lambda a: a[1:].T, a_ext)       # toward y + 1

    def vertical(u, lam_t):
        systems = each(lambda ui, ci, up, down: refine._fgs_system(
                           ui.T, ci.T, up, down, lam_t.to(ui.device)),
                       u, c, a_up, a_down)
        zero = torch.zeros(ref.shape[1], dtype=torch.float32,
                           device=ref.device)
        carry, forward = (zero, zero), list(systems)
        for t, system in enumerate(systems):
            if t:              # the Thomas forward carry, down the tiles
                carry = transport.move(carry, u[t], "fgs_forward")
            if not is_local(system):
                carry = (system, system)
                continue
            dev = system[0].device
            cps, dps = refine._thomas_forward(
                *system, *(x.to(dev) for x in carry))
            forward[t] = (cps, dps)
            carry = (cps[..., -1], dps[..., -1])
        out, u_next = list(u), (zero,)
        for t in range(n - 1, -1, -1):
            if t < n - 1:      # the first solution row, up the tiles
                u_next = transport.move(u_next, u[t], "fgs_backward")
            if not is_local(u[t]):
                u_next = (u[t],)
                continue
            cps, dps = forward[t]
            v = refine._thomas_backward(cps, dps, u_next[0].to(cps.device))
            out[t], u_next = v.T, (v[..., 0],)
        return out

    lam = torch.tensor(lam, dtype=torch.float32, device=ref.device)
    for t in range(1, iterations + 1):
        lam_t = refine._fgs_lambda_schedule(lam, iterations, t)
        u = each(lambda ui, ci, ai: refine._fgs_pass(ui, ci, ai,
                                                     lam_t.to(ui.device)),
                 u, c, a_h)
        u = vertical(u, lam_t)
    return u


# --------------------------------------------------------------------------
# Whole-pipeline assembly
# --------------------------------------------------------------------------

def _as_frames(images) -> torch.Tensor:
    """Image stacks as float32 tensors: the halo rows cross as float32,
    whatever the volumes' dtype."""
    if isinstance(images, np.ndarray):
        images = tensor_from_numpy(images)
    return images.to(torch.float32)


def check_frames(left, right, mesh: Mesh, row_multiple: int):
    """Two [B, H, W] image stacks (numpy or tensors) as float32 tensors,
    with B divisible by the mesh's batch axis and H by ``row_multiple``
    (the tile count, times 2**levels for the pyramid)."""
    left, right = _as_frames(left), _as_frames(right)
    if left.ndim != 3 or left.shape != right.shape:
        raise ValueError(f"expected two [B, H, W] stacks of one shape, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    n_batch = mesh.shape[BATCH_AXIS]
    if left.shape[0] % n_batch or left.shape[1] % row_multiple:
        raise ValueError(
            f"batch {left.shape[0]} / height {left.shape[1]} not divisible "
            f"by {n_batch} / {row_multiple} (the mesh's batch axis / its "
            f"row multiple)")
    return left, right


def map_frames(mesh: Mesh, fn: Callable, *stacks) -> dict:
    """``fn(tiles_a, tiles_b, ...)`` on each frame of the [B, H, W] stacks
    in which this process owns a tile (``mesh.frame_indices(B)``; all of
    them in one process): frame f's row tiles of batch row f //
    (B / n_batch) of the mesh, each this process owns on its device, the
    others ``transport.Remote`` placeholders (never uploaded).  Returns
    ``{frame: fn's result}`` in frame order."""
    per_row = stacks[0].shape[0] // mesh.shape[BATCH_AXIS]

    def tiles(frame, row):
        devices = mesh.devices[row]
        h_loc = frame.shape[0] // len(devices)
        return [frame[t * h_loc:(t + 1) * h_loc].to(d)
                if mesh.owns((row, t))
                else transport.Remote(mesh.processes[row][t], d)
                for t, d in enumerate(devices)]

    return {f: fn(*[tiles(s[f], f // per_row) for s in stacks])
            for f in mesh.frame_indices(stacks[0].shape[0])}


def frame_shards(mesh: Mesh, results: dict, n_frames: int) -> list:
    """This process's shards of a [B, ...] output whose frames
    ``results`` holds as grids of blocks (indexed as a batch row of the
    mesh's devices: [tile] or [tile][tile_w]): one ``(index, tensor)``
    per mesh device it owns, in grid order, JAX's addressable shards
    (``shard.index``, ``shard.data``).  The tensor stacks the block of
    each frame of the device's batch row, on the device; ``index`` holds
    the frames' slice, each tile axis's slice of the next dims, and
    ``slice(None)`` for the rest."""
    per_row = n_frames // mesh.shape[BATCH_AXIS]
    shards = []
    for b, *position in mesh.owned_positions():
        blocks = []
        for f in range(b * per_row, (b + 1) * per_row):
            block = results[f]
            for i in position:
                block = block[i]
            blocks.append(block)
        data = torch.stack(blocks)
        index = [slice(b * per_row, (b + 1) * per_row)]
        for axis, i in enumerate(position):
            size = data.shape[1 + axis]
            index.append(slice(i * size, (i + 1) * size))
        index += [slice(None)] * (data.ndim - len(index))
        shards.append((tuple(index), data))
    return shards


def assemble(mesh: Mesh, results: dict, n_frames: int):
    """A partitioner's output from its frames' tiles: this process's
    frames, in frame order, stacked on its first device (one process,
    or only the batch axis over processes), or, where a frame's tiles
    span processes, this process's shards (:func:`frame_shards`)."""
    if mesh.splits_frames:
        return frame_shards(mesh, results, n_frames)
    first = mesh.local_device
    return torch.stack([torch.cat([t.to(first) for t in tiles])
                        for tiles in results.values()])


def sgm_mode_resolver(mesh: Mesh, sgm_mode: str, *, overlap: int,
                      logger: logging.Logger) -> Callable:
    """``resolve(height, width, disp, frames) -> "exact" | "overlap"``:
    ``sgm_mode`` itself, or for "auto" the interconnect model's pick
    (``ici_model.select_sgm_mode``) for a [frames, height, width] stack
    with ``disp`` disparities, made once per geometry and logged as the
    JAX package logs it; the batch is the frames a batch row holds."""
    picks = {}

    def resolve(height, width, disp, frames):
        if sgm_mode != "auto":
            return sgm_mode
        key = (height, width, disp, frames)
        if key not in picks:
            mode, info = select_sgm_mode(
                height=height, width=width, disp=disp,
                tiles=mesh.shape[TILE_AXIS],
                batch=frames // mesh.shape[BATCH_AXIS], overlap=overlap)
            logger.info("sgm_mode=auto resolved to %r (%s)", mode, info)
            picks[key] = mode
        return picks[key]

    return resolve


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
    its device.  Over processes each rank returns its own frames
    (``mesh.frame_indices(B)``) on its first device where only the batch
    axis spans them, and its shards (``(index, tensor)`` pairs, one per
    mesh device it owns: :func:`frame_shards`) where the tile axis does.
    ``sgm_mode``:
    "exact", "overlap" or "auto" (resolved per frame geometry by
    :func:`sgm_mode_resolver`).  ``backend`` takes the port's names: "auto" (kernels on
    CUDA tiles, plain versions on CPU tiles), "cuda" or "torch".
    ``cvf_radius``/``cvf_eps`` configure ``aggregation="cvf"``
    (:func:`sharded_cvf`; 2 * ``cvf_radius`` must not exceed a tile's
    height).  The post-processing options
    follow ``Pipeline.estimate_refined`` (``lr_max_diff`` is its
    ``max_diff``; the smoother runs 3 iterations), then ``speckle``
    applies ``refine.filter_speckles`` with its defaults and
    ``speckle_fill``; with ``subpixel``, ``lr_check`` (fill) or
    ``fgs_lambda`` the output is float32.  ``interpret`` exists on the
    JAX side only (Pallas interpret mode): CPU tiles run the plain
    versions, so True raises.
    """
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
    if cost not in _COSTS:
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
    dtype = _cost_dtype(cost_dtype)
    if dtype == torch.int32 and aggregation is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2 is a float quantity)")
    if cost == "ncc" and not dtype.is_floating_point:
        raise ValueError("ncc cost is a normalized float quantity; "
                         "cost_dtype int32 is not supported")
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
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
    elif cost == "birchfield":          # float32, never leaves a row
        cost_fn = functools.partial(cost_ops.birchfield_cost_volume,
                                    max_disparity=max_disparity,
                                    kernel_size=kernel_size)
        halo_rows = (0, 0)
    elif cost != "ncc":
        # "ssd-texture": the textures' nearest samples at the pixel
        # centres are the images, so float32 SSD (the SSD kernel on the
        # card), as the single-device SSDTexture.
        cls = SAD if cost == "sad" else SSD
        cost_fn = cls(max_disparity, kernel_size=kernel_size,
                      cost_volume_dtype=(torch.float32
                                         if cost == "ssd-texture" else dtype),
                      backend=backend)
        halo_rows = (kernel_size, kernel_size - 1)
    dp = DynamicProgramming(backend=backend)
    n_tiles = mesh.shape[TILE_AXIS]
    resolve = sgm_mode_resolver(mesh, sgm_mode, overlap=overlap,
                                logger=logging.getLogger(__name__))

    def core(lefts, rights, mode):
        """One frame's per-tile (aggregated volumes, disparities)."""
        with profiling.annotate("stm/cost"):
            if cost == "ncc":
                vols = local_zncc(lefts, rights,
                                  max_disparity=max_disparity,
                                  kernel_size=kernel_size, cost_dtype=dtype)
            else:
                vols = local_cost(lefts, rights, cost_fn, *halo_rows)
        if aggregation == "sgm":
            with profiling.annotate("stm/aggregation"):
                vols = sharded_semiglobal(vols, lefts, penalty1=penalty1,
                                          penalty2=penalty2, mode=mode,
                                          overlap=overlap, backend=backend)
        elif aggregation == "cvf":
            with profiling.annotate("stm/aggregation"):
                vols = sharded_cvf(vols, lefts, radius=int(cvf_radius),
                                   eps=float(cvf_eps))
        with profiling.annotate("stm/disparity_reduce"):
            if reducer == "wta":
                return vols, each(winner_takes_all, vols)
            return vols, each(dp, vols)

    def refined(vols, disps, lefts, disps_r):
        """The post-processing stages, in estimate_refined's order."""
        if lr_check:
            if disps_r is None:
                disps_r = each(refine.right_disparity_from_volume, vols)
            masks = each(lambda d, dr: refine.left_right_consistency(
                             d, dr, lr_max_diff, max_disparity=max_disparity),
                         disps, disps_r)
            disps = each(refine.fill_inconsistent, disps, masks)
        if weighted_median:
            disps = _wmf_rows(disps, lefts, window=wmf_window,
                              sigma=wmf_sigma, n_bins=max_disparity)
        if median:
            disps = _median3x3_rows(disps)
        if subpixel:
            disps = each(lambda v, d: refine.subpixel_refine(
                             v, disparity_bins(d, max_disparity)),
                         vols, disps)
        if fgs_lambda is not None:
            confs = (each(lambda m: m.to(torch.float32), masks) if lr_check
                     else [None] * len(disps))
            disps = _fgs_rows(disps, lefts, confs, lam=fgs_lambda,
                              sigma_color=fgs_sigma, iterations=3)
        if min_confidence is not None:
            disps = each(lambda v, d: torch.where(
                             refine.confidence_pkrn(v) >= min_confidence, d,
                             torch.zeros((), dtype=d.dtype, device=d.device)),
                         vols, disps)
        if speckle:
            disps = _speckle_rows(disps, max_diff=1.0, window=9,
                                  min_frac=0.25, fill=speckle_fill)
        return disps

    def frame(lefts, rights, mode):
        disps_r = None
        if lr_check and lr_mode == "mirror":
            # Right-to-left matching is left-to-right matching on the
            # mirrored pair (refine.right_disparity); W is never split.
            flip = functools.partial(torch.flip, dims=(-1,))
            mirrored = core(each(flip, rights), each(flip, lefts), mode)[1]
            disps_r = each(flip, mirrored)
        vols, disps = core(lefts, rights, mode)
        return refined(vols, disps, lefts, disps_r)

    def fn(left, right):
        left, right = check_frames(left, right, mesh, n_tiles)
        b, h, w = left.shape
        mode = resolve(h, w, max_disparity, b) if aggregation == "sgm" \
            else None
        return assemble(mesh, map_frames(
            mesh, functools.partial(frame, mode=mode), left, right), b)

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

    def estimate(self, left, right):
        """[B, H, W] (or [H, W], auto-batched) -> [B, H, W] int32 (float32
        after sub-pixel, LR fill or the smoother) on the mesh's first
        device.  Over processes: this process's frames, in frame order,
        on its first device (``mesh.frame_indices(B)`` gives their global
        indices) where only the batch axis spans them; where the tile axis
        does, this process's shards, ``(index, tensor)`` pairs (of frame 0
        for an [H, W] pair, the batch slice dropped)."""
        left, right = _as_frames(left), _as_frames(right)
        squeeze = left.ndim == 2
        if squeeze:
            n_batch = self.mesh.shape[BATCH_AXIS]
            left = left.expand((n_batch,) + tuple(left.shape))
            right = right.expand((n_batch,) + tuple(right.shape))
        out = self._fn(left, right)
        if not squeeze:
            return out
        if isinstance(out, list):          # shards: those of frame 0
            return [(index[1:], data[0]) for index, data in out
                    if index[0].start == 0]
        return out[0]
