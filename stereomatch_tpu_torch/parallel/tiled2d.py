"""2-D image tiles over a (batch, tile, tile_w) mesh, the counterpart of
``stereomatch_tpu/parallel/tiled2d.py``: image rows split over ``tile``,
columns over ``tile_w``, frames over ``batch``.

A frame is a [n_tile][n_tile_w] grid of blocks, each on its device.
Every process that owns a block of the frame walks the same grid in the
same order and computes only its own blocks (another process's block is
a ``transport.Remote`` placeholder); over processes any axis may span
them (each rank computes the frames of the batch rows it has a device
in, ``Mesh.frame_indices``).  What crosses blocks moves through
``transport.exchange``: ``.to()`` of the receiving block's device within
a process, a send and a receive between processes
(``halo.pad_with_halos``, zero beyond the image, as ``lax.ppermute``
fills the ring ends).  Halos go along the tile axis first, then along
tile_w on the row-extended blocks, so the column halos carry the
corners.  Where a frame's blocks span processes, each rank returns its
shards (``sharded.frame_shards``).

* Cost: each block's image rows, gathered to full width along tile_w
  (JAX's ``all_gather``), take the row halos of the row-sharded cost
  (``sharded.local_cost``; ZNCC through ``sharded.local_zncc``, whose
  per-row sums over every tile keep it bit-equal to one device; census
  window//2 rows; Birchfield none), then the block keeps its columns.  On the card the
  SSD/SAD volume of the band is one launch of the SSD kernel (K1).
* SGM: every block extends its volume and image by ``overlap`` on all
  four sides (at most a block's height and width) and runs the
  single-device 8-path aggregation (``aggregation.Semiglobal``: K2/K3 on
  the card) on the extended block, then keeps its centre.  A zero halo
  is the recurrence's identity, so a block bordering the image is exact
  on that side, and an overlap that covers the image is exact
  everywhere; a shorter one is a warm-up, close but not exact.
* CVF: 2r halos a side in both axes, +inf beyond the image, the masked
  filter on the extended block, its centre kept: exact (the filter has
  finite support).  The +inf pattern is not a wedge, so this is the
  plain masked path on every device.
* DP: exact over tile_w: the forward accumulator [Hl, D] passes left to
  right (a chain of moves) through ``ops.disparity.dp_forward_chunk``,
  the rightmost block
  takes the scanline argmin, and the decided column passes back right to
  left through ``dp_backward_chunk`` (the JAX package runs this in XLA,
  not Pallas: plain PyTorch here on every device).
* Post-processing, in the JAX order: the volume-mode LR check (a (D-1)
  column volume halo from the right, a (D-1) disparity halo from the
  left, the background fill's scans chained across tile_w), weighted
  median, 3x3 median, sub-pixel, the PKRN gate and speckle suppression,
  each with the halos and edge fills of its single-device padding.

Every stage equals the JAX package's ``make_tiled2d_estimate`` bit for
bit on the CPU (the tests hold it at every mode), and the kernels on the
card equal the plain versions.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch

from ..aggregation import Semiglobal
from ..cost import SAD, SSD, Census
from ..ops import cost as cost_ops
from ..ops import refine
from ..ops.cvf import _filter_body_masked
from ..ops.disparity import (dp_backward_chunk, dp_end_disparities,
                             dp_forward_chunk, winner_takes_all)
from ..pipeline import disparity_bins
from ..utils import profiling
from . import halo, transport
from .mesh import BATCH_AXIS, TILE_AXIS, Mesh, world_layout
from .sharded import _as_frames, frame_shards, local_cost, local_zncc
from .transport import each, first_local, is_local

TILE_W_AXIS = "tile_w"
_COSTS = ("ssd", "ssd-texture", "birchfield", "census", "sad", "ncc")

Grid = List[List[torch.Tensor]]


def make_mesh_2d(devices: Optional[Sequence] = None, n_batch: int = 1,
                 n_tile: int = 2, n_tile_w: int = 2) -> Mesh:
    """A (batch, tile, tile_w) mesh over the first n_batch * n_tile *
    n_tile_w of ``devices`` (this process's; devices may repeat, e.g.
    ``[torch.device("cpu")] * 8``), by default of the world's devices in
    (rank, local index) order (``mesh.make_mesh``'s default), where any
    axis may span processes."""
    processes = None
    if devices is None:
        devices, processes = world_layout("make_mesh_2d()")
    devices = list(devices)
    need = n_batch * n_tile * n_tile_w
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")

    def grid(items):
        return [[items[(b * n_tile + t) * n_tile_w:
                       (b * n_tile + t + 1) * n_tile_w]
                 for t in range(n_tile)] for b in range(n_batch)]

    return Mesh(grid(devices), axis_names=(BATCH_AXIS, TILE_AXIS,
                                           TILE_W_AXIS),
                processes=None if processes is None else grid(processes))


# --------------------------------------------------------------------------
# Grids of blocks
# --------------------------------------------------------------------------

def _lines(grid: Grid, axis: int) -> List[List[torch.Tensor]]:
    """The grid's lines along one mesh axis: axis 0 (tile) gives its
    columns of blocks, axis 1 (tile_w) its rows of blocks."""
    if axis == 0:
        return [[row[s] for row in grid] for s in range(len(grid[0]))]
    return [list(row) for row in grid]


def _from_lines(lines, axis: int) -> Grid:
    if axis == 0:
        return [[line[t] for line in lines] for t in range(len(lines[0]))]
    return [list(line) for line in lines]


def _map(fn: Callable, *grids) -> Grid:
    """``fn`` on each block this process owns (and the blocks beside it
    in ``grids``); another process's block stays its placeholder."""
    return [each(fn, *rows) for rows in zip(*grids)]


def _first(grid: Grid) -> Optional[torch.Tensor]:
    return first_local([block for row in grid for block in row])


def _pad(grid: Grid, count: int, axis: int, beyond=0.0) -> Grid:
    """Each block with ``count`` slices of its neighbours along mesh axis
    ``axis`` (0: rows, from the tile axis; 1: columns, from tile_w) on
    both sides, the slices beyond the image set to ``beyond``: a value,
    or "edge" (``count`` 1: the image's edge slice repeated)."""
    out = []
    for line in _lines(grid, axis):
        n = len(line)
        padded = halo.pad_with_halos(line, count, count, axis)
        for i, p in enumerate(padded):
            if not is_local(p):
                continue
            local = p.shape[axis] - 2 * count
            if beyond == "edge":
                if i == 0:
                    p.narrow(axis, 0, 1).copy_(p.narrow(axis, 1, 1))
                if i == n - 1:
                    p.narrow(axis, -1, 1).copy_(p.narrow(axis, -2, 1))
            elif beyond != 0.0 and count:
                outside = halo.out_of_image_mask(i, n, local, count,
                                                 device=p.device)
                shape = [1] * p.ndim
                shape[axis] = -1
                padded[i] = torch.where(outside.view(shape),
                                        torch.full((), beyond, dtype=p.dtype,
                                                   device=p.device), p)
        out.append(padded)
    return _from_lines(out, axis)


def _extend(grid: Grid, rows: int, cols: int, beyond=0.0) -> Grid:
    """Row halos, then column halos of the row-extended blocks (which
    carry the corners), as the JAX package's two ppermute rounds."""
    return _pad(_pad(grid, rows, 0, beyond), cols, 1, beyond)


def _crop(grid: Grid, rows: int, cols: int, h_loc: int, w_loc: int) -> Grid:
    return _map(lambda x: x[rows:rows + h_loc, cols:cols + w_loc], grid)


# --------------------------------------------------------------------------
# Stages across tile_w
# --------------------------------------------------------------------------

def _dp_tiled_w(vols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Exact scanline DP of one row of blocks (left to right).  The first
    block starts from a zero accumulator with pointer column 0 cleared,
    as the JAX package seeds it."""
    n = len(vols)
    ptrs, acc = list(vols), None
    for s, vol in enumerate(vols):
        if s:                  # the accumulator, from the block to the left
            acc, = transport.move((acc,), vol, "dp_forward")
        if not is_local(vol):
            acc = vol
            continue
        if acc is None:
            acc = torch.zeros((vol.shape[0], vol.shape[2]),
                              dtype=torch.float32, device=vol.device)
        ptr, acc = dp_forward_chunk(vol, acc.to(vol.device))
        if s == 0:
            ptr[:, 0] = 0
        ptrs[s] = ptr
    cur = dp_end_disparities(acc) if is_local(acc) else acc
    out = list(vols)
    for s in range(n - 1, -1, -1):
        if s < n - 1:          # the decided column, from the block right
            cur, = transport.move((cur,), vols[s], "dp_backward")
        if not is_local(vols[s]):
            cur = vols[s]
            continue
        out[s], cur = dp_backward_chunk(ptrs[s], cur.to(ptrs[s].device),
                                        emit_current=s == n - 1)
    return out


def _chained_fill(vals, ok):
    """Per block of a row (left to right), the last valid value at or
    left of each column, the blocks' scans stitched by a [Hl] carry;
    NaN where no block to the left holds one."""
    out, carry = list(vals), None
    for i, (v, k) in enumerate(zip(vals, ok)):
        if i:                  # the carry, from the block to the left
            carry, = transport.move((carry,), v, "fill")
        if not is_local(v):
            carry = v
            continue
        filled = refine.propagate_last_valid(v, k)
        if carry is None:
            carry = torch.full(v.shape[:-1], float("nan"),
                               dtype=filled.dtype, device=v.device)
        carry = carry.to(v.device)
        out[i] = torch.where(torch.isnan(filled), carry[..., None], filled)
        carry = torch.where(k.any(dim=-1), filled[..., -1], carry)
    return out


def _fill_inconsistent_tiled_w(disps, valids) -> List[torch.Tensor]:
    """``refine.fill_inconsistent`` over a row of blocks: both scanline
    scans chained across the blocks (selections only: bit-identical to
    the whole row)."""
    flip = functools.partial(torch.flip, dims=(-1,))
    d_f = each(lambda d: d.to(torch.float32), disps)
    ok = each(lambda v: v.to(torch.bool), valids)
    left = _chained_fill(d_f, ok)
    right = _chained_fill(each(flip, d_f[::-1]), each(flip, ok[::-1]))
    right = each(flip, right[::-1])

    def filled(d, v, lf, rf):
        out = torch.where(v, d, torch.fmin(lf, rf))
        return torch.where(torch.isnan(out), d, out)

    return each(filled, d_f, ok, left, right)


def _lr_check_tiled_w(aggs, disps, *, max_diff: int) -> List[torch.Tensor]:
    """The volume-mode left-right check over a row of blocks: the right
    disparity from a (D-1)-column volume halo from the right (+inf beyond
    the image), the consistency test on a (D-1)-column disparity halo
    from the left (never agreeing beyond the image), then the chained
    background fill."""
    ref = first_local(aggs)
    if ref is None:                       # no block of this row here
        return list(disps)
    n, w_loc, max_disp = len(aggs), ref.shape[1], ref.shape[2]
    d_halo = max_disp - 1
    if d_halo:
        def right_disparity(agg, tail, s):
            ext = torch.cat([agg, tail], dim=1)
            outside = halo.out_of_image_mask(s, n, w_loc, 0, d_halo,
                                             device=ext.device)
            ext = torch.where(outside[None, :, None],
                              torch.full((), float("inf"), dtype=ext.dtype,
                                         device=ext.device), ext)
            return winner_takes_all(
                refine.right_volume_from_padded(ext, width=w_loc))

        def far_padded(d_r, head, s):
            p = torch.cat([head, d_r], dim=1)
            outside = halo.out_of_image_mask(s, n, w_loc, d_halo, 0,
                                             device=p.device)
            return torch.where(outside[None, :], refine._FAR, p)

        right = each(right_disparity, aggs,
                     halo.pull_from_next_multi(aggs, d_halo, 1), range(n))
        padded = each(far_padded, right,
                      halo.pull_from_prev_multi(right, d_halo, 1), range(n))
    else:
        padded = each(lambda a: winner_takes_all(
            refine.right_volume_from_padded(a, width=w_loc)), aggs)
    valid = each(lambda d, p: refine.consistency_from_padded(
                     d, p, pad=d_halo, n_planes=max_disp, max_diff=max_diff),
                 disps, padded)
    return _fill_inconsistent_tiled_w(disps, valid)


# --------------------------------------------------------------------------
# Post-processing over 2-D tiles
# --------------------------------------------------------------------------

def _median3x3_tiled(disps: Grid) -> Grid:
    """3x3 median: one halo row and column, the image's edge replicated
    beyond it (the single-device edge padding)."""
    x = _extend(_map(lambda d: d.to(torch.float32), disps), 1, 1, "edge")
    return _map(lambda p, d: refine.median3x3_from_padded(p).to(d.dtype),
                x, disps)


def _wmf_tiled(disps: Grid, guides: Grid, *, window: int, sigma: float,
               n_bins: int) -> Grid:
    """Guide-weighted median: window//2 halos of the bins (0 beyond the
    image) and of the guide (+inf beyond it: no weight)."""
    r = window // 2
    bins = _map(lambda d: d.to(torch.float32).round().clamp(0, n_bins - 1)
                .to(torch.int32), disps)
    g = _map(lambda x: x.to(torch.float32), guides)
    b_pad = _extend(bins, r, r)
    g_pad = _extend(g, r, r, float("inf"))
    return _map(lambda bp, gp, gl, d: refine._wmf_from_padded(
                    bp, gp, gl, window=window, sigma=sigma,
                    n_bins=n_bins).to(d.dtype),
                b_pad, g_pad, g, disps)


def _speckle_tiled(disps: Grid, *, fill: str, window: int = 9,
                   max_diff: float = 1.0, min_frac: float = 0.25) -> Grid:
    """Windowed-support speckle suppression: window//2 halos, NaN beyond
    the image; the background fill chained across tile_w."""
    r = window // 2
    d = _map(lambda x: x.to(torch.float32), disps)
    padded = _extend(d, r, r, float("nan"))
    masks = _map(functools.partial(refine._windowed_support,
                                   max_diff=max_diff, window=window,
                                   min_frac=min_frac), padded, d)
    if fill == "background":
        return [_fill_inconsistent_tiled_w(row, m)
                for row, m in zip(disps, masks)]
    return _map(lambda x, m: torch.where(
        m, x, torch.zeros((), dtype=x.dtype, device=x.device)), disps, masks)


# --------------------------------------------------------------------------
# Whole-pipeline assembly
# --------------------------------------------------------------------------

def make_tiled2d_estimate(mesh: Mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          census_window: int = 5,
                          reducer: str = "wta",
                          aggregation: Optional[str] = "sgm",
                          penalty1: float = 0.1, penalty2: float = 0.2,
                          cvf_radius: int = 8, cvf_eps: float = 1e-4,
                          overlap: int = 48,
                          backend: str = "auto",
                          median: bool = False,
                          subpixel: bool = False,
                          lr_check: bool = False,
                          lr_mode: str = "volume",
                          lr_max_diff: int = 1,
                          weighted_median: bool = False,
                          wmf_sigma: float = 10.0,
                          wmf_window: int = 5,
                          min_confidence: Optional[float] = None,
                          speckle: bool = False,
                          speckle_fill: str = "zero",
                          interpret: bool = False) -> Callable:
    """Cost + aggregation + reduce over a 2-D tile mesh, with the JAX
    package's keywords.

    ``aggregation``: "sgm" (8-path SGM on the overlap-extended block:
    exact where ``overlap`` covers the image, a warm-up below it), "cvf"
    (exact; 2 * ``cvf_radius`` must not exceed a block's sides) or None.
    Returns ``fn(left, right) -> disparity``: [B, H, W] stacks (numpy or
    tensors, any device) with B, H, W divisible by the batch, tile and
    tile_w axes -> [B, H, W] on the mesh's first device, int32 (float32
    after the LR fill, sub-pixel or a background speckle fill); where the
    tile or tile_w axis spans processes, this rank's shards, one
    ``(index, tensor)`` pair per mesh device it owns
    (``sharded.frame_shards``).
    ``backend`` takes the port's names: "auto" (the kernels on CUDA
    blocks, the plain versions on CPU blocks), "cuda" or "torch".
    ``lr_check`` supports ``lr_mode="volume"`` only: the mirrored run's
    flip crosses every tile_w block.  ``interpret`` exists on the JAX
    side only (Pallas interpret mode), so True raises.
    """
    if cost not in _COSTS:
        raise ValueError(f"unknown cost {cost!r}")
    if reducer not in ("wta", "dynamic_programming"):
        raise ValueError(f"unknown reducer {reducer!r}")
    if aggregation not in (None, "sgm", "cvf"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    if speckle_fill not in ("zero", "background"):
        raise ValueError(f"unknown fill mode: {speckle_fill!r}")
    if lr_check and lr_mode != "volume":
        raise ValueError(
            f"2-D tiling supports lr_mode='volume' only (got {lr_mode!r}): "
            "the mirror run's W flip crosses every tile_w shard; use the "
            "row-sharded pipeline for lr_mode='mirror'")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'cuda' or 'torch'")
    if interpret:
        raise ValueError("interpret=True is the JAX package's Pallas "
                         "interpret mode; the port runs its plain versions "
                         "on CPU tiles instead")
    if kernel_size is None:
        kernel_size = 4 if cost == "birchfield" else 7
    n_batch = mesh.shape[BATCH_AXIS]
    n_tile, n_tile_w = mesh.shape[TILE_AXIS], mesh.shape[TILE_W_AXIS]
    sgm = Semiglobal(penalty1, penalty2, backend=backend)
    if cost == "census":
        cost_fn = Census(max_disparity, window_size=census_window)
        halo_rows = (census_window // 2,) * 2
    elif cost == "birchfield":              # never leaves a row
        cost_fn = functools.partial(cost_ops.birchfield_cost_volume,
                                    max_disparity=max_disparity,
                                    kernel_size=kernel_size)
        halo_rows = (0, 0)
    elif cost != "ncc":
        # "ssd-texture": the textures' samples at the pixel centres are
        # the images, so float32 SSD, as the single-device SSDTexture.
        cost_fn = (SAD if cost == "sad" else SSD)(
            max_disparity, kernel_size=kernel_size, backend=backend)
        halo_rows = (kernel_size, kernel_size - 1)

    def volumes(lefts: Grid, rights: Grid, w_loc: int) -> Grid:
        """Each block's cost volume, from its full-width image rows."""
        def full(row):
            # Every block of the row moved to each block (all_gather).
            n = len(row)
            landed = transport.exchange([(b, blk) for blk in row
                                         for b in row], "band")
            return [torch.cat(landed[s * n:(s + 1) * n], dim=1)
                    if is_local(blk) else blk for s, blk in enumerate(row)]
        lf = [full(row) for row in lefts]
        rf = [full(row) for row in rights]
        lines = []
        for lcol, rcol in zip(_lines(lf, 0), _lines(rf, 0)):
            if cost == "ncc":
                lines.append(local_zncc(lcol, rcol,
                                        max_disparity=max_disparity,
                                        kernel_size=kernel_size,
                                        cost_dtype=torch.float32))
            else:
                lines.append(local_cost(lcol, rcol, cost_fn, *halo_rows))
        vols = _from_lines(lines, 0)
        return [[v[:, s * w_loc:(s + 1) * w_loc].to(torch.float32)
                 if is_local(v) else v for s, v in enumerate(row)]
                for row in vols]

    def aggregate(vols: Grid, lefts: Grid, h_loc: int, w_loc: int) -> Grid:
        if aggregation == "sgm":
            ov_h, ov_w = min(overlap, h_loc), min(overlap, w_loc)
            ext = _extend(vols, ov_h, ov_w)
            img = _extend(lefts, ov_h, ov_w)
            return _crop(_map(sgm, ext, img), ov_h, ov_w, h_loc, w_loc)
        if aggregation == "cvf":
            ov = 2 * cvf_radius
            if ov > h_loc or ov > w_loc:
                raise ValueError(
                    f"cvf radius {cvf_radius} needs {ov} halo rows/cols "
                    f"but tiles are {h_loc}x{w_loc}; use fewer tiles or "
                    f"a smaller radius")
            ext = _extend(vols, ov, ov, float("inf"))
            img = _extend(lefts, ov, ov)
            out = _map(lambda v, g: _filter_body_masked(
                v, g, int(cvf_radius), float(cvf_eps), False), ext, img)
            return _crop(out, ov, ov, h_loc, w_loc)
        return vols

    def frame(lefts: Grid, rights: Grid) -> Grid:
        h_loc, w_loc = _first(lefts).shape
        with profiling.annotate("stm/cost"):
            vols = volumes(lefts, rights, w_loc)
        with profiling.annotate("stm/aggregation"):
            aggs = aggregate(vols, lefts, h_loc, w_loc)
        with profiling.annotate("stm/disparity_reduce"):
            if reducer == "dynamic_programming":
                disps = [_dp_tiled_w(row) for row in aggs]
            else:
                disps = _map(winner_takes_all, aggs)
        if lr_check:
            disps = [_lr_check_tiled_w(a, d, max_diff=lr_max_diff)
                     for a, d in zip(aggs, disps)]
        if weighted_median:
            disps = _wmf_tiled(disps, lefts, window=wmf_window,
                               sigma=wmf_sigma, n_bins=max_disparity)
        if median:
            disps = _median3x3_tiled(disps)
        if subpixel:
            disps = _map(lambda a, d: refine.subpixel_refine(
                a, disparity_bins(d, max_disparity)), aggs, disps)
        if min_confidence is not None:
            disps = _map(lambda a, d: torch.where(
                refine.confidence_pkrn(a) >= min_confidence, d,
                torch.zeros((), dtype=d.dtype, device=d.device)),
                aggs, disps)
        if speckle:
            disps = _speckle_tiled(disps, fill=speckle_fill)
        return disps

    def fn(left, right) -> torch.Tensor:
        left, right = _as_frames(left), _as_frames(right)
        if left.ndim != 3 or left.shape != right.shape:
            raise ValueError(f"expected two [B, H, W] stacks of one shape, "
                             f"got {tuple(left.shape)} and "
                             f"{tuple(right.shape)}")
        b, h, w = left.shape
        if b % n_batch or h % n_tile or w % n_tile_w:
            raise ValueError(
                f"batch/height/width {tuple(left.shape)} not divisible by "
                f"mesh axes {(n_batch, n_tile, n_tile_w)}")
        h_loc, w_loc = h // n_tile, w // n_tile_w
        per_row = b // n_batch
        results = {}
        for f in mesh.frame_indices(b):
            row = f // per_row

            def split(image):
                return [[image[t * h_loc:(t + 1) * h_loc,
                               s * w_loc:(s + 1) * w_loc].to(
                                   mesh.devices[row][t][s])
                         if mesh.owns((row, t, s)) else transport.Remote(
                             mesh.processes[row][t][s],
                             mesh.devices[row][t][s])
                         for s in range(n_tile_w)] for t in range(n_tile)]

            results[f] = frame(split(left[f]), split(right[f]))
        if mesh.splits_frames:
            return frame_shards(mesh, results, b)
        first = mesh.local_device
        return torch.stack([torch.cat([torch.cat([d.to(first) for d in row],
                                                 dim=1) for row in disps])
                            for disps in results.values()])

    return fn
