"""Semiglobal-matching cost aggregation, plain PyTorch version.

Port of ``stereomatch_tpu/ops/aggregation.py``: each path family is one
scan whose carry holds the running path costs of all of the family's
paths at once, and the eight traversals accumulate into one volume.  It
runs on any device and is the oracle of the CUDA kernels in
``ops/sgm_cuda.py``; ``aggregation.Semiglobal`` chooses between them.

  family          scan axis   carry [N, D]   predecessor offset in carry
  horizontal      W           N = H          0
  vertical        H           N = W          0
  diagonal (1,1)  H           N = W          +1  (came from column x-1)
  diagonal (-1,1) H           N = W          -1  (came from column x+1)

Recurrence (reference ``src/semiglobal.cpp:137-152``), run normalised
as the XLA scan runs it:
    n = prev - min_d prev
    L(p, d) = C(p, d) + min(n[d], n[d-1] + P1, n[d+1] + P1, P2_adj)
    P2_adj  = max(P1, P2 / |I(p) - I(p-1)|)   (|dI| = 0 gives +inf)
or, with ``adaptive_p2=False`` (Hirschmuller's constant form, the port's
own: the JAX package has only the adaptive one), P2_adj = max(P1, P2)
at every step; with +inf beyond the band, L = C at every path start (the
first step of the scan, and the column a diagonal enters through), and
the traversals summed in the order of ``TRAVERSALS``.  Every step is
elementwise IEEE arithmetic in the XLA scan's association, so the result
equals ``stereomatch_tpu.ops.aggregation.semiglobal_aggregate`` bit for
bit.
"""

from __future__ import annotations

import torch

# The eight traversals as pixel steps (dy, dx), in the order the XLA
# oracle sums them (stereomatch_tpu/ops/aggregation.py:214-225):
# horizontal forward/reverse, vertical forward/reverse, diagonal (1,1)
# forward/reverse, diagonal (-1,1) forward/reverse.
TRAVERSALS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))


def sgm_band(prev, prev_int, intensity, p1, p2, inf_col, grad_floor=None,
             adaptive_p2: bool = True):
    """The band term of one SGM step: ``min(n[d], n[d-1] + P1,
    n[d+1] + P1, P2_adj)`` over the normalised carry ``n``.

    ``prev`` is [..., D], the intensities [...], ``inf_col`` the +inf
    column [..., 1]; the penalties are float32 0-d tensors.  Normalising
    first makes the P2 candidate P2_adj itself, with no trailing "- min"
    (the XLA scan's association).  ``grad_floor``, where given, floors
    |dI| so that the division has a finite backward pass
    (``ops/soft.py``).  ``adaptive_p2=False`` takes P2_adj = max(P1, P2)
    and reads no intensity.
    """
    prev_min = prev.amin(dim=-1, keepdim=True)                   # [..., 1]
    if adaptive_p2:
        grad = (intensity - prev_int).abs()                      # [...]
        if grad_floor is not None:
            grad = torch.maximum(grad, grad_floor)
        p2_adj = torch.maximum(p1, p2 / grad)[..., None]         # [..., 1]
    else:
        p2_adj = torch.maximum(p1, p2)
    prevn = prev - prev_min
    up = torch.cat([inf_col, prevn[..., :-1]], dim=-1)           # d - 1
    down = torch.cat([prevn[..., 1:], inf_col], dim=-1)          # d + 1
    return torch.minimum(torch.minimum(prevn, up + p1),
                         torch.minimum(down + p1, p2_adj))


def sgm_scan_with_carry(cost_sv: torch.Tensor, image_sv: torch.Tensor,
                        penalty1: float, penalty2: float, carry_shift: int,
                        init_carry=None, seed_first: bool = True,
                        adaptive_p2: bool = True):
    """Run one SGM sweep over scan-major inputs, exposing the carry.

    Args:
      cost_sv: [S, N, D] float32 or bf16 cost (widened to float32 step by
        step), S = scan axis (path direction), N = the family's parallel
        paths, D = disparity.
      image_sv: [S, N] float32 left-image intensities in the same layout.
      penalty1/penalty2: SGM penalties (rounded to float32).
      carry_shift: predecessor offset along N (0 for axis-aligned paths,
        +1 / -1 for diagonals).
      init_carry: optional (prev_costs [N, D], prev_intensity [N]) from a
        preceding chunk of a split scan axis; None means path start.
      seed_first: whether step 0 is a true path start that re-seeds from
        the raw cost; False for continuation chunks.
      adaptive_p2: the adaptive P2 (True) or the constant max(P1, P2).

    Returns:
      ((final_prev [N, D], final_intensity [N]), contributions [S, N, D]),
      all float32.
    """
    device = cost_sv.device
    n = cost_sv.shape[1]
    p1 = torch.full((), penalty1, dtype=torch.float32, device=device)
    p2 = torch.full((), penalty2, dtype=torch.float32, device=device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    # The column a diagonal enters the image through: a path start at
    # every step.
    edge_start = torch.zeros((n, 1), dtype=torch.bool, device=device)
    if carry_shift > 0:
        edge_start[0] = True
    elif carry_shift < 0:
        edge_start[n - 1] = True

    def shift_n(arr, fill):
        if carry_shift == 0:
            return arr
        mask = edge_start if arr.ndim == 2 else edge_start[:, 0]
        return torch.where(mask, fill, torch.roll(arr, carry_shift, 0))

    if init_carry is None:
        prev = torch.full(cost_sv.shape[1:], float("inf"),
                          dtype=torch.float32, device=device)
        prev_int = torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        prev = init_carry[0].to(torch.float32)
        prev_int = init_carry[1].to(torch.float32)

    inf_col = inf.expand(n, 1)
    contributions = []
    for s in range(cost_sv.shape[0]):
        cost = cost_sv[s].to(torch.float32)
        intensity = image_sv[s]
        prev = shift_n(prev, inf)
        prev_int = shift_n(prev_int, zero)

        sgm = cost + sgm_band(prev, prev_int, intensity, p1, p2, inf_col,
                              adaptive_p2=adaptive_p2)

        start = edge_start | (s == 0 and seed_first)
        prev = torch.where(start, cost, sgm)
        prev_int = intensity
        contributions.append(prev)
    return (prev, prev_int), torch.stack(contributions)


def _sgm_scan(cost_sv, image_sv, p1, p2, carry_shift, adaptive_p2):
    """One full-axis sweep; returns the contributions only."""
    return sgm_scan_with_carry(cost_sv, image_sv, p1, p2, carry_shift,
                               adaptive_p2=adaptive_p2)[1]


def _sweep_horizontal(cost, image, p1, p2, reverse, adaptive_p2):
    vol = cost.transpose(0, 1)                # [W, H, D]: scan over W
    img = image.transpose(0, 1)
    if reverse:
        vol, img = vol.flip(0), img.flip(0)
    out = _sgm_scan(vol, img, p1, p2, 0, adaptive_p2)
    if reverse:
        out = out.flip(0)
    return out.transpose(0, 1)


def _sweep_vertical(cost, image, p1, p2, reverse, adaptive_p2):
    vol, img = cost, image                    # [H, W, D]: scan over H
    if reverse:
        vol, img = vol.flip(0), img.flip(0)
    out = _sgm_scan(vol, img, p1, p2, 0, adaptive_p2)
    if reverse:
        out = out.flip(0)
    return out


def _sweep_diagonal(cost, image, p1, p2, down_right, reverse, adaptive_p2):
    """Scan over H with a carry shift along W; the inverse traversal is
    the same scan over the volume rotated by 180 degrees."""
    vol, img = cost, image
    if reverse:
        vol, img = vol.flip(0, 1), img.flip(0, 1)
    out = _sgm_scan(vol, img, p1, p2, 1 if down_right else -1, adaptive_p2)
    if reverse:
        out = out.flip(0, 1)
    return out


def sweep(cost: torch.Tensor, image: torch.Tensor, penalty1: float,
          penalty2: float, step: tuple,
          adaptive_p2: bool = True) -> torch.Tensor:
    """Path costs L [H, W, D] of the one traversal of ``TRAVERSALS`` whose
    pixel step is ``step`` = (dy, dx)."""
    dy, dx = step
    if dy == 0:
        return _sweep_horizontal(cost, image, penalty1, penalty2, dx < 0,
                                 adaptive_p2)
    if dx == 0:
        return _sweep_vertical(cost, image, penalty1, penalty2, dy < 0,
                               adaptive_p2)
    return _sweep_diagonal(cost, image, penalty1, penalty2, dy == dx,
                           dy < 0, adaptive_p2)


def sweep_chunk_with_carry(cost: torch.Tensor, image: torch.Tensor,
                           step: tuple, carry=None, carry_image=None, *,
                           penalty1: float, penalty2: float, seed: bool,
                           adaptive_p2: bool = True):
    """One row traversal (``step`` = (dy, dx), dy = +-1) over a chunk of
    rows, continuing the paths of the row before the chunk.

    The plain version, and oracle, of ``sgm_cuda.sweep_chunk_with_carry_cuda``
    (the counterpart of the TPU's ``_chunk_kernel``): the exact hand-off of
    the row-sharded pipeline, where each row tile continues every path
    from its predecessor tile in scan order.

    Args:
      cost: [Hc, W, D] float32 or bf16, the chunk's rows in image order
        (the contributions and carries are float32 either way).
      image: [Hc, W] float32 left-image intensities of the chunk.
      carry: [W, D] path costs of the row just before the chunk in scan
        order (image row above it for dy = 1, below it for dy = -1),
        indexed by image column; required unless ``seed``.
      carry_image: [W] intensities of that row.
      seed: the chunk's first row in scan order is the image's: every
        path starts there with L = C and the carry is not read.
      adaptive_p2: the adaptive P2 (True) or the constant max(P1, P2).

    Returns:
      (contributions [Hc, W, D], (carry [W, D], intensities [W]) of the
      chunk's last row in scan order), in image coordinates.  A chunk of
      the whole image with ``seed=True`` gives ``sweep(...)`` bit for bit:
      this is its scan, with the flips of ``_sweep_vertical`` and
      ``_sweep_diagonal``.
    """
    dy, dx = step
    if dy not in (1, -1) or dx not in (-1, 0, 1):
        raise ValueError(f"a chunk sweep takes a row traversal, got {step}")
    if not seed and (carry is None or carry_image is None):
        raise ValueError("a chunk that does not seed needs the carry and "
                         "intensities of the row before it")
    # The scan frame: reversed traversals scan the flipped block, and the
    # diagonals flip W with H (the volume rotated by 180 degrees).
    dims = (0,) if dx == 0 else (0, 1)
    shift = 0 if dx == 0 else (1 if dy == dx else -1)
    vol, img = cost, image
    init = None if seed else (carry, carry_image)
    if dy < 0:
        vol, img = vol.flip(dims), img.flip(dims)
        if dx != 0 and init is not None:
            init = (init[0].flip(0), init[1].flip(0))
    (final, final_image), out = sgm_scan_with_carry(
        vol, img, penalty1, penalty2, shift, init_carry=init,
        seed_first=seed, adaptive_p2=adaptive_p2)
    if dy < 0:
        out = out.flip(dims)
        if dx != 0:
            final, final_image = final.flip(0), final_image.flip(0)
    return out, (final, final_image)


def semiglobal_aggregate(cost_volume: torch.Tensor, left_image: torch.Tensor,
                         *, penalty1: float = 0.1,
                         penalty2: float = 0.2,
                         adaptive_p2: bool = True) -> torch.Tensor:
    """Aggregate a float32 or bf16 [H, W, D] cost volume along the 8 SGM
    path directions (reference ``src/semiglobal.cpp:167-197``), plain
    PyTorch, with the adaptive P2 or (``adaptive_p2=False``) the
    constant max(P1, P2).

    The traversals are summed in float32 in the order of ``TRAVERSALS``;
    a bf16 volume is widened first and the sum rounded once to bf16 at
    the end, where the XLA scan casts
    (``stereomatch_tpu/ops/aggregation.py:211,226``).
    """
    if cost_volume.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"SGM aggregates float32 or bfloat16 cost volumes, "
                        f"got {cost_volume.dtype}")
    cost = cost_volume.to(torch.float32)
    image = left_image.to(torch.float32)
    out = None
    for step in TRAVERSALS:
        contribution = sweep(cost, image, penalty1, penalty2, step,
                             adaptive_p2)
        out = contribution if out is None else out + contribution
    return out.to(cost_volume.dtype)
