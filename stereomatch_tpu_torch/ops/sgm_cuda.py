"""Launchers of the SGM path-traversal CUDA kernels (``csrc/sgm.cu``).

Replace, in ``stereomatch_tpu/ops/sgm_pallas.py``, ``_sweep_kernel``
(vertical and diagonal families: ``sgm_rows_kernel``),
``_hsweep_kernel_natural`` (horizontal family:
``sgm_horizontal_kernel``) and ``_chunk_kernel`` with its W-on-grid form
``_chunk_kernel_wgrid`` (a row traversal over a chunk of rows with carry
in and carry out: ``sgm_chunk_kernel``).  The plain PyTorch versions, and
oracles, are ``ops/aggregation.py::semiglobal_aggregate`` and
``::sweep_chunk_with_carry``; on the same inputs each kernel equals its
plain version bit for bit: the recurrence is only IEEE-rounded
sub/add/div and exact min/max, and the traversals accumulate in the
plain version's order.

:func:`semiglobal_aggregate_cuda` has two forms of the whole aggregation.
The serial form launches the traversals of ``TRAVERSALS`` one after
another, each adding its path costs L into ``out`` in place.  The
side-by-side form runs them in two launches: ``sgm_side_by_side_kernel``
walks the first seven traversals at once, traversal 0 writing its L
into ``out`` and each of the others into a float32 partial volume of
its own; ``sgm_fold_kernel`` then walks the last traversal, brings the
six partial rows of each pixel beside its cost and ``out`` rows, and
forms ``out + P1 + ... + P6 + L`` in that order.  No traversal reads
another's L, so only the order of the additions ties them together, and
the fold keeps that order and each rounding: both forms give the same
bits, NaN and +-inf included.  Both move the same bytes (23 volume
passes a frame); the side-by-side form puts the seven traversals' paths
on the card at once where one traversal's paths (one warp each) leave
most of it idle, and pays six volumes of scratch for it.
``_takes_side_by_side``, a function of the shape alone, picks the
side-by-side form wherever its scratch stays within
``SIDE_BY_SIDE_SCRATCH_BYTES``.

:func:`semiglobal_wta_cuda` is the winner-takes-all of that aggregation
for a caller that reads no volume: the same two launches, the fold in
its winner-takes-all form (``sgm_fold_wta_kernel``), which takes each
pixel's argmin as it forms the pixel's sum and writes the int32 index in
place of the row.  It equals ``winner_takes_all`` of the aggregated
volume bit for bit (``torch.argmin``'s order: the first NaN, else the
first least value) and saves the fold's write of the volume, the
argmin's read of it and its int64-to-int32 cast: 22 volume passes a
frame and no argmin pass.  It serves the shapes where
:func:`takes_wta` holds.  The row-sharded, disparity-block and
process-mesh paths call :func:`traverse_cuda` and
:func:`sweep_chunk_with_carry_cuda` themselves and keep the serial
chain: their carries cross tiles.

All three kernels walk their paths the same way: operands come through a
ring of asynchronous copies eight steps deep, one path per one-warp
block; the chunk kernel adds the carry hand-off at a path's first and
last step.

A bf16 cost volume goes through the same kernels' bf16 instantiations
(in ``csrc/sgm.cu``): they read bf16 costs, keep the recurrence, the
carries and the partial sum ``out`` in float32, and the launch of the
last traversal stores ``out + L`` rounded once to bf16 into a separate
``result``, as the plain version (and XLA) round the float32 sum once.

Every launcher takes ``adaptive_p2`` (default True, the adaptive P2):
False gives every launch the constant P2' = max(P1, P2), a runtime
argument of the same kernels, computed off the step chain as the
adaptive one is.

``_build.LAUNCHES`` counts the launches of each entry point
(``stm_sgm_{rows,horizontal,chunk,side_by_side,fold,fold_wta}_{f32,bf16}``),
so a run can show that it went through them, and in which form.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aggregation import TRAVERSALS
from .disparity import winner_takes_all

VOLUME_DTYPES = (torch.float32, torch.bfloat16)

MAX_DISPARITY = 512         # 32 lanes x 16 registers per lane

# The most scratch the side-by-side form of semiglobal_aggregate_cuda may
# take: its six float32 partial volumes, 24 bytes a cell of the volume.
# 4 GiB, a twentieth of an H100's memory: HD 1024x1280 at D = 128 (3.75
# GiB) fits, at D = 256 (7.5 GiB) it does not (_takes_side_by_side).
SIDE_BY_SIDE_SCRATCH_BYTES = 4 << 30


def fits(shape) -> bool:
    """Whether the kernels serve an [H, W, D] cost volume (or a chunk of
    one): D within the ``MAX_DISPARITY`` registers of a warp.  The
    launchers raise ``ValueError`` exactly where this is false, and
    ``backend="auto"`` sends such volumes to the plain version."""
    return shape[-1] <= MAX_DISPARITY


def _check_out(out: torch.Tensor, like: torch.Tensor, name: str,
               dtype: torch.dtype = torch.float32) -> None:
    if out.shape != like.shape or out.dtype != dtype \
            or out.device != like.device or not out.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                         f"shaped {tuple(like.shape)} on {like.device}")


def _check_result(result, out, cost, accumulate) -> None:
    """A result (the last traversal of a bf16 volume) is a bf16 tensor
    beside ``out``, which the launch adds onto and does not write."""
    if result is None:
        return
    if cost.dtype != torch.bfloat16 or not accumulate:
        raise ValueError("a result takes the accumulated sum of a bf16 "
                         "volume's traversals: accumulate=True on bf16 costs")
    _check_out(result, out, "result", torch.bfloat16)


def _check(cost: torch.Tensor, image: torch.Tensor) -> None:
    if not (cost.is_cuda and image.is_cuda):
        raise ValueError("the SGM kernels need CUDA tensors, got "
                         f"{cost.device} and {image.device}")
    if cost.device != image.device:
        raise ValueError(f"tensors on two devices: {cost.device}, "
                         f"{image.device}")
    if cost.dtype not in VOLUME_DTYPES or image.dtype != torch.float32:
        raise TypeError(f"SGM kernels take float32 or bfloat16 costs and a "
                        f"float32 image, got {cost.dtype} and {image.dtype}")
    if cost.ndim != 3 or tuple(cost.shape[:2]) != tuple(image.shape):
        raise ValueError(f"cost volume {tuple(cost.shape)} does not match "
                         f"image {tuple(image.shape)}")
    if not (cost.is_contiguous() and image.is_contiguous()):
        raise ValueError("SGM kernels take contiguous tensors")
    if cost.shape[2] > MAX_DISPARITY:
        raise ValueError(f"D={cost.shape[2]} exceeds the kernels' "
                         f"{MAX_DISPARITY}")


def traverse_cuda(cost: torch.Tensor, image: torch.Tensor,
                  out: torch.Tensor, step: tuple, penalty1: float,
                  penalty2: float, accumulate: bool,
                  result: torch.Tensor = None,
                  adaptive_p2: bool = True) -> None:
    """One traversal with pixel step ``step`` = (dy, dx): writes its path
    costs into ``out`` (float32; ``accumulate=False``) or adds them in
    place.  For a bf16 ``cost``, ``result`` (bf16) takes the accumulated
    sum rounded to bf16 instead of ``out``, which is then only read: the
    last traversal of a row family."""
    _check(cost, image)
    _check_out(out, cost, "out")
    _check_result(result, out, cost, accumulate)
    if cost.numel() == 0:
        return
    dy, dx = step
    bf16 = cost.dtype == torch.bfloat16
    if dy == 0 and result is not None:
        raise ValueError("the last traversal is a row traversal; a "
                         "horizontal one takes no result")
    lib = _build.library()
    family = "horizontal" if dy == 0 else "rows"
    name = f"stm_sgm_{family}_{'bf16' if bf16 else 'f32'}"
    fn = getattr(lib, name)
    args = [cost.data_ptr(), image.data_ptr(), out.data_ptr()]
    if bf16 and dy != 0:
        args.append(0 if result is None else result.data_ptr())
    height, width, max_disp = cost.shape
    with torch.cuda.device(cost.device):
        status = fn(*args, height, width, max_disp, dy, dx, float(penalty1),
                    float(penalty2), int(bool(adaptive_p2)), int(accumulate),
                    torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)


def _side_by_side_scratch_bytes(height: int, width: int,
                                max_disp: int) -> int:
    """Bytes of the partial volumes the side-by-side form allocates at
    [height, width, max_disp]: one float32 volume for each traversal
    between the first and the last."""
    return (len(TRAVERSALS) - 2) * height * width * max_disp * 4


def _takes_side_by_side(height: int, width: int, max_disp: int) -> bool:
    """Whether :func:`semiglobal_aggregate_cuda` takes the side-by-side
    form at [height, width, max_disp]: wherever its partial volumes fit
    in ``SIDE_BY_SIDE_SCRATCH_BYTES``.  Of the shapes timed in both forms
    on an H100 (PERF.md §6), the side-by-side form was faster at every
    one inside that bound (teddy, 0.79 against 1.04 ms; 1024x1280 at
    D = 128, 5.99 against 6.27) and slower at the one float32 shape
    beyond it (1024x1280 at D = 256, 12.20 against 11.77)."""
    return (_side_by_side_scratch_bytes(height, width, max_disp)
            <= SIDE_BY_SIDE_SCRATCH_BYTES)


def _aggregate_serial(cost: torch.Tensor, image: torch.Tensor,
                      penalty1: float, penalty2: float,
                      adaptive_p2: bool = True) -> torch.Tensor:
    """The serial form: the traversals of ``TRAVERSALS`` one launch each,
    in order, accumulated in place into a float32 volume; for a bf16 cost
    the last traversal rounds the sum into the bf16 result."""
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    result = None
    if cost.dtype == torch.bfloat16:
        result = torch.empty_like(cost)
    last = len(TRAVERSALS) - 1
    for i, step in enumerate(TRAVERSALS):
        traverse_cuda(cost, image, out, step, penalty1, penalty2,
                      accumulate=i > 0, result=result if i == last else None,
                      adaptive_p2=adaptive_p2)
    return out if result is None else result


def _aggregate_side_by_side(cost: torch.Tensor, image: torch.Tensor,
                            penalty1: float, penalty2: float,
                            adaptive_p2: bool = True,
                            wta: bool = False) -> torch.Tensor:
    """The side-by-side form: one launch walks the first seven traversals
    at once, the first into ``out`` and the others each into a float32
    partial volume of its own; a second walks the last and forms
    ``out + P1 + ... + P6 + L`` in that order (bf16: rounded once into
    the result).  Bit-equal to :func:`_aggregate_serial`.  With ``wta``
    the second stores each pixel's argmin of that sum, int32 [H, W], and
    writes no volume."""
    height, width, max_disp = cost.shape
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    if cost.numel() == 0:
        return winner_takes_all(out) if wta else out.to(cost.dtype)
    partials = torch.empty((len(TRAVERSALS) - 2, *cost.shape),
                           dtype=torch.float32, device=cost.device)
    bf16 = cost.dtype == torch.bfloat16
    sfx = "bf16" if bf16 else "f32"
    lib = _build.library()
    p1, p2, adaptive = float(penalty1), float(penalty2), int(bool(adaptive_p2))
    # (dy, dx) of each traversal the first launch walks, in order.
    steps = (ctypes.c_int * (2 * len(TRAVERSALS) - 2))(
        *(v for step in TRAVERSALS[:-1] for v in step))
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        name = f"stm_sgm_side_by_side_{sfx}"
        _build.check_launch(name, getattr(lib, name)(
            cost.data_ptr(), image.data_ptr(), out.data_ptr(),
            partials.data_ptr(), ctypes.addressof(steps), height, width,
            max_disp, p1, p2, adaptive, stream))
        dy, dx = TRAVERSALS[-1]
        name = f"stm_sgm_fold_{'wta_' if wta else ''}{sfx}"
        args = [cost.data_ptr(), image.data_ptr(), out.data_ptr(),
                partials.data_ptr()]
        result = out
        if wta:
            result = torch.empty((height, width), dtype=torch.int32,
                                 device=cost.device)
        elif bf16:
            result = torch.empty_like(cost)
        if result is not out:
            args.append(result.data_ptr())
        _build.check_launch(name, getattr(lib, name)(
            *args, height, width, max_disp, dy, dx, p1, p2, adaptive,
            stream))
    return result


def semiglobal_aggregate_cuda(cost_volume: torch.Tensor,
                              left_image: torch.Tensor, *,
                              penalty1: float = 0.1,
                              penalty2: float = 0.2,
                              adaptive_p2: bool = True) -> torch.Tensor:
    """8-direction SGM aggregation [H, W, D] on the card, in the cost's
    dtype (a bf16 cost's sum is formed in float32 and rounded once), in
    the form :func:`_takes_side_by_side` picks for the shape: both give
    the plain version's volume bit for bit, with the adaptive P2 or
    (``adaptive_p2=False``) the constant max(P1, P2)."""
    cost = cost_volume.contiguous()
    image = left_image.to(torch.float32).contiguous()
    _check(cost, image)
    if _takes_side_by_side(*cost.shape):
        return _aggregate_side_by_side(cost, image, penalty1, penalty2,
                                       adaptive_p2)
    return _aggregate_serial(cost, image, penalty1, penalty2, adaptive_p2)


def takes_wta(shape) -> bool:
    """Whether :func:`semiglobal_wta_cuda` serves an [H, W, D] cost
    volume: the kernels serve its D (:func:`fits`) and the aggregation
    takes the side-by-side form there (:func:`_takes_side_by_side`)."""
    return fits(shape) and _takes_side_by_side(*shape)


def semiglobal_wta_cuda(cost_volume: torch.Tensor,
                        left_image: torch.Tensor, *,
                        penalty1: float = 0.1, penalty2: float = 0.2,
                        adaptive_p2: bool = True) -> torch.Tensor:
    """Winner-takes-all over the 8-direction SGM aggregation on the card,
    int32 [H, W]: ``winner_takes_all(semiglobal_aggregate_cuda(...))``
    bit for bit, taken in the fold's last launch with no volume written
    (the module's docstring).  Raises ``ValueError`` where
    :func:`takes_wta` does not hold."""
    cost = cost_volume.contiguous()
    image = left_image.to(torch.float32).contiguous()
    _check(cost, image)
    if not takes_wta(cost.shape):
        raise ValueError(f"a {tuple(cost.shape)} volume does not take the "
                         f"side-by-side form, which the fused "
                         f"winner-takes-all needs")
    return _aggregate_side_by_side(cost, image, penalty1, penalty2,
                                   adaptive_p2, wta=True)


def sweep_chunk_with_carry_cuda(cost: torch.Tensor, image: torch.Tensor,
                                step: tuple, carry=None, carry_image=None, *,
                                penalty1: float, penalty2: float, seed: bool,
                                out: torch.Tensor = None,
                                accumulate: bool = False,
                                result: torch.Tensor = None,
                                adaptive_p2: bool = True):
    """One row traversal over a chunk of rows with carry hand-off, on the
    card: the counterpart of ``ops/aggregation.py::sweep_chunk_with_carry``
    (same arguments and results), plus ``out``/``accumulate``/``result``
    as :func:`traverse_cuda` takes them: the contributions are written
    into ``out`` (float32, allocated when None) or added to it in place,
    or, with ``result`` (a bf16 cost's last traversal), added to it and
    stored rounded into ``result``.  The carries are float32.

    Returns (out, or result when given, [Hc, W, D], (carry [W, D],
    intensities [W]) of the chunk's last row in scan order); the
    intensities are a view of that row of ``image``.
    """
    _check(cost, image)
    dy, dx = step
    if dy not in (1, -1) or dx not in (-1, 0, 1):
        raise ValueError(f"a chunk sweep takes a row traversal, got {step}")
    height, width, max_disp = cost.shape
    if not seed:
        if carry is None or carry_image is None:
            raise ValueError("a chunk that does not seed needs the carry and "
                             "intensities of the row before it")
        _check(carry[None], carry_image[None])
        if tuple(carry.shape) != (width, max_disp) \
                or carry.device != cost.device \
                or carry.dtype != torch.float32:
            raise ValueError(f"carry {carry.dtype} {tuple(carry.shape)} on "
                             f"{carry.device} is not the chunk's float32 "
                             f"[W, D] = {(width, max_disp)} on {cost.device}")
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True needs an out to add to")
        out = torch.empty(cost.shape, dtype=torch.float32,
                          device=cost.device)
    _check_out(out, cost, "out")
    _check_result(result, out, cost, accumulate)
    carry_out = torch.empty((width, max_disp), dtype=torch.float32,
                            device=cost.device)
    last = image[height - 1 if dy > 0 else 0]
    done = out if result is None else result
    if cost.numel() == 0:
        return done, (carry_out, last)
    bf16 = cost.dtype == torch.bfloat16
    name = f"stm_sgm_chunk_{'bf16' if bf16 else 'f32'}"
    args = [out.data_ptr()]
    if bf16:
        args.append(0 if result is None else result.data_ptr())
    carry_ptr = 0 if seed else carry.data_ptr()
    image_ptr = 0 if seed else carry_image.data_ptr()
    with torch.cuda.device(cost.device):
        status = getattr(_build.library(), name)(
            cost.data_ptr(), image.data_ptr(), carry_ptr, image_ptr, *args,
            carry_out.data_ptr(), height, width, max_disp, dy, dx,
            float(penalty1), float(penalty2), int(bool(adaptive_p2)),
            int(seed), int(accumulate),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, status)
    return done, (carry_out, last)
