"""Launchers of the census CUDA kernels (``csrc/census.cu``).

Replaces no TPU kernel: the JAX package computes the census in XLA.  The
plain PyTorch versions, and oracles, are ``ops/cost.py``'s
``census_transform`` (the codes) and ``census_hamming_from_codes`` (the
Hamming volume); on the same inputs the kernels equal them bit for bit
in every cost dtype.  The two halves stay two launches, as the plain
version's two steps, so that ``cost.Census`` can stamp between them.

The launchers take CUDA tensors only: they check device, dtype and
shape, allocate their outputs with ``torch.empty``, launch on the
current stream and raise if the launch failed.  :func:`fits` states what
the kernels serve: windows of 1 to 4 code words (up to 128 neighbours,
so 11x11) and the pixelwise volume (``kernel_size`` 1); the launchers
raise ``ValueError`` exactly where it is false, and ``backend="auto"``
sends the rest to the plain version.  ``_build.LAUNCHES`` counts the
launches of each entry point.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.validation import census_words
from . import _build

_HAMMING = {torch.float32: "stm_census_hamming_f32",
            torch.int32: "stm_census_hamming_i32",
            torch.bfloat16: "stm_census_hamming_bf16"}
_CODES = "stm_census_codes"

MAX_WORDS = 4               # csrc/census.cu kMaxWords


def fits(n_words: int, kernel_size: int) -> bool:
    """Whether the kernels serve a census of ``n_words`` int32 code words
    (``utils.validation.census_words``) under a box window of
    ``kernel_size``: 1 to 4 words, and no box sum (``kernel_size`` 1)."""
    return 1 <= n_words <= MAX_WORDS and kernel_size == 1


def _check_pair(name: str, left: torch.Tensor, right: torch.Tensor) -> None:
    if not (left.is_cuda and right.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors, got {left.device} and "
                         f"{right.device}")
    if left.device != right.device:
        raise ValueError(f"{name}: tensors on two devices, {left.device} "
                         f"and {right.device}")
    if left.shape != right.shape:
        raise ValueError(f"{name}: the two tensors differ in shape, "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")


def census_codes_cuda(left: torch.Tensor, right: torch.Tensor,
                      window_size: int = 5,
                      window_height: Optional[int] = None):
    """Both images' census codes in one launch: two int32 tensors of
    ``census_transform``'s layout, [H, W] for one word, else [H, W,
    n_words]."""
    _check_pair("census_codes_cuda", left, right)
    if left.ndim != 2:
        raise ValueError(f"images must be [H, W], got {tuple(left.shape)}")
    n_words = census_words(window_size, window_height)
    if not fits(n_words, 1):
        raise ValueError(f"the census kernels take 1 to {MAX_WORDS} code "
                         f"words, the window needs {n_words}")
    height, width = left.shape
    win_h = window_size if window_height is None else window_height
    codes = torch.empty((2, height, width, n_words), dtype=torch.int32,
                        device=left.device)
    if codes.numel():
        images = [x.to(torch.float32).contiguous() for x in (left, right)]
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = getattr(_build.library(), _CODES)(
                images[0].data_ptr(), images[1].data_ptr(),
                codes[0].data_ptr(), codes[1].data_ptr(), height, width,
                window_size, win_h, stream)
        _build.check_launch(_CODES, status)
    if n_words == 1:
        codes = codes[..., 0]
    return codes[0], codes[1]


def census_hamming_from_codes_cuda(cl: torch.Tensor, cr: torch.Tensor, *,
                                   max_disparity: int, kernel_size: int = 1,
                                   cost_dtype: torch.dtype = torch.float32,
                                   disparity_offset: int = 0) -> torch.Tensor:
    """The Hamming volume [H, W, D] of two images' codes
    (``ops.cost.census_hamming_from_codes``' arguments) in one launch:
    slice d holds disparity d + ``disparity_offset``, +inf (int32 max)
    where x < d + offset."""
    name = _HAMMING.get(cost_dtype)
    _check_pair("census_hamming_from_codes_cuda", cl, cr)
    if name is None:
        raise TypeError(f"cost_dtype must be float32, bfloat16 or int32, "
                        f"got {cost_dtype}")
    if cl.dtype != torch.int32 or cr.dtype != torch.int32:
        raise TypeError(f"census codes must be int32, got {cl.dtype} and "
                        f"{cr.dtype}")
    if cl.ndim not in (2, 3):
        raise ValueError(f"census codes must be [H, W] or [H, W, n_words], "
                         f"got {tuple(cl.shape)}")
    n_words = cl.shape[2] if cl.ndim == 3 else 1
    if not fits(n_words, kernel_size):
        raise ValueError(f"the census kernels take 1 to {MAX_WORDS} code "
                         f"words and kernel_size 1, got {n_words} words and "
                         f"kernel_size {kernel_size}")
    if max_disparity < 1:
        raise ValueError(f"max_disparity must be positive, got "
                         f"{max_disparity}")
    if disparity_offset < 0:
        raise ValueError(f"disparity_offset must be >= 0, got "
                         f"{disparity_offset}")
    height, width = cl.shape[:2]
    out = torch.empty((height, width, max_disparity), dtype=cost_dtype,
                      device=cl.device)
    if out.numel():
        left, right = cl.contiguous(), cr.contiguous()
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = getattr(_build.library(), name)(
                left.data_ptr(), right.data_ptr(), out.data_ptr(), height,
                width, max_disparity, n_words, int(disparity_offset), stream)
        _build.check_launch(name, status)
    return out
