"""Argument validation for the ops API.

Counterpart of ``stereomatch_tpu/utils/validation.py`` with torch dtypes.
Checks run eagerly in Python before any kernel launch, so a bad call
fails with a readable message instead of a wrong read inside a kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# Input images: the reference's STM_DISPATCH_COSTFUNC_TYPES set
# (uint8 / int16 / float32) plus bfloat16, as the JAX package takes them;
# every cost widens its images to its compute dtype first.
IMAGE_DTYPES = (torch.uint8, torch.int16, torch.float32, torch.bfloat16)
# Cost volumes by name (reference: int32 / float32; bfloat16 stores a
# float volume in half the bytes, its arithmetic staying float32).
VOLUME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}
COST_DTYPES = tuple(VOLUME_DTYPES.values())


def compute_dtype(cost_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the window sums for a cost dtype."""
    return torch.float32 if cost_dtype.is_floating_point else torch.int32


def inf_value(dtype: torch.dtype):
    """The cost of an invalid cell: +inf for float dtypes, the max value
    for integer dtypes."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


class ShapeError(ValueError):
    """Raised when an op receives tensors of the wrong rank/shape."""


class DTypeError(TypeError):
    """Raised when an op receives tensors of an unsupported dtype."""


def dtype_name(dtype) -> str:
    """The name ("float32", "bfloat16", ...) of a torch, numpy or JAX
    dtype, scalar type or name, read without importing JAX."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return getattr(dtype, "__name__", None) or np.dtype(dtype).name


def volume_dtype(dtype, aggregation=None) -> torch.dtype:
    """The cost volume's torch dtype for a torch, numpy or JAX dtype, or
    its name: float32, bfloat16 or int32, else ``ValueError``.  An int32
    volume refuses an ``aggregation`` (a name, or None for none)."""
    try:
        name = dtype_name(dtype)
    except TypeError:
        name = None
    if name not in VOLUME_DTYPES:
        raise ValueError(f"unknown volume dtype {dtype!r}; expected one of "
                         f"{sorted(VOLUME_DTYPES)}")
    if name == "int32" and aggregation is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2, semiglobal.cpp:137-138, and "
                         "cvf's windowed means are float quantities)")
    return VOLUME_DTYPES[name]


def check_rank(name: str, arr, rank: int) -> None:
    if arr.ndim != rank:
        raise ShapeError(
            f"{name} must have rank {rank}, got shape {tuple(arr.shape)}")


def check_same_shape(name_a: str, a, name_b: str, b) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise ShapeError(
            f"{name_a} and {name_b} must have the same shape, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}")


def check_dtype(name: str, arr, allowed: Sequence[torch.dtype]) -> None:
    if arr.dtype not in allowed:
        raise DTypeError(
            f"{name} has unsupported dtype {arr.dtype}; expected one of "
            f"{[str(d) for d in allowed]}")


def check_same_device(name_a: str, a, name_b: str, b) -> None:
    if a.device != b.device:
        raise ValueError(f"{name_a} is on {a.device} but {name_b} is on "
                         f"{b.device}; move both to one device")


def check_stereo_pair(left, right) -> None:
    """Validate a rectified stereo pair of [H, W] images."""
    check_rank("left_image", left, 2)
    check_rank("right_image", right, 2)
    check_same_shape("left_image", left, "right_image", right)
    check_dtype("left_image", left, IMAGE_DTYPES)
    check_dtype("right_image", right, IMAGE_DTYPES)
    check_same_device("left_image", left, "right_image", right)


def check_cost_volume(volume) -> None:
    """Validate a [H, W, D] cost volume."""
    check_rank("cost_volume", volume, 3)
    check_dtype("cost_volume", volume, COST_DTYPES)


def check_positive(name: str, value: int) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")


def census_words(window_size: int, window_height=None) -> int:
    """The int32 code words of a census window ``window_size`` columns by
    ``window_height`` rows (None: square): one bit for each neighbour,
    32 a word, 0 for a 1x1 window.  Raises ``ValueError`` unless both
    sides are odd and positive."""
    height = window_size if window_height is None else window_height
    for name, side in (("window_size", window_size),
                       ("window_height", height)):
        if side % 2 == 0 or side < 1:
            raise ValueError(f"{name} must be odd and positive (got {side})")
    return -(-(window_size * height - 1) // 32)
