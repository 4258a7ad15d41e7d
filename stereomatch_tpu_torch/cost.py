"""Cost-function API: ``SSD``, ``SSDTexture``, ``SAD``, ``NCC``,
``Census`` and ``Birchfield``, counterparts of
``stereomatch_tpu/cost.py``.

  * ``max_disparity`` is a mutable attribute (the reference's evaluation
    workflow mutates it per scene).
  * ``cost_volume=`` is accepted for source compatibility with the
    reference and ignored: the caching allocator reuses the buffers.
  * ``backend``: "auto" launches the CUDA kernel (``ops/ssd_cuda.py``)
    for CUDA tensors whose shape it serves (``ssd_cuda.fits``) and runs
    the plain PyTorch version otherwise, on the images' own device;
    "cuda" demands the kernel and raises on CPU tensors and on shapes it
    does not serve; "torch" runs the plain version on the images' own
    device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ops import cost as cost_ops
from .ops import ssd_cuda
from .texture import TextureImage
from .utils import validation
from .utils.backend import resolve_backend


def _diff_cost_dispatch(left, right, *, max_disparity, kernel_size,
                        cost_dtype, absolute, backend):
    if cost_dtype not in validation.COST_DTYPES:
        raise validation.DTypeError(
            f"cost_volume_dtype must be one of "
            f"{[str(d) for d in validation.COST_DTYPES]}, got {cost_dtype}")
    fits = ssd_cuda.fits(left.shape[0], kernel_size)
    if resolve_backend(backend, left, fits) == "cuda":
        return ssd_cuda.diff_cost_volume_cuda(
            left, right, max_disparity=max_disparity,
            kernel_size=kernel_size, cost_dtype=cost_dtype,
            absolute=absolute)
    fn = cost_ops.sad_cost_volume if absolute else cost_ops.ssd_cost_volume
    return fn(left, right, max_disparity=max_disparity,
              kernel_size=kernel_size, cost_dtype=cost_dtype)


class _DiffCost:
    absolute = False

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 cost_volume_dtype: torch.dtype = torch.float32,
                 backend: str = "auto"):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype
        self.backend = backend

    def __call__(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_stereo_pair(left_image, right_image)
        return _diff_cost_dispatch(left_image, right_image,
                                   max_disparity=self.max_disparity,
                                   kernel_size=self.kernel_size,
                                   cost_dtype=self.cost_volume_dtype,
                                   absolute=self.absolute,
                                   backend=self.backend)


class SSD(_DiffCost):
    """Sum-of-squared-differences cost (reference: stereomatch/cost.py:13-48).

    Attributes:
        max_disparity: number of disparity hypotheses (the D axis).
        kernel_size: window half-extent k; the window is [i-k, i+k).
        cost_volume_dtype: torch.float32, torch.bfloat16 (the float
            chain, each cost rounded once to bf16 as it is stored) or
            torch.int32 (the reference's integer chain, for integer
            images).
        backend: "auto" | "cuda" | "torch" (see the module docstring).
    """

    absolute = False


class SAD(_DiffCost):
    """Sum-of-absolute-differences cost: the SSD window and validity with
    an L1 summand (beyond the reference's cost surface).  Attributes as
    :class:`SSD`."""

    absolute = True


class Census:
    """Census-transform + Hamming-distance cost (Zabih-Woodfill), the
    counterpart of the JAX package's ``Census``.

    Plain PyTorch on every device: the JAX package computes it in XLA,
    with no Pallas kernel, so the port has no CUDA kernel for it.

    Attributes:
        max_disparity: number of disparity hypotheses.
        window_size: census window (odd; 5x5 -> one 24-bit code word,
            larger windows pack several int32 words).
        kernel_size: optional clipped box-sum window over the Hamming
            costs (1 = pixelwise, the usual choice before aggregation).
        cost_volume_dtype: torch.float32, torch.bfloat16 (integers up to
            256, every pixelwise census distance, are exact in bf16) or
            torch.int32.
    """

    def __init__(self, max_disparity: int, window_size: int = 5,
                 kernel_size: int = 1,
                 cost_volume_dtype: torch.dtype = torch.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("window_size", window_size)
        validation.check_positive("kernel_size", kernel_size)
        if cost_volume_dtype not in validation.COST_DTYPES:
            raise validation.DTypeError(
                f"cost_volume_dtype must be one of "
                f"{[str(d) for d in validation.COST_DTYPES]}, got "
                f"{cost_volume_dtype}")
        self.max_disparity = max_disparity
        self.window_size = window_size
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_stereo_pair(left_image, right_image)
        return cost_ops.census_hamming_cost_volume(
            left_image, right_image, max_disparity=self.max_disparity,
            window_size=self.window_size, kernel_size=self.kernel_size,
            cost_dtype=self.cost_volume_dtype)


class SSDTexture:
    """SSD over sampled textures (reference: stereomatch/cost.py:51-77).

    Takes :class:`~stereomatch_tpu_torch.texture.TextureImage` inputs;
    the pipeline wraps plain tensors.  The textures' nearest samples at
    the integer pixel centres are the stored images, so the volume is
    the float32 SSD of them, through the SSD kernel on the card under
    ``backend`` "auto" or "cuda" (as :class:`SSD`).
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 backend: str = "auto"):
        validation.check_positive("max_disparity", max_disparity)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.backend = backend

    def __call__(self, left_image: TextureImage, right_image: TextureImage,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        left, right = cost_ops.texture_grids(left_image, right_image)
        return _diff_cost_dispatch(left, right,
                                   max_disparity=self.max_disparity,
                                   kernel_size=self.kernel_size,
                                   cost_dtype=torch.float32, absolute=False,
                                   backend=self.backend)


class NCC:
    """Zero-mean normalised cross-correlation cost, ``1 - zncc``, the
    counterpart of the JAX package's ``NCC``: invariant to a gain and a
    bias between the cameras over each window; the SSD window and
    validity.

    Attributes:
        max_disparity: number of disparity hypotheses (the D axis).
        kernel_size: window half-extent k; the window is [i-k, i+k).
        cost_volume_dtype: torch.float32 or torch.bfloat16 (the
            statistics are float32, the cost rounded once); an integer
            dtype raises ``ValueError`` when the cost is computed.
    """

    def __init__(self, max_disparity: int, kernel_size: int = 7,
                 cost_volume_dtype: torch.dtype = torch.float32):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype

    def __call__(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_stereo_pair(left_image, right_image)
        return cost_ops.zncc_cost_volume(
            left_image, right_image, max_disparity=self.max_disparity,
            kernel_size=self.kernel_size, cost_dtype=self.cost_volume_dtype)


class Birchfield:
    """Birchfield-Tomasi sampling-insensitive cost (reference:
    stereomatch/cost.py:80-101), float32, over the scanline window
    [x-k, x+k); ``kernel_size`` defaults to 4, the reference's value."""

    def __init__(self, max_disparity: int, kernel_size: int = 4):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("kernel_size", kernel_size)
        self.max_disparity = max_disparity
        self.kernel_size = kernel_size

    def __call__(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_stereo_pair(left_image, right_image)
        return cost_ops.birchfield_cost_volume(
            left_image, right_image, max_disparity=self.max_disparity,
            kernel_size=self.kernel_size)
