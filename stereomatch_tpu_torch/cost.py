"""Cost-function API: ``SSD``, ``SSDTexture``, ``SAD``, ``NCC``,
``Census`` and ``Birchfield``, counterparts of
``stereomatch_tpu/cost.py``, and :func:`make_cost`, the one place a
registry name (``COST_METHODS``) becomes one of them.

  * ``max_disparity`` is a mutable attribute (the reference's evaluation
    workflow mutates it per scene).
  * ``cost_volume=`` is accepted for source compatibility with the
    reference and ignored: the caching allocator reuses the buffers.
  * ``row_halo`` is (before, after): the image rows above and below a
    row that its window reads, which a row split's halos must hold.
  * ``backend`` (routed by ``ops.cost.diff_cost_dispatch`` for SSD and
    SAD, ``ops.cost.census_backend`` for Census): "auto" launches the
    CUDA kernels (``ops/ssd_cuda.py``, ``ops/census_cuda.py``) for CUDA
    tensors whose shape they serve (``ssd_cuda.fits``,
    ``census_cuda.fits``) and runs the plain PyTorch version otherwise,
    on the images' own device;
    "cuda" demands the kernel and raises on CPU tensors and on shapes it
    does not serve; "torch" runs the plain version on the images' own
    device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ops import cost as cost_ops
from .texture import TextureImage
from .utils import profiling, validation


class _SSDWindow:
    """A cost over the SSD window: rows [y-k, y+k) of each row y."""

    @property
    def row_halo(self) -> Tuple[int, int]:
        return self.kernel_size, self.kernel_size - 1


class _DiffCost(_SSDWindow):
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
        return cost_ops.diff_cost_dispatch(
            left_image, right_image, max_disparity=self.max_disparity,
            kernel_size=self.kernel_size, cost_dtype=self.cost_volume_dtype,
            absolute=self.absolute, backend=self.backend)


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

    Two steps, each a launch of the census kernels (``ops/census_cuda.py``,
    ``csrc/census.cu``) on the card under ``backend`` "auto" or "cuda":
    both images' codes, then their Hamming volume.  The kernels are the
    port's own (the JAX package computes the census in XLA, with no
    Pallas kernel) and equal the plain PyTorch version
    (``ops.cost.census_transform``, ``census_hamming_from_codes``) bit for
    bit; "auto" runs the plain version on CPU tensors and where the
    kernels do not serve the window or the box sum (``census_cuda.fits``:
    more than 4 code words, ``kernel_size`` > 1).  Inside the cost stage
    the steps enter the spans ``stm/cost/census_codes`` and
    ``stm/cost/census_hamming``, and the card is stamped between them
    where the stage stamps (``utils/profiling.py``).

    Attributes:
        max_disparity: number of disparity hypotheses.
        window_size: census window width (odd; 5x5 -> one 24-bit code
            word, larger windows pack several int32 words).
        window_height: census window height (odd), or None for the
            square ``window_size`` window; a rectangle (KITTI's 9x7) is
            the port's own, the JAX package's census is square.
        kernel_size: optional clipped box-sum window over the Hamming
            costs (1 = pixelwise, the usual choice before aggregation).
        cost_volume_dtype: torch.float32, torch.bfloat16 (integers up to
            256, every pixelwise census distance, are exact in bf16) or
            torch.int32.
        backend: "auto" | "cuda" | "torch" (``ops.cost.census_backend``).
    """

    def __init__(self, max_disparity: int, window_size: int = 5,
                 kernel_size: int = 1,
                 cost_volume_dtype: torch.dtype = torch.float32,
                 window_height: Optional[int] = None,
                 backend: str = "auto"):
        validation.check_positive("max_disparity", max_disparity)
        validation.check_positive("window_size", window_size)
        if window_height is not None:
            validation.check_positive("window_height", window_height)
        validation.check_positive("kernel_size", kernel_size)
        if cost_volume_dtype not in validation.COST_DTYPES:
            raise validation.DTypeError(
                f"cost_volume_dtype must be one of "
                f"{[str(d) for d in validation.COST_DTYPES]}, got "
                f"{cost_volume_dtype}")
        self.max_disparity = max_disparity
        self.window_size = window_size
        self.window_height = window_height
        self.kernel_size = kernel_size
        self.cost_volume_dtype = cost_volume_dtype
        self.backend = backend

    @property
    def row_halo(self) -> Tuple[int, int]:
        """Half the code window's height a side (a Hamming box sum,
        ``kernel_size`` > 1, reads more rows, with its own clipping at
        the image's edges)."""
        height = (self.window_size if self.window_height is None
                  else self.window_height)
        return height // 2, height // 2

    def __call__(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 cost_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_stereo_pair(left_image, right_image)
        window = (self.window_size, self.window_height)
        route = cost_ops.census_backend(self.backend, left_image, *window,
                                        self.kernel_size)
        with profiling.annotate("stm/cost/census_codes"):
            codes = cost_ops.census_codes(left_image, right_image, *window,
                                          route=route)
        profiling.point("census_codes", left_image.device)
        with profiling.annotate("stm/cost/census_hamming"):
            return cost_ops.census_hamming(
                *codes, route=route, max_disparity=self.max_disparity,
                kernel_size=self.kernel_size,
                cost_dtype=self.cost_volume_dtype)


class SSDTexture(_SSDWindow):
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
        return cost_ops.diff_cost_dispatch(
            left, right, max_disparity=self.max_disparity,
            kernel_size=self.kernel_size, cost_dtype=torch.float32,
            absolute=False, backend=self.backend)


class NCC(_SSDWindow):
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

    row_halo = (0, 0)                   # never leaves a row

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


COST_METHODS = {"ssd": SSD, "ssd-texture": SSDTexture,
                "birchfield": Birchfield, "census": Census, "sad": SAD,
                "ncc": NCC}


def make_cost(name: str, max_disparity: int, *,
              kernel_size: Optional[int] = None,
              cost_dtype: torch.dtype = torch.float32,
              census_window: int = 5,
              census_height: Optional[int] = None,
              backend: str = "auto"):
    """The cost stage that the registry name ``name`` (a key of
    ``COST_METHODS``) means.

    ``kernel_size`` None keeps the class's own default (7; Birchfield 4,
    Census 1).  ``cost_dtype`` is the volume's dtype: ``ssd-texture`` and
    ``birchfield`` ignore it and compute float32, ``ncc`` refuses an
    integer one.  ``census_window``/``census_height`` are the census
    code window's width and height (None: square), and ``backend``
    reaches the classes that have kernels (SSD, SAD, Census, SSD over
    textures).  An unknown name raises ``ValueError``.
    """
    if name not in COST_METHODS:
        raise ValueError(f"unknown cost method {name!r}; expected one of "
                         f"{sorted(COST_METHODS)}")
    cls = COST_METHODS[name]
    if cls is NCC and not cost_dtype.is_floating_point:
        raise ValueError("ncc cost is a normalized float quantity; "
                         f"volume dtype {validation.dtype_name(cost_dtype)} "
                         "is not supported")
    kw = {} if kernel_size is None else {"kernel_size": kernel_size}
    if cls in (SSD, SAD, NCC, Census):
        kw["cost_volume_dtype"] = cost_dtype
    if cls in (SSD, SAD, SSDTexture, Census):
        kw["backend"] = backend
    if cls is Census:
        kw.update(window_size=census_window, window_height=census_height)
    return cls(max_disparity, **kw)


def tensor_cost(name: str, max_disparity: int, **kw):
    """:func:`make_cost` for callers that hold plain [H, W] tensors (the
    mesh builders, the tuner): ``ssd-texture`` is float32 :class:`SSD`,
    the volume :class:`SSDTexture` computes, since the textures' samples
    at the pixel centres are the images."""
    if name == "ssd-texture":
        name, kw = "ssd", {**kw, "cost_dtype": torch.float32}
    return make_cost(name, max_disparity, **kw)
