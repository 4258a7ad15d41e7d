"""Stereo-matching pipeline composition: cost -> optional aggregation ->
reduce, counterpart of ``stereomatch_tpu/pipeline.py``.

PyTorch runs eagerly: each stage launches its kernels on the current
CUDA stream, and the stages share the caching allocator's buffers from
frame to frame.  ``estimate_refined`` adds the post-processing stages of
``ops/refine.py`` in the JAX package's order, and ``last_confidence``
the PKRN confidence of the last run.  An ``SSDTexture`` cost gets its
plain tensors wrapped as textures, as in the JAX package (the
reference's ``_TexCostFunctionWrapper``, pipeline.py:22-33).
``compiled()`` (a CUDA graph of the whole pipeline) comes with a later
slice of the port (ROADMAP A.4).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .cost import SSDTexture
from .texture import TextureImage
from .utils import profiling, validation

Image = Union[torch.Tensor, np.ndarray]
Device = Union[str, torch.device, None]


def tensor_from_numpy(array: np.ndarray) -> torch.Tensor:
    """A tensor holding a copy of ``array`` (it may be read-only, a
    tensor never is).  A bfloat16 array (``ml_dtypes.bfloat16``, as JAX
    gives it), which ``torch.from_numpy`` refuses, crosses as its 16-bit
    patterns and is viewed as ``torch.bfloat16``: the same values."""
    array = np.array(array, order="C")
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def host_array(array) -> np.ndarray:
    """A numpy array of a tensor (copied to the host) or of anything
    ``np.asarray`` takes."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def as_tensor(image: Image, device: Device = None) -> torch.Tensor:
    """A tensor on ``device`` (None: where it is, the CPU for a numpy
    array), numpy array or tensor alike.  ``"cuda"`` on a machine
    without a GPU raises, as ``Tensor.to`` does: there is no fallback to
    the CPU."""
    if isinstance(image, np.ndarray):
        image = tensor_from_numpy(image)
    return image if device is None else image.to(device)


def disparity_bins(disparity: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Disparities rounded (half to even) and clipped into [0, max_disp),
    as int64 indices of the D axis."""
    if disparity.is_floating_point():
        disparity = disparity.round()
    return disparity.clamp(0, max_disp - 1).to(torch.int64)


class _TexCostFunctionWrapper:
    """Wraps an SSDTexture cost so the pipeline can feed it tensors."""

    def __init__(self, cost_function: SSDTexture):
        self.cost_function = cost_function

    @property
    def max_disparity(self) -> int:
        return self.cost_function.max_disparity

    @max_disparity.setter
    def max_disparity(self, value: int) -> None:
        self.cost_function.max_disparity = value

    def __call__(self, left_image, right_image, cost_volume=None):
        return self.cost_function(TextureImage.from_array(left_image),
                                  TextureImage.from_array(right_image),
                                  cost_volume=cost_volume)


class Pipeline:
    """Composable stereo pipeline: cost -> optional aggregation -> reduce
    (reference: stereomatch/pipeline.py:36-94)."""

    def __init__(self, cost: Callable, disparity_reduce: Callable,
                 aggregation: Optional[Callable] = None,
                 device: Device = "cuda"):
        """
        Args:
            cost: callable (left, right) -> [H, W, D] cost volume.
            disparity_reduce: callable (volume) -> [H, W] int32 disparity.
            aggregation: optional callable (volume, left_image) -> volume.
            device: where ``estimate`` runs when its own ``device=`` is
              not given: the card by default; ``"cpu"`` runs the plain
              PyTorch versions on the CPU.
        """
        if isinstance(cost, SSDTexture):
            cost = _TexCostFunctionWrapper(cost)
        self.cost = cost
        self.disparity_reduce = disparity_reduce
        self.aggregation = aggregation
        self.device = device

        # Diagnostic captures of the last run's intermediates, matching
        # the reference's reusable-buffer attributes (pipeline.py:65-67).
        self._cost_volume = None
        self._aggregation_volume = None
        self._disparity_image = None

    def _run(self, left_image: torch.Tensor, right_image: torch.Tensor):
        # Stage spans show up in torch.profiler captures.
        with profiling.annotate("stm/cost"):
            cost_volume = self.cost(left_image, right_image)
        if self.aggregation is not None:
            with profiling.annotate("stm/aggregation"):
                aggregation_volume = self.aggregation(cost_volume, left_image)
        else:
            aggregation_volume = cost_volume
        with profiling.annotate("stm/disparity_reduce"):
            disparity = self.disparity_reduce(aggregation_volume)
        return cost_volume, aggregation_volume, disparity

    def estimate(self, left_image: Image, right_image: Image,
                 device: Device = None) -> torch.Tensor:
        """Run the pipeline; returns an int32 [H, W] disparity tensor on
        ``device``, else on ``self.device`` (the card unless the pipeline
        was built for the CPU).  Images, numpy or tensors, go there."""
        device = device if device is not None else self.device
        left_image = as_tensor(left_image, device)
        right_image = as_tensor(right_image, device)
        validation.check_stereo_pair(left_image, right_image)
        (self._cost_volume, self._aggregation_volume,
         self._disparity_image) = self._run(left_image, right_image)
        return self._disparity_image

    def estimate_refined(self, left_image: Image, right_image: Image, *,
                         subpixel: bool = True, median: bool = True,
                         lr_check: bool = False, lr_mode: str = "mirror",
                         max_diff: int = 1, weighted_median: bool = False,
                         wmf_sigma: float = 10.0, wmf_window: int = 5,
                         fgs_lambda: Optional[float] = None,
                         fgs_sigma: float = 8.0,
                         min_confidence: Optional[float] = None,
                         device: Device = None) -> torch.Tensor:
        """Estimate and post-process, as the JAX package's
        ``Pipeline.estimate_refined`` does, stage by stage in its order:

        * ``lr_check``: the left-right check (``max_diff``) with the
          background occlusion fill; the right disparity comes from the
          pipeline run again on the mirrored pair (``lr_mode="mirror"``)
          or from the aggregated volume re-indexed into the right view
          (``"volume"``);
        * ``weighted_median``: the guide-weighted median, the left image
          the guide (``wmf_sigma`` in its intensity units,
          ``wmf_window``);
        * ``median``: the 3x3 median;
        * ``subpixel``: parabolic sub-pixel interpolation on the
          aggregated volume (float32 from here on);
        * ``fgs_lambda``: the fast global smoother (``fgs_sigma``),
          confidence-weighted by the LR mask when ``lr_check`` is on;
        * ``min_confidence``: pixels whose PKRN confidence is below it
          become 0, the Middlebury unknown.

        Runs on ``device``, else ``self.device``; see ``ops/refine.py``.
        """
        from .ops import refine

        if lr_mode not in ("mirror", "volume"):
            raise ValueError(f"unknown lr_mode: {lr_mode!r}")
        device = device if device is not None else self.device
        left_image = as_tensor(left_image, device)
        right_image = as_tensor(right_image, device)
        disp_r = None
        if lr_check and lr_mode == "mirror":
            validation.check_stereo_pair(left_image, right_image)
            disp_r = refine.right_disparity(
                lambda l, r: self._run(l, r)[2], left_image, right_image)
        disp = self.estimate(left_image, right_image, device=device)
        max_disp = self._aggregation_volume.shape[2]
        if lr_check:
            if disp_r is None:
                disp_r = refine.right_disparity_from_volume(
                    self._aggregation_volume)
            mask = refine.left_right_consistency(disp, disp_r, max_diff,
                                                 max_disparity=max_disp)
            disp = refine.fill_inconsistent(disp, mask)
        if weighted_median:
            disp = refine.weighted_median_filter(
                disp, left_image, window=wmf_window, sigma=wmf_sigma,
                n_bins=max_disp)
        if median:
            disp = refine.median_filter_3x3(disp)
        if subpixel:
            disp = refine.subpixel_refine(self._aggregation_volume,
                                          disparity_bins(disp, max_disp))
        if fgs_lambda is not None:
            conf = mask.to(torch.float32) if lr_check else None
            disp = refine.fgs_smooth(disp.to(torch.float32), left_image,
                                     lam=fgs_lambda, sigma_color=fgs_sigma,
                                     confidence=conf)
        if min_confidence is not None:
            keep = self.last_confidence() >= min_confidence
            disp = torch.where(keep, disp, torch.zeros((), dtype=disp.dtype,
                                                       device=disp.device))
        return disp

    def last_confidence(self) -> torch.Tensor:
        """PKRN matching confidence [H, W] in [0, 1] of the last
        ``estimate``, from its aggregated volume, on its device."""
        from .ops.refine import confidence_pkrn
        if self._aggregation_volume is None:
            raise RuntimeError("run estimate() before last_confidence()")
        return confidence_pkrn(self._aggregation_volume)

    def estimate_fn(self) -> Callable:
        """The pipeline as a plain function ``(left, right) -> disparity``
        on tensors, with no capture of intermediates."""
        def fn(left_image, right_image):
            return self._run(left_image, right_image)[2]
        return fn
