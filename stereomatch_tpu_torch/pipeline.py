"""Stereo-matching pipeline composition: cost -> optional aggregation ->
reduce, counterpart of ``stereomatch_tpu/pipeline.py``.

PyTorch runs eagerly: each stage launches its kernels on the current
CUDA stream, and the stages share the caching allocator's buffers from
frame to frame.  ``estimate_refined``, ``last_confidence`` and
``compiled()`` (a CUDA graph of the whole pipeline) come with later
slices of the port (ROADMAP A.4, A.10).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

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


def _as_image_tensor(image: Image, device: Device) -> torch.Tensor:
    """A tensor on ``device``, numpy array or tensor alike.  ``"cuda"`` on
    a machine without a GPU raises, as ``Tensor.to`` does: there is no
    fallback to the CPU."""
    if isinstance(image, np.ndarray):
        image = tensor_from_numpy(image)
    return image.to(device)


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
        left_image = _as_image_tensor(left_image, device)
        right_image = _as_image_tensor(right_image, device)
        validation.check_stereo_pair(left_image, right_image)
        (self._cost_volume, self._aggregation_volume,
         self._disparity_image) = self._run(left_image, right_image)
        return self._disparity_image

    def estimate_fn(self) -> Callable:
        """The pipeline as a plain function ``(left, right) -> disparity``
        on tensors, with no capture of intermediates."""
        def fn(left_image, right_image):
            return self._run(left_image, right_image)[2]
        return fn
