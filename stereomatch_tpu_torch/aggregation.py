"""Aggregation API: ``Semiglobal``, counterpart of
``stereomatch_tpu/aggregation.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .ops import sgm_cuda
from .ops.aggregation import semiglobal_aggregate
from .utils import validation
from .utils.backend import resolve_backend


class Semiglobal:
    """Semiglobal-matching aggregation (Hirschmuller 2005) over 8 path
    directions with an image-gradient-adaptive second penalty
    (reference: stereomatch/aggregation.py:12-57).

    ``sga_volume=`` is accepted for source compatibility and ignored.
    The cost volume must be float32: the adaptive P2 is a float quantity,
    and ``cli_common.create_pipeline`` refuses int32 volumes with
    aggregation, as the JAX package does.
    """

    def __init__(self, penalty1: float = 0.1, penalty2: float = 0.2,
                 backend: str = "auto"):
        """
        Args:
            penalty1: cost penalty for changing disparity by one level.
            penalty2: base penalty for larger disparity jumps, scaled by the
              inverse image gradient (P2_adj = max(P1, P2 / |dI|)).
            backend: "auto" (the CUDA kernels for CUDA tensors, the plain
              version for CPU tensors), "cuda" (the kernels; raises on
              CPU tensors) or "torch" (the plain version on the tensors'
              own device).  Both give the same volume bit for bit.
        """
        self.penalty1 = penalty1
        self.penalty2 = penalty2
        self.backend = backend

    def __call__(self, cost_volume: torch.Tensor, left_image: torch.Tensor,
                 sga_volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        validation.check_cost_volume(cost_volume)
        validation.check_rank("left_image", left_image, 2)
        validation.check_same_device("cost_volume", cost_volume,
                                     "left_image", left_image)
        if tuple(cost_volume.shape[:2]) != tuple(left_image.shape):
            raise validation.ShapeError(
                f"cost_volume spatial dims {tuple(cost_volume.shape[:2])} do "
                f"not match left_image {tuple(left_image.shape)}")
        if resolve_backend(self.backend, cost_volume) == "cuda":
            return sgm_cuda.semiglobal_aggregate_cuda(
                cost_volume, left_image, penalty1=float(self.penalty1),
                penalty2=float(self.penalty2))
        return semiglobal_aggregate(cost_volume, left_image,
                                    penalty1=float(self.penalty1),
                                    penalty2=float(self.penalty2))
