"""Aggregation API: ``Semiglobal`` and ``CostFilter``, counterparts of
``stereomatch_tpu/aggregation.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .ops import cvf_cuda, sgm_cuda
from .ops.aggregation import semiglobal_aggregate
from .ops.cvf import check_filter_args, guided_filter_aggregate
from .utils import validation
from .utils.backend import resolve_backend


class Semiglobal:
    """Semiglobal-matching aggregation (Hirschmuller 2005) over 8 path
    directions with an image-gradient-adaptive second penalty
    (reference: stereomatch/aggregation.py:12-57).

    ``sga_volume=`` is accepted for source compatibility and ignored.
    The cost volume must be float32 or bfloat16 (the result has its
    dtype; a bf16 volume is aggregated in float32 and rounded once): the
    adaptive P2 is a float quantity, and ``cli_common.create_pipeline``
    refuses int32 volumes with aggregation, as the JAX package does.
    """

    def __init__(self, penalty1: float = 0.1, penalty2: float = 0.2,
                 backend: str = "auto"):
        """
        Args:
            penalty1: cost penalty for changing disparity by one level.
            penalty2: base penalty for larger disparity jumps, scaled by the
              inverse image gradient (P2_adj = max(P1, P2 / |dI|)).
            backend: "auto" (the CUDA kernels for CUDA tensors of a D
              they serve, ``sgm_cuda.fits``; the plain version for the
              rest, on the tensors' own device), "cuda" (the kernels;
              raises on CPU tensors and on a D past them) or "torch"
              (the plain version on the tensors' own device).  Both give
              the same volume bit for bit.
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
        fits = sgm_cuda.fits(cost_volume.shape)
        if resolve_backend(self.backend, cost_volume, fits) == "cuda":
            return sgm_cuda.semiglobal_aggregate_cuda(
                cost_volume, left_image, penalty1=float(self.penalty1),
                penalty2=float(self.penalty2))
        return semiglobal_aggregate(cost_volume, left_image,
                                    penalty1=float(self.penalty1),
                                    penalty2=float(self.penalty2))


class CostFilter:
    """Guided-filter cost-volume aggregation (Hosni et al., PAMI 2013),
    the counterpart of the JAX package's ``CostFilter``.

    Edge-aware local smoothing of every disparity slice with the left
    image as the guide (see ``ops/cvf.py``).  This slice ports the wedge
    path: ``wedge_offset`` declares that the volume's +inf cells are
    exactly ``x < d + wedge_offset``, which every registry cost family
    writes (``cli_common.create_pipeline`` passes 0).  A float32 or bf16
    volume gives a result of its dtype (bf16: float32 statistics, q
    rounded once).  ``wedge_offset=None``
    and ``subsample > 1`` raise ``NotImplementedError`` (ROADMAP A.9).

    ``penalty1``/``penalty2`` are accepted for registry compatibility with
    :class:`Semiglobal` and do not apply.
    """

    def __init__(self, radius: int = 8, eps: float = 1e-4,
                 subsample: int = 1, penalty1: float = None,
                 penalty2: float = None, backend: str = "auto",
                 wedge_offset=None):
        """
        Args:
            radius: box window half-size (support (2*radius+1)^2; the
              second filter stage doubles the effective reach).
            eps: edge-stop regulariser in image-intensity^2 units.
            subsample: 1 (the exact filter); > 1 is not ported yet.
            penalty1/penalty2: ignored (registry compatibility).
            backend: "auto" (the CUDA kernels for CUDA tensors at a
              radius they serve, ``cvf_cuda.fits``; the plain version
              for the rest, on the tensors' own device), "cuda" (the
              kernels; raises on CPU tensors and on a radius past them)
              or "torch" (the plain version on the tensors' own device).
            wedge_offset: the wedge of the volume's invalid cells.
        """
        del penalty1, penalty2
        check_filter_args(int(radius), float(eps), int(subsample),
                          wedge_offset=wedge_offset)
        self.radius = radius
        self.eps = eps
        self.subsample = subsample
        self.backend = backend
        self.wedge_offset = wedge_offset

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
        if not cost_volume.dtype.is_floating_point:
            raise validation.DTypeError(
                "cost-volume filtering computes windowed means, a float "
                f"quantity; got cost volume dtype {cost_volume.dtype}")
        wedge = None if self.wedge_offset is None else int(self.wedge_offset)
        kw = dict(radius=int(self.radius), eps=float(self.eps))
        fits = cvf_cuda.fits(int(self.radius))
        if resolve_backend(self.backend, cost_volume, fits) == "cuda":
            return cvf_cuda.guided_filter_aggregate_cuda(
                cost_volume, left_image, wedge_offset=wedge, **kw)
        return guided_filter_aggregate(cost_volume, left_image,
                                       subsample=int(self.subsample),
                                       wedge_offset=wedge, **kw)
