"""Disparity-reduce API: ``WinnerTakesAll`` and ``DynamicProgramming``,
counterparts of ``stereomatch_tpu/disparity_reduce.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .ops import dp_cuda
from .ops.disparity import dynamic_programming, winner_takes_all
from .utils import validation
from .utils.backend import resolve_backend


class WinnerTakesAll:
    """Argmin-over-disparity reducer (reference:
    stereomatch/disparity_reduce.py:16-46).

    Ties break toward the lower disparity (winners_take_all.cu:29-37);
    no power-of-two constraint on D.  ``disparity_img=`` is accepted for
    source compatibility and ignored.
    """

    def __call__(self, cost_volume: torch.Tensor,
                 disparity_img: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        validation.check_cost_volume(cost_volume)
        return winner_takes_all(cost_volume)


class DynamicProgramming:
    """Scanline dynamic-programming reducer (reference:
    stereomatch/disparity_reduce.py:49-90; see ``ops/disparity.py``).

    ``backend``: "auto" (the CUDA kernels of ``ops/dp_cuda.py`` for CUDA
    tensors of a D they serve, ``dp_cuda.fits``; the plain version for
    the rest, on the volume's own device), "cuda" (the kernels; raises on
    CPU tensors and on a D past them) or "torch" (the plain version on
    the volume's own device).  Both give the same disparities bit for
    bit.
    ``disparity_img=`` is accepted for source compatibility and ignored.
    """

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def __call__(self, cost_volume: torch.Tensor,
                 disparity_img: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        validation.check_cost_volume(cost_volume)
        fits = dp_cuda.fits(cost_volume.shape)
        if resolve_backend(self.backend, cost_volume, fits) == "cuda":
            return dp_cuda.dynamic_programming_cuda(cost_volume)
        return dynamic_programming(cost_volume)
