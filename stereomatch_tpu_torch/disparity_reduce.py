"""Disparity-reduce API: ``WinnerTakesAll``, counterpart of
``stereomatch_tpu/disparity_reduce.py``."""

from __future__ import annotations

from typing import Optional

import torch

from .ops.disparity import winner_takes_all
from .utils import validation


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
