"""Functional ops: plain PyTorch versions (``cost``, ``aggregation``,
``disparity``) and the launchers of the hand-written CUDA kernels that
replace the JAX package's Pallas kernels (``ssd_cuda``, ``sgm_cuda``,
built by ``_build``).  Importing them builds nothing."""

from .aggregation import semiglobal_aggregate
from .cost import sad_cost_volume, ssd_cost_volume
from .disparity import winner_takes_all

__all__ = ["sad_cost_volume", "semiglobal_aggregate", "ssd_cost_volume",
           "winner_takes_all"]
