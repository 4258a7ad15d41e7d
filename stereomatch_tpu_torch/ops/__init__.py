"""Functional ops: plain PyTorch versions (``cost``, ``aggregation``,
``cvf``, ``disparity``) and the launchers of the hand-written CUDA kernels
that replace the JAX package's Pallas kernels (``ssd_cuda``,
``sgm_cuda``, ``dp_cuda``, ``cvf_cuda``, built by ``_build``).  Importing
them builds nothing."""

from .aggregation import semiglobal_aggregate
from .cost import (census_hamming_cost_volume, census_transform,
                   sad_cost_volume, ssd_cost_volume)
from .cvf import guided_filter_aggregate
from .disparity import (dynamic_programming, dynamic_programming_with_paths,
                        winner_takes_all)

__all__ = ["census_hamming_cost_volume", "census_transform",
           "dynamic_programming", "dynamic_programming_with_paths",
           "guided_filter_aggregate", "sad_cost_volume",
           "semiglobal_aggregate", "ssd_cost_volume", "winner_takes_all"]
