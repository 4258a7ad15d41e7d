"""Functional ops: plain PyTorch versions (``cost``, ``aggregation``,
``cvf``, ``disparity``, and ``refine``, the post-processing, which has no
kernel) and the launchers of the hand-written CUDA kernels
that replace the JAX package's Pallas kernels (``ssd_cuda``,
``sgm_cuda``, ``dp_cuda``, ``cvf_cuda``) and of the port's own census
kernels (``census_cuda``), built by ``_build``.  Importing them builds
nothing.  The JAX package's ``*_pallas`` entry points have
no alias here: the CUDA launchers are their counterparts."""

from .aggregation import semiglobal_aggregate
from .cost import (birchfield_cost_volume, census_hamming_cost_volume,
                   census_transform, sad_cost_volume, ssd_cost_volume,
                   ssd_texture_cost_volume)
from .cvf import guided_filter_aggregate
from .disparity import (dynamic_programming, dynamic_programming_with_paths,
                        winner_takes_all)
from .refine import (confidence_pkrn, fgs_smooth, fill_inconsistent,
                     left_right_consistency, median_filter_3x3,
                     right_disparity, right_disparity_from_volume,
                     right_volume_from_left, subpixel_refine,
                     weighted_median_filter)

__all__ = ["birchfield_cost_volume", "census_hamming_cost_volume",
           "census_transform", "confidence_pkrn", "dynamic_programming",
           "dynamic_programming_with_paths", "fgs_smooth",
           "fill_inconsistent", "guided_filter_aggregate",
           "left_right_consistency", "median_filter_3x3", "right_disparity",
           "right_disparity_from_volume", "right_volume_from_left",
           "sad_cost_volume", "semiglobal_aggregate", "ssd_cost_volume",
           "ssd_texture_cost_volume", "subpixel_refine",
           "weighted_median_filter", "winner_takes_all"]
