"""String registries + pipeline factory, counterpart of
``stereomatch_tpu/cli_common.py``.

The registries hold what this slice of the port runs.  A name that the
JAX package knows but the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item: a refusal, never a
quiet substitute.
"""

from __future__ import annotations

import torch

from .aggregation import CostFilter, Semiglobal
from .cost import SAD, SSD, Census
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .pipeline import Device, Pipeline

COST_METHODS = {"ssd": SSD, "sad": SAD, "census": Census}
AGGREGATION_METHODS = {"sgm": Semiglobal, "cvf": CostFilter}
DISPARITY_METHODS = {"wta": WinnerTakesAll, "dyn": DynamicProgramming}
VOLUME_DTYPES = {"float32": torch.float32, "int32": torch.int32}

# Known to the JAX package, not ported yet: name -> ROADMAP item.
NOT_PORTED = {
    "ssd-texture": "A.8 (other cost families)",
    "birchfield": "A.8 (other cost families)",
    "ncc": "A.8 (other cost families)",
    "bfloat16": "A.7 (bf16 volume storage)",
}


def _lookup(kind: str, name, registry: dict):
    if name in registry:
        return registry[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to stereomatch_tpu_torch yet "
            f"(ROADMAP {NOT_PORTED[name]})")
    raise ValueError(f"unknown {kind} {name!r}; expected one of "
                     f"{sorted(registry)}")


def create_pipeline(cost_method: str, disp_method: str,
                    aggr_method: str = None,
                    max_disparity: int = 32,
                    penalty1: float = 0.1, penalty2: float = 0.2,
                    cvf_radius: int = 8, cvf_eps: float = 1e-4,
                    cvf_subsample: int = 1,
                    census_window: int = 5,
                    backend: str = "auto",
                    volume_dtype: str = "float32",
                    device: Device = "cuda") -> Pipeline:
    """Create a pipeline from method names.

    ``penalty1``/``penalty2`` configure SGM, ``cvf_radius``/``cvf_eps``/
    ``cvf_subsample`` the guided filter, and ``census_window`` the census
    code window (each ignored by the other methods); ``backend`` ("auto",
    "cuda" or "torch") selects kernels or plain versions for the stages
    that have both; ``volume_dtype`` is the cost volume's dtype ("int32"
    is the reference's integer cost path, without aggregation).  The
    pipeline runs on ``device``: the card unless ``"cpu"`` is asked for.
    """
    dtype = _lookup("volume dtype", volume_dtype, VOLUME_DTYPES)
    if dtype == torch.int32 and aggr_method is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2, semiglobal.cpp:137-138, and "
                         "cvf's windowed means are float quantities)")
    aggregation = None
    if aggr_method is not None:
        aggregation_cls = _lookup("aggregation method", aggr_method,
                                  AGGREGATION_METHODS)
        kwargs = dict(penalty1=penalty1, penalty2=penalty2, backend=backend)
        if aggregation_cls is CostFilter:
            kwargs.update(radius=cvf_radius, eps=cvf_eps,
                          subsample=cvf_subsample)
            # Every registry cost family writes +inf at exactly the wedge
            # x < d, so the filter takes the wedge path, as the JAX
            # package's factory does; the subsampled filter keeps its own
            # statistics.
            if cvf_subsample == 1:
                kwargs.update(wedge_offset=0)
        aggregation = aggregation_cls(**kwargs)
    disparity_cls = _lookup("disparity method", disp_method,
                            DISPARITY_METHODS)
    disparity = (disparity_cls(backend=backend)
                 if disparity_cls is DynamicProgramming else disparity_cls())
    cost_cls = _lookup("cost method", cost_method, COST_METHODS)
    if cost_cls is Census:
        cost = Census(max_disparity, window_size=census_window,
                      cost_volume_dtype=dtype)
    else:
        cost = cost_cls(max_disparity, cost_volume_dtype=dtype,
                        backend=backend)
    return Pipeline(cost, disparity, aggregation=aggregation, device=device)
