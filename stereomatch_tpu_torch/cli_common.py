"""String registries + pipeline factory, counterpart of
``stereomatch_tpu/cli_common.py``.

The registries hold what this slice of the port runs.  A name that the
JAX package knows but the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item: a refusal, never a
quiet substitute.
"""

from __future__ import annotations

import torch

from .aggregation import Semiglobal
from .cost import SAD, SSD
from .disparity_reduce import WinnerTakesAll
from .pipeline import Pipeline

COST_METHODS = {"ssd": SSD, "sad": SAD}
AGGREGATION_METHODS = {"sgm": Semiglobal}
DISPARITY_METHODS = {"wta": WinnerTakesAll}
VOLUME_DTYPES = {"float32": torch.float32, "int32": torch.int32}

# Known to the JAX package, not ported yet: name -> ROADMAP item.
NOT_PORTED = {
    "ssd-texture": "A.8 (other cost families)",
    "birchfield": "A.8 (other cost families)",
    "census": "A.8 (other cost families)",
    "ncc": "A.8 (other cost families)",
    "cvf": "A.9 (CVF, kernels B.6-B.7)",
    "dyn": "A.6 (DP reducer, kernels B.4-B.5)",
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
                    backend: str = "auto",
                    volume_dtype: str = "float32") -> Pipeline:
    """Create a pipeline from method names.

    ``penalty1``/``penalty2`` configure SGM; ``backend`` ("auto", "cuda"
    or "torch") selects kernels or plain versions for the stages that
    have both; ``volume_dtype`` is the cost volume's dtype ("int32" is
    the reference's integer cost path, without aggregation).  The
    pipeline runs where ``Pipeline.estimate`` puts its inputs.
    """
    dtype = _lookup("volume dtype", volume_dtype, VOLUME_DTYPES)
    if dtype == torch.int32 and aggr_method is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2, semiglobal.cpp:137-138, is a "
                         "float quantity)")
    aggregation = None
    if aggr_method is not None:
        aggregation_cls = _lookup("aggregation method", aggr_method,
                                  AGGREGATION_METHODS)
        aggregation = aggregation_cls(penalty1=penalty1, penalty2=penalty2,
                                      backend=backend)
    disparity = _lookup("disparity method", disp_method,
                        DISPARITY_METHODS)()
    cost_cls = _lookup("cost method", cost_method, COST_METHODS)
    cost = cost_cls(max_disparity, cost_volume_dtype=dtype, backend=backend)
    return Pipeline(cost, disparity, aggregation=aggregation)
