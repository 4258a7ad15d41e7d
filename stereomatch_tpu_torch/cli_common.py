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
VOLUME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}

# Known to the JAX package, not ported yet: name -> ROADMAP item.
NOT_PORTED = {
    "ssd-texture": "A.8 (other cost families)",
    "birchfield": "A.8 (other cost families)",
    "ncc": "A.8 (other cost families)",
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


# The smallest frame (pixels) at which bf16 volumes measured faster than
# float32 for SGM on the H100: 1280x720 (see recommended_dtype).
BF16_SGM_MIN_PIXELS = 1280 * 720


def recommended_dtype(height: int, width: int,
                      aggregation: str = "sgm") -> str:
    """The volume dtype ("float32" or "bfloat16") that runs a frame of
    ``height`` x ``width`` faster on the card, with float32 where the two
    measured level (its volumes are exact).

    Measured by ``chip_smoke.py`` (phase 5: CUDA events, median of 20
    frames, float32 and bf16 in turns, device-resident images) on an
    NVIDIA H100 80GB HBM3 at a 700.00 W power limit; ms/frame, float32
    against bf16:

    * SSD + SGM + WTA: 640x480, D=64: 1.34-1.44 against 1.34-1.46 and
      450x375, D=128: 1.35-1.38 against 1.21-1.33 (level: the SGM step
      chain bounds both); 1280x720, D=128: 5.27-5.30 against 4.64-4.66;
      1280x1024, D=256: 13.72-13.76 against 12.02-12.05; 1920x1080,
      D=256: 21.73-21.80 against 18.45-18.49.  With DP at 1280x1024:
      13.67-13.71 against 11.72-11.74.  bf16 halves the SGM kernels'
      cost-volume reads, which bound them from 720p up.
    * census + CVF + WTA: level at 450x375 (4.5-5.3, host launches) and
      at 1280x1024 (38.03-38.74 against 38.29-38.30): the plain PyTorch
      census takes about 27 ms there in either dtype, and the CVF
      kernels are bound by instruction issue, not bytes.
    * no aggregation: neither the SSD kernel (1.15-1.18 ms against
      1.17-1.23 at 1280x1024 over three runs: it is bound by issue) nor
      torch.argmin (0.80-0.83 against 0.81-0.85) gains.

    So bf16 for SGM from ``BF16_SGM_MIN_PIXELS`` (1280x720) up, float32
    otherwise.  The rule is by pixels, as JAX's is, but what bf16 saves
    is volume bytes (H x W x D): each size above was measured only at the
    D beside it, so the threshold holds for those pairs (D = 64 or 128
    below 720p, 128 at 720p, 256 above); a small frame at a large D is
    not covered.
    """
    if aggregation == "sgm" and height * width >= BF16_SGM_MIN_PIXELS:
        return "bfloat16"
    return "float32"


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
    that have both; ``volume_dtype`` is the cost volume's dtype
    ("float32"; "bfloat16", volumes stored in half the bytes with float32
    arithmetic, each stage rounding once, see :func:`recommended_dtype`;
    "int32", the reference's integer cost path, without aggregation).
    The pipeline runs on ``device``: the card unless ``"cpu"`` is asked
    for.
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
