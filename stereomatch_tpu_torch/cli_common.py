"""String registries + pipeline factory, counterpart of
``stereomatch_tpu/cli_common.py``.

The registries hold every name of the JAX package's registries.  An
option the port does not run yet (``cvf_subsample > 1``) raises
``NotImplementedError`` naming its ROADMAP item: a refusal, never a
quiet substitute.
"""

from __future__ import annotations

import torch

from .aggregation import CostFilter, Semiglobal
from .cost import NCC, SAD, SSD, Birchfield, Census, SSDTexture
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .pipeline import Device, Pipeline

COST_METHODS = {"ssd": SSD, "ssd-texture": SSDTexture,
                "birchfield": Birchfield, "census": Census, "sad": SAD,
                "ncc": NCC}
AGGREGATION_METHODS = {"sgm": Semiglobal, "cvf": CostFilter}
DISPARITY_METHODS = {"wta": WinnerTakesAll, "dyn": DynamicProgramming}
VOLUME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int32": torch.int32}

def _lookup(kind: str, name, registry: dict):
    if name in registry:
        return registry[name]
    raise ValueError(f"unknown {kind} {name!r}; expected one of "
                     f"{sorted(registry)}")


# The smallest volume (H x W x D cells) at which bf16 volumes measured
# faster than float32 for SGM on the H100: 1280x720 at D=64 (see
# recommended_dtype).
BF16_SGM_MIN_CELLS = 1280 * 720 * 64


def recommended_dtype(height: int, width: int, aggregation: str = "sgm", *,
                      max_disparity: int) -> str:
    """The volume dtype ("float32" or "bfloat16") that runs a frame of
    ``height`` x ``width`` at ``max_disparity`` faster on the card, with
    float32 where the two measured level (its volumes are exact).

    Measured by ``chip_smoke.py`` (phase 5: CUDA events, median of 20
    frames, float32 and bf16 in turns, device-resident images) on an
    NVIDIA H100 80GB HBM3 at a 700.00 W power limit; SSD + SGM + WTA,
    ms/frame, float32 against bf16, by volume (cells = H x W x D):

    * 640x480, D=64 (19.7M cells): 1.34-1.36 against 1.39-1.42, and
      450x375, D=128 (21.6M): 1.35-1.38 against 1.21-1.33 (level: the
      SGM step chain bounds both);
    * 1280x720, D=64 (59.0M): 3.07-3.10 against 2.96-2.99;
    * 640x480, D=256 (78.6M): 3.49-3.58 against 3.01-3.09;
    * 1280x720, D=128 (118M): 5.28-5.31 against 4.61-4.64;
    * 1280x1024, D=256 (336M): 13.72-13.76 against 12.02-12.05, and with
      DP 13.67-13.71 against 11.72-11.74;
    * 1920x1080, D=256 (531M): 21.69-21.80 against 18.36-18.49.

    bf16 halves the SGM kernels' cost-volume reads, which bound them once
    the volume is large, whatever the frame size: VGA at D=256 gains 15%
    though it has a third of 720p's pixels.  The ranges span two or more
    runs of the script.  So bf16 for SGM from ``BF16_SGM_MIN_CELLS``
    (1280x720x64) up, float32 below (no size between 21.6M and 59.0M
    cells was measured).  Elsewhere float32: census + CVF + WTA measured
    level at 450x375 (host launches) and at 1280x1024 (38.03-38.74
    against 38.29-38.30; plain PyTorch census takes about 27 ms there
    and the CVF kernels are bound by their instruction rate), and
    without aggregation neither the SSD kernel (bound the same way) nor
    torch.argmin gains.
    """
    if (aggregation == "sgm"
            and height * width * max_disparity >= BF16_SGM_MIN_CELLS):
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
    "int32", the reference's integer cost path, without aggregation;
    ``ncc`` refuses it, ``birchfield`` and ``ssd-texture`` ignore it and
    compute float32).  The pipeline runs on ``device``: the card unless
    ``"cpu"`` is asked for.
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
    if cost_cls is NCC and dtype == torch.int32:
        raise ValueError("ncc cost is a normalized float quantity; "
                         "volume_dtype int32 is not supported")
    if cost_cls is Census:
        cost = Census(max_disparity, window_size=census_window,
                      cost_volume_dtype=dtype)
    elif cost_cls in (SSD, SAD):
        cost = cost_cls(max_disparity, cost_volume_dtype=dtype,
                        backend=backend)
    elif cost_cls is NCC:
        cost = NCC(max_disparity, cost_volume_dtype=dtype)
    elif cost_cls is SSDTexture:
        cost = SSDTexture(max_disparity, backend=backend)
    else:
        cost = Birchfield(max_disparity)
    return Pipeline(cost, disparity, aggregation=aggregation, device=device)
