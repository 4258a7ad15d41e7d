"""String registries + pipeline factory, counterpart of
``stereomatch_tpu/cli_common.py``.

The registries hold every name of the JAX package's registries, and
every combination that the JAX package's factory builds runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from .aggregation import CostFilter, Semiglobal
# COST_METHODS and VOLUME_DTYPES are registries of this module, owned
# by the modules that decide them.
from .cost import COST_METHODS, make_cost  # noqa: F401
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .pipeline import Device, Pipeline
from .utils import validation
from .utils.validation import VOLUME_DTYPES  # noqa: F401

AGGREGATION_METHODS = {"sgm": Semiglobal, "cvf": CostFilter}
DISPARITY_METHODS = {"wta": WinnerTakesAll, "dyn": DynamicProgramming}
# CLI disparity-method name -> the reducer name of ``stream`` and
# ``parallel`` (which took the long name first, as in the JAX package).
STREAM_REDUCERS = {"wta": "wta", "dyn": "dynamic_programming"}


# ``--mesh --device cpu``: the CPU devices of a CLI's mesh, as many as
# the JAX package's tests run their CLIs over (the 8-device virtual CPU
# mesh), so that the tiles, and the refusals that depend on them, match.
MESH_CPU_DEVICES = 8


def start_device(device):
    """Arm the CUDA start watchdog for ``device``
    (``utils.backend.warn_if_backend_init_stalls``) and, off the CPU,
    start CUDA at once, so that a runtime still down when the timer fires
    is stuck and not waiting on host work.  A failed start cancels the
    timer and raises.  Returns the timer, or None under ``--device
    cpu``."""
    from .utils.backend import warn_if_backend_init_stalls
    timer = warn_if_backend_init_stalls(device=device)
    if timer is not None:
        try:
            torch.cuda.init()
        except BaseException:
            timer.cancel()
            raise
    return timer


def mesh_devices(device) -> list:
    """The devices a CLI's ``--mesh`` lays out: every visible card under
    ``--device cuda``, ``MESH_CPU_DEVICES`` CPU devices under ``--device
    cpu``."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * MESH_CPU_DEVICES
    if not torch.cuda.is_available():
        raise RuntimeError("--mesh on the card found no CUDA device; pass "
                           "--device cpu to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def add_census_sgm_options(parser) -> None:
    """The CLIs' ``--census-height`` and ``--constant-p2``, the port's own
    options (the JAX CLIs have neither): ``create_pipeline``'s and
    ``StreamingEstimator``'s ``census_height`` and ``adaptive_p2``."""
    parser.add_argument("--census-height", type=int, default=None,
                        help="-cm census: code window height (odd; default "
                             "--census-window, a square window), e.g. 7 "
                             "with --census-window 9 for the 9x7 census of "
                             "KITTI deployments.")
    parser.add_argument("--constant-p2", action="store_true",
                        help="-am sgm: the constant second penalty P2' = "
                             "max(P1, P2) at every step, in place of P2 "
                             "scaled by the inverse image gradient.")


def census_sgm_refusal(args, mode: str) -> Optional[str]:
    """The message refusing ``--census-height``/``--constant-p2`` beside
    ``mode`` (the pyramid, the temporal tracker: a square census and the
    adaptive P2), or None where neither is given."""
    given = [flag for flag, on in [
        ("--census-height", args.census_height is not None),
        ("--constant-p2", args.constant_p2)] if on]
    if not given:
        return None
    return (f"{mode} is incompatible with {' '.join(given)} (its census "
            "window is square and its SGM takes the adaptive P2).")


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
    against 38.29-38.30, while the census was plain PyTorch, about 27 ms
    there, before its kernels; the CVF kernels are bound by their
    instruction rate), and
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
                    device: Device = "cuda",
                    kernel_size: Optional[int] = None,
                    census_height: Optional[int] = None,
                    adaptive_p2: bool = True) -> Pipeline:
    """Create a pipeline from method names.

    ``penalty1``/``penalty2`` configure SGM (``adaptive_p2=False``: the
    constant P2' = max(P1, P2) in place of the adaptive one),
    ``cvf_radius``/``cvf_eps``/``cvf_subsample`` the guided filter, and
    ``census_window``/``census_height`` the census code window's width
    and height (None: square) (each ignored by the other methods;
    ``census_height`` and ``adaptive_p2`` are the port's own, the JAX
    factory has neither); ``backend`` ("auto",
    "cuda" or "torch") selects kernels or plain versions for the stages
    that have both; ``volume_dtype`` is the cost volume's dtype
    ("float32"; "bfloat16", volumes stored in half the bytes with float32
    arithmetic, each stage rounding once, see :func:`recommended_dtype`;
    "int32", the reference's integer cost path, without aggregation;
    ``ncc`` refuses it, ``birchfield`` and ``ssd-texture`` ignore it and
    compute float32).  The pipeline runs on ``device``: the card unless
    ``"cpu"`` is asked for.  ``kernel_size`` overrides the cost's window
    (None: the cost class's default, as the JAX factory leaves it).
    """
    dtype = validation.volume_dtype(volume_dtype, aggr_method)
    aggregation = None
    if aggr_method is not None:
        aggregation_cls = _lookup("aggregation method", aggr_method,
                                  AGGREGATION_METHODS)
        kwargs = dict(penalty1=penalty1, penalty2=penalty2, backend=backend)
        if aggregation_cls is Semiglobal:
            kwargs.update(adaptive_p2=adaptive_p2)
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
    cost = make_cost(cost_method, max_disparity, kernel_size=kernel_size,
                     cost_dtype=dtype, census_window=census_window,
                     census_height=census_height, backend=backend)
    return Pipeline(cost, disparity, aggregation=aggregation, device=device)
