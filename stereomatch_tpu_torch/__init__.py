"""stereomatch_tpu_torch — the stereo engine on PyTorch and CUDA.

The port of ``stereomatch_tpu`` (JAX/XLA/Pallas) to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper in place of the Pallas TPU
kernels.  It mirrors the JAX package's module names; the JAX package is
the reference it is tested against, and this package never imports JAX.

It runs SSD, SAD or census costs -> 8-path SGM with the adaptive P2 or
guided-filter cost-volume filtering (the wedge path) -> winner-takes-all
or scanline dynamic programming, on one device or row-sharded over a
mesh of devices (``parallel``).  Pipelines run on the card unless the
caller asks for the CPU.  Plain PyTorch versions run on CPU tensors and
are the kernels' oracles; CUDA tensors go through the kernels, which are
built with ``nvcc`` at first use.
"""

from . import (aggregation, cli_common, convert, cost, disparity_reduce,
               parallel)
from .pipeline import Pipeline

__version__ = "0.1.0"

__all__ = ["Pipeline", "aggregation", "cli_common", "convert", "cost",
           "disparity_reduce", "parallel", "__version__"]
