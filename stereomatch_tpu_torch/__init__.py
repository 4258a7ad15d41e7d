"""stereomatch_tpu_torch — the stereo engine on PyTorch and CUDA.

The port of ``stereomatch_tpu`` (JAX/XLA/Pallas) to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper in place of the Pallas TPU
kernels.  It mirrors the JAX package's module names; the JAX package is
the reference it is tested against, and this package never imports JAX.

It runs SSD, SAD, census, Birchfield-Tomasi, ZNCC or SSD-over-textures
costs -> 8-path SGM with the adaptive P2 or guided-filter cost-volume
filtering (the wedge path) -> winner-takes-all or scanline dynamic
programming, then the post-processing of ``Pipeline.estimate_refined``
(``ops/refine.py``), on one device or row-sharded over a mesh of
devices (``parallel``); the coarse-to-fine ``PyramidPipeline``, the
video tracker ``TemporalPipeline`` and SGM penalty tuning by gradient
descent (``tune``, on the differentiable aggregation of ``ops/soft.py``);
``metrics``, ``reconstruction``, ``texture``,
``io`` (a PNG codec of its own among them) and the ``stm-eval`` and
``stm-image`` CLIs (``python -m stereomatch_tpu_torch.cli.evaluate``,
``.cli.image``) surround it.
Pipelines run on the card unless the caller asks for the CPU.  Plain
PyTorch versions run on CPU tensors and are the kernels' oracles; CUDA
tensors go through the kernels, which are built with ``nvcc`` at first
use, except where a kernel does not serve the shape (``backend="auto"``
then runs the plain version on the card).
"""

from . import (aggregation, cli_common, convert, cost, disparity_reduce,
               parallel, pyramid, temporal, texture, tune)
from .pipeline import Pipeline
from .pyramid import PyramidPipeline
from .temporal import TemporalPipeline

__version__ = "0.1.0"

__all__ = ["Pipeline", "PyramidPipeline", "TemporalPipeline", "aggregation",
           "cli_common", "convert", "cost", "disparity_reduce", "parallel",
           "pyramid", "temporal", "texture", "tune", "__version__"]
