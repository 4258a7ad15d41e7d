"""Tracing hooks.

The pipeline stages carry ``torch.profiler.record_function`` spans
(``stm/cost``, ``stm/aggregation``, ``stm/disparity_reduce``), the same
names the JAX package gives its ``jax.profiler`` annotations, so one
``torch.profiler.profile`` capture shows each stage against the CUDA
kernels it launched.

Usage:
    import torch
    from stereomatch_tpu_torch.utils import profiling

    with torch.profiler.profile() as prof:
        pipeline.estimate(left, right)
    print(prof.key_averages().table())

    # or annotate custom regions:
    with profiling.annotate("my-stage"):
        ...
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span on the profiler's host timeline."""
    with torch.profiler.record_function(name):
        yield
