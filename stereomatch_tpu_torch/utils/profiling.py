"""Tracing hooks.

The pipeline stages carry ``torch.profiler.record_function`` spans
(``stm/cost``, ``stm/aggregation``, ``stm/disparity_reduce``), the same
names the JAX package gives its ``jax.profiler`` annotations, so one
capture shows each stage against the CUDA kernels it launched.
:func:`trace` wraps such a capture and writes it as one Chrome-trace
JSON file, which ui.perfetto.dev and ``chrome://tracing`` open.

Usage:
    from stereomatch_tpu_torch.utils import profiling

    with profiling.trace("/tmp/stm-trace"):
        pipeline.estimate(left, right)

    # or annotate custom regions:
    with profiling.annotate("my-stage"):
        ...
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span on the profiler's host timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir, *, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a host profile, and the card's where CUDA is available,
    for the duration, and write it into ``log_dir`` as one Chrome-trace
    JSON file, also when the body raises.

    ``create_perfetto_link`` prints the file's path and that
    ui.perfetto.dev opens it; no server is started.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"stm-trace-{os.getpid()}-{time.time_ns()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        if create_perfetto_link:
            print(f"trace written to {path}; open it at "
                  f"https://ui.perfetto.dev", flush=True)


def annotate_fn(name: Optional[str] = None):
    """Decorator form of :func:`annotate`; the span is named ``name`` or
    the function's ``__name__``."""
    def wrap(fn):
        label = name or getattr(fn, "__name__", "fn")

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(label):
                return fn(*args, **kwargs)
        return inner
    return wrap
