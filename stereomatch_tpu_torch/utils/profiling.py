"""Tracing hooks.

Spans.  :func:`annotate` opens a ``torch.profiler.record_function``
range, the host span a profiler capture shows on its timeline beside
the CUDA kernels it launched, but only while a profiler records: with
none, a span is one check of the flag the profiler sets as it starts,
and enters nothing.  The pipeline stages carry spans through
:func:`stage` (``stm/cost``, ``stm/aggregation``,
``stm/disparity_reduce``, the names the JAX package gives its
``jax.profiler`` annotations), the stream its phases
(``stm/stream/*``, ``stream.py``).  :func:`trace` wraps such a capture
of every thread and writes it as one Chrome-trace JSON file, which
ui.perfetto.dev and ``chrome://tracing`` open; a capture started
otherwise records the spans of other threads only with
:func:`all_threads`'s option.

Stamps.  A CUDA graph replays its stages with no host range, so while a
profiler records, :func:`stage` also marks each stage boundary on the
device: a stamp (``csrc/trace.cu``) before the cost stage and one after
each stage, four a frame, each writing the card's global timer into the
device's :class:`StampRing`.  ``Pipeline.compiled()`` captures a second,
stamped graph for that (``pipeline.py``); the plain graph it replays
when no profiler records holds no stamp.  :func:`stage_seconds` turns a
ring's records back into each stage's device time.

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
import ctypes
import functools
import os
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_PROFILER = torch.autograd.profiler
_OFF = contextlib.nullcontext()
# What this thread's stage() calls do: "stage", the stage last entered
# (a failed graph capture names it); "stamps", None to stamp while a
# profiler records, else True or False whatever the profiler does.
_LOCAL = threading.local()

# The stamps' stage ids (csrc/trace.cu): BEGIN before the cost stage, then
# one after each stage.
BEGIN = 0
STAGE_IDS = {"cost": 1, "aggregation": 2, "disparity_reduce": 3}
# Stage ids -> the keys of stage_seconds and StreamStats.stage_device_s.
STAGE_KEYS = {1: "cost", 2: "aggregation", 3: "reduce"}
# Points inside a stage (:func:`point`): id -> the key of stage_seconds,
# whose seconds run from the frame's BEGIN stamp to the point's.
POINT_IDS = {"census_codes": 4}
POINT_KEYS = {v: k for k, v in POINT_IDS.items()}


def recording() -> bool:
    """Whether a ``torch.profiler`` capture is recording (on any thread):
    the flag the profiler sets as it starts and clears as it stops."""
    return _PROFILER._is_profiler_enabled


def annotate(name: str, batch: Optional[int] = None):
    """Named span on the profiler's host timeline, entered only while a
    profiler records.  ``batch``, the index of the batch the span works
    on within its run, is the range's args, so that all spans of one
    batch share one identifier."""
    if not _PROFILER._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(
        name, None if batch is None else str(batch))


def last_stage() -> Optional[str]:
    """The pipeline stage this thread last entered through :func:`stage`
    ("cost", "aggregation" or "disparity_reduce"), or None."""
    return getattr(_LOCAL, "stage", None)


@contextlib.contextmanager
def stage(name: str, device=None) -> Iterator[None]:
    """A pipeline stage ``name`` (a key of ``STAGE_IDS``): the span
    ``stm/<name>``, recorded as this thread's :func:`last_stage`.  While
    a profiler records (or inside ``stamping(True)``), on a CUDA
    ``device`` it also stamps the current stream after the stage, and
    before it where it is the cost stage."""
    _LOCAL.stage = name
    ring = _stamp_ring_for(device)
    if ring is not None and name == "cost":
        ring.stamp(BEGIN)
    with annotate("stm/" + name):
        yield
    if ring is not None:
        ring.stamp(STAGE_IDS[name])


def point(name: str, device=None) -> None:
    """A point ``name`` (a key of ``POINT_IDS``) inside the cost stage:
    where :func:`stage` stamps, it stamps the current stream here too."""
    ring = _stamp_ring_for(device)
    if ring is not None:
        ring.stamp(POINT_IDS[name])


@contextlib.contextmanager
def stamping(on: bool) -> Iterator[None]:
    """Inside, this thread's stages stamp (``on``) or do not, whether or
    not a profiler records: a graph capture decides what it holds."""
    before = getattr(_LOCAL, "stamps", None)
    _LOCAL.stamps = on
    try:
        yield
    finally:
        _LOCAL.stamps = before


def _stamp_ring_for(device) -> Optional["StampRing"]:
    if device is None or torch.device(device).type != "cuda":
        return None
    on = getattr(_LOCAL, "stamps", None)
    if on is None:
        # A capture this module did not ask for gets no stamps: its
        # replays would stamp slots the host never accounts for.
        on = recording() and not torch.cuda.is_current_stream_capturing()
    return stamp_ring(device) if on else None


class StampRing:
    """The stamps of one card: ``CAPACITY`` records {slot, time in ns,
    frame, stage id} in mapped pinned host memory, written by the stamp
    kernel at the slot a device-side cursor gives, and read by the host
    after an event recorded behind them.

    ``enqueued`` mirrors that cursor: the stamps launched outside a
    capture, plus each stamped graph's stamps at each replay
    (:meth:`replayed`).  The stamps enqueued between two readings of it
    on one thread and one stream take the slots between them; where
    another thread stamps the same card at the same time, their order on
    the device may differ and :meth:`read` finds other slots there."""

    CAPACITY = 4096               # a power of two; 128 KiB
    _FIELDS = 4

    def __init__(self, device):
        from ..ops import _build
        self.device = torch.device(device)
        host, mapped = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _build.check_status(
                "stm_stamp_ring_alloc", _build.library().stm_stamp_ring_alloc(
                    self.CAPACITY * self._FIELDS * 8, ctypes.byref(host),
                    ctypes.byref(mapped)))
            # Two counters: the next slot, the last frame number.
            self._state = torch.zeros(2, dtype=torch.int64,
                                      device=self.device)
            torch.cuda.current_stream(self.device).synchronize()
        words = (ctypes.c_uint64 * (self.CAPACITY * self._FIELDS)
                 ).from_address(host.value)
        self._records = np.ctypeslib.as_array(words).reshape(
            self.CAPACITY, self._FIELDS)
        self._mapped = mapped.value
        self._lock = threading.Lock()
        self.enqueued = 0

    def stamp(self, stage_id: int) -> None:
        """One stamp on the current stream (into a capture, if it is
        capturing)."""
        from ..ops import _build
        stream = torch.cuda.current_stream(self.device)
        _build.check_status("stm_stamp", _build.library().stm_stamp(
            self._mapped, self._state.data_ptr(), self.CAPACITY - 1,
            stage_id, stream.cuda_stream))
        if not torch.cuda.is_current_stream_capturing():
            with self._lock:
                self.enqueued += 1

    def replayed(self, stamps: int) -> None:
        """A stamped graph holding ``stamps`` stamps was replayed."""
        with self._lock:
            self.enqueued += stamps

    def read(self, first: int, end: int) -> Optional[np.ndarray]:
        """A copy of the records of slots [first, end) as [n, 4] uint64
        rows, once every stamp before ``end`` has run; None where the
        ring no longer (or never) held them there."""
        if end - first > self.CAPACITY:
            return None
        slots = np.arange(first, end, dtype=np.uint64)
        rows = self._records[(slots & np.uint64(self.CAPACITY - 1)
                              ).astype(np.intp)]
        return rows if np.array_equal(rows[:, 0], slots) else None


_RINGS: Dict[torch.device, StampRing] = {}
_RINGS_LOCK = threading.Lock()


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def stamp_ring(device) -> StampRing:
    """The stamp ring of a CUDA ``device``, made at its first use (never
    while its stream captures a graph: make it before)."""
    device = _card(device)
    ring = _RINGS.get(device)
    if ring is None:
        with _RINGS_LOCK:
            ring = _RINGS.get(device)
            if ring is None:
                ring = _RINGS[device] = StampRing(device)
    return ring


def stamp_mark(device) -> int:
    """``enqueued`` of ``device``'s ring (0 before it has one): the slots
    of the stamps launched between two marks lie between them."""
    ring = _RINGS.get(_card(device)) if _RINGS else None
    return 0 if ring is None else ring.enqueued


def stage_seconds(rows: np.ndarray) -> Tuple[Dict[str, float], int]:
    """({"cost", "aggregation", "reduce"}: device seconds, frames) of the
    complete frames among stamp records ``rows`` (in slot order): a
    BEGIN stamp, then one after each stage, the last after the reduce,
    all of one frame number.  A stage's time runs from the stamp before
    it to the stamp after it: in a replayed graph its nodes and the gaps
    beside the stamps, in an eager frame the host's gaps between its
    launches too.  A point's stamp (``POINT_IDS``)
    inside a stage splits nothing: its key ("census_codes"), present
    where a complete frame had one, takes the time from BEGIN to it (the
    frame's last such stamp), and the stage keeps its whole time.  The
    stages of an incomplete frame are left out."""
    total = dict.fromkeys(STAGE_KEYS.values(), 0.0)
    frames = 0
    part: Optional[Dict[str, float]] = None
    prev = frame = begin = 0
    for _, t, f, stage_id in rows.tolist():
        if stage_id == BEGIN:
            part, prev, frame, begin = {}, t, f, t
        elif part is not None and f == frame and stage_id in POINT_KEYS:
            part[POINT_KEYS[stage_id]] = (t - begin) * 1e-9
        elif part is not None and f == frame and stage_id in STAGE_KEYS:
            key = STAGE_KEYS[stage_id]
            part[key] = part.get(key, 0.0) + (t - prev) * 1e-9
            prev = t
            if stage_id == STAGE_IDS["disparity_reduce"]:
                for k, v in part.items():
                    total[k] = total.get(k, 0.0) + v
                frames += 1
                part = None
        else:
            part = None
    return total, frames


def graph_nodes(raw_graph: int) -> Dict[str, int]:
    """{"kernel", "memcpy", "memset", "other"}: the nodes of a captured
    ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``) by type."""
    from ..ops import _build
    counts = (ctypes.c_longlong * 4)()
    _build.check_status("stm_graph_nodes", _build.library().stm_graph_nodes(
        raw_graph, counts))
    return dict(zip(("kernel", "memcpy", "memset", "other"), counts))


def all_threads():
    """A profiler's ``experimental_config`` that records the spans of
    every thread (the stream's fetch threads too), where this PyTorch
    has the option; else None, its default: the spans of the thread that
    started the profiler."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        return None


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
    prof = torch.profiler.profile(activities=activities,
                                  experimental_config=all_threads())
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
