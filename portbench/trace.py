"""Reduces a ``torch.profiler`` slice to the device's busy time, its
operations and its idle gaps.

The slice is the host range ``portbench/slice`` that the window opens
once the profiler has run for a while (its device tracing starts late)
and closes before stopping it.  Device events are clipped to it, and
busy time is the union of their intervals, so that overlapping
operations count once.  Each idle gap is named after what the slice's
host thread was doing in it: the host event that overlaps the gap most,
or ``python`` where none does.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

MARKER = "portbench/slice"
TOP = 10


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float
    device: bool
    thread: int
    top_level: bool


class Slice(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: int
    ops_by_name: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def from_profiler(function_events) -> List[Event]:
    """``Event``s of ``prof.events()``.  A host range also shows on the
    device's timeline as an annotation spanning its kernels: that is no
    device operation, and is left out."""
    from torch.autograd import DeviceType
    out = []
    for evt in function_events:
        device = evt.device_type == DeviceType.CUDA
        if device and (getattr(evt, "is_user_annotation", False)
                       or evt.name == MARKER):
            continue
        parent = evt.cpu_parent
        out.append(Event(evt.name, float(evt.time_range.start),
                         float(evt.time_range.end),
                         device, int(evt.thread),
                         parent is None or parent.name == MARKER))
    return out


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def reduce_slice(events: List[Event]) -> Optional[Slice]:
    """The slice of the last ``MARKER`` event, or None where the events
    hold no marker or no device operation in it."""
    markers = [e for e in events if not e.device and e.name == MARKER]
    if not markers:
        return None
    marker = max(markers, key=lambda e: e.start_us)
    lo, hi = marker.start_us, marker.end_us
    device = [(max(e.start_us, lo), min(e.end_us, hi), e.name)
              for e in events
              if e.device and e.end_us > lo and e.start_us < hi]
    if not device or hi <= lo:
        return None
    busy = union((s, t) for s, t, _ in device)
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in device:
        by_name[name] += (t - s) * 1e-6
    # The slice's thread runs its top-level host events one after another,
    # so walking back from the last that starts before a gap's end stops
    # at the first that ends before the gap's start.
    host = sorted((e for e in events if not e.device and e.top_level
                   and e.thread == marker.thread and e is not marker),
                  key=lambda e: e.start_us)
    starts = [e.start_us for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for pair in busy for x in pair] + [hi]
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end <= gap_start:
            continue
        best, label = 0.0, "python"
        i = bisect.bisect_left(starts, gap_end) - 1
        while i >= 0 and host[i].end_us > gap_start:
            e = host[i]
            overlap = min(e.end_us, gap_end) - max(e.start_us, gap_start)
            if overlap > best:
                best, label = overlap, e.name
            i -= 1
        gaps[label] += (gap_end - gap_start) * 1e-6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return Slice((hi - lo) * 1e-6, sum(t - s for s, t in busy) * 1e-6,
                 len(device), [[n[:100], v] for n, v in top(by_name)],
                 [[n[:100], v] for n, v in top(gaps)])
