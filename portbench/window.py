"""The measured window: an in-memory capture, the closed loop over
``StreamingEstimator.run``, and the sample of answers kept for the
check.

The capture hands over the pool's frames in turn (``read_next()``, the
protocol of the program's captures), stamping each hand-over on the
host clock, and ends the stream at the first batch boundary after the
window's time has run out (or after ``frames``), so that no batch is
cut short.  The loop stamps each disparity as ``run`` yields it.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .scenes import Pair

# Answers kept for the check, drawn from the seed over the whole window
# (reservoir sampling), besides the window's first and last: at least
# this many in all, and at least two from each place in a batch, so that
# a fault confined to one batch slot is always in the sample.
SAMPLE = 12
PER_SLOT = 2


class PoolCapture:
    """A capture over an in-memory pool of frames."""

    def __init__(self, pool: Sequence[Pair], batch: int, *,
                 seconds: Optional[float] = None,
                 frames: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if seconds is None and frames is None:
            raise ValueError("a capture needs seconds or frames")
        self.pool = pool
        self.batch = batch
        self.seconds = seconds
        self.frames = frames
        self.clock = clock
        self.deadline: Optional[float] = None
        self.read_t: List[float] = []

    def read_next(self) -> Tuple[bool, Optional[Pair]]:
        n = len(self.read_t)
        if n % self.batch == 0:
            if self.frames is not None and n >= self.frames:
                return False, None
            if self.deadline is not None and self.clock() >= self.deadline:
                return False, None
        now = self.clock()
        if self.deadline is None and self.seconds is not None:
            self.deadline = now + self.seconds
        self.read_t.append(now)
        return True, self.pool[n % len(self.pool)]


class Kept(NamedTuple):
    index: int            # the frame's place in the window
    disparity: np.ndarray


class Window(NamedTuple):
    read_t: List[float]
    yield_t: List[float]
    kept: List[Kept]
    misplaced: int        # yielded out of order (not the frame handed over)


def drive(estimator, capture: PoolCapture, seed: int,
          on_frame: Optional[Callable[[float, int], None]] = None) -> Window:
    """Run ``estimator`` over ``capture`` to its end, stamping each
    yielded frame and keeping the sample.  ``on_frame(now, frames)``, if
    given, is called after each yield."""
    rng = random.Random(seed)
    pool, n_pool = capture.pool, len(capture.pool)
    slots = capture.batch
    per_slot = max(PER_SLOT, -(-SAMPLE // slots))
    reservoirs: List[List[Kept]] = [[] for _ in range(slots)]
    first = last = None
    misplaced = 0
    yield_t: List[float] = []
    clock = capture.clock
    for k, (left, disparity) in enumerate(estimator.run(capture)):
        now = clock()
        yield_t.append(now)
        if left is not pool[k % n_pool].left:
            misplaced += 1
        entry = Kept(k, disparity)
        if k == 0:
            first = entry
        reservoir, seen = reservoirs[k % slots], k // slots + 1
        if len(reservoir) < per_slot:
            reservoir.append(entry)
        else:
            j = rng.randrange(seen)
            if j < per_slot:
                reservoir[j] = entry
        last = entry
        if on_frame is not None:
            on_frame(now, k + 1)
    kept = {} if first is None else {first.index: first, last.index: last}
    kept.update((e.index, e) for reservoir in reservoirs for e in reservoir)
    return Window(capture.read_t, yield_t,
                  [kept[i] for i in sorted(kept)], misplaced)


class ProfilerSlice:
    """A ``torch.profiler`` capture of a short steady slice of the window:
    the profiler starts ``start_s`` after the window's first frame, runs
    ``warm_s`` (its device tracing starts late), then the host range
    ``trace.MARKER`` spans at least ``min_s`` and ``min_frames`` frames,
    and the profiler stops."""

    def __init__(self, start_s: float, warm_s: float = 0.2,
                 min_s: float = 0.3, min_frames: int = 64):
        self.start_s, self.warm_s = start_s, warm_s
        self.min_s, self.min_frames = min_s, min_frames
        self.prof = self.marker = None
        self.state = 0
        self.t0 = self.t_mark = 0.0
        self.frames_at = 0
        self.frames = 0

    def tick(self, now: float, frames: int) -> None:
        if self.state == 0:
            if frames == 1:
                self.t0 = now
            if now - self.t0 >= self.start_s:
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.t_mark, self.state = now, 1
        elif self.state == 1:
            if now - self.t_mark >= self.warm_s:
                from torch.autograd.profiler import record_function

                from .trace import MARKER
                self.marker = record_function(MARKER)
                self.marker.__enter__()
                self.t_mark, self.frames_at, self.state = now, frames, 2
        elif self.state == 2:
            if (now - self.t_mark >= self.min_s
                    and frames - self.frames_at >= self.min_frames):
                self.marker.__exit__(None, None, None)
                self.prof.stop()
                self.frames = frames - self.frames_at
                self.state = 3

    def close(self) -> None:
        """Stop a capture that the window's end cut short."""
        if self.state == 2:
            self.marker.__exit__(None, None, None)
        if self.state in (1, 2):
            self.prof.stop()
            self.state = 4
