"""Batched streaming estimation for stereo video, the counterpart of
``stereomatch_tpu/stream.py``.

``StreamingEstimator.run`` drives a capture (``read_next()``) to its end
and yields each frame's int32 disparity in order, keeping up to
``depth`` batches of ``batch`` frames in flight:

* **Upload.**  Frames keep their storage dtype (uint8 video) across the
  host-to-device copy and widen to float32 on the device (exact for 8-
  and 16-bit values).  A batch is written into one of ``depth + 1``
  pinned host staging buffers and copied to the card with
  ``non_blocking=True``; an event recorded after the copy guards the
  buffer, which is not refilled until that event has completed (the
  asynchronous copy may still be reading it).
* **Batch.**  The frames of a batch run back to back on one CUDA stream
  the estimator owns (the counterpart of the JAX module's ``lax.map``).
  The flat registry paths without post-processing replay the frame's
  ``Pipeline.compiled()`` CUDA graph, copying its static output into the
  frame's slot of the batch before the next replay; post-processed,
  pyramid and ``backend="torch"`` frames run eagerly.  That choice is
  made once, at construction, from the options.
* **Fetch.**  Integer disparities narrow on the device to uint8 (D <=
  256, else uint16), are copied into pinned host memory with
  ``non_blocking=True`` and an event is recorded; a pool of
  ``min(fetch_workers, depth)`` threads waits on the events and widens
  back to int32 on the host.  Float outputs (sub-pixel, the smoother,
  the background speckle fill) pass through.

A frame is the port's ``Pipeline.estimate_refined`` chain (left-right
check, weighted median, median, sub-pixel, smoother; then speckle
filtering), so a streamed frame equals ``estimate_refined`` with the
same options bit for bit; pyramid frames are
``PyramidPipeline._estimate`` (plus speckle filtering).  With ``mesh=``
the batch runs through ``parallel.make_sharded_estimate`` (or
``make_pyramid_sharded_estimate``): frames over the mesh's batch axis,
image rows over its tile axis.  On the CPU nothing is pinned and every
step runs in turn on the calling thread.
"""

from __future__ import annotations

import collections
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cli_common import STREAM_REDUCERS, create_pipeline
from .ops import _build
from .pipeline import Device
from .utils import profiling, validation

# Reducer names of the stream and ``parallel`` -> the registry's.
_REGISTRY_REDUCERS = {v: k for k, v in STREAM_REDUCERS.items()}


def _widen_host(host: np.ndarray) -> np.ndarray:
    """Undo the fetch narrowing on the host: unsigned fetch dtypes widen
    back to the int32 the yield contract promises (float passes through)."""
    if np.issubdtype(host.dtype, np.unsignedinteger):
        return host.astype(np.int32)
    return host


def narrow_for_fetch(out: torch.Tensor, max_disparity: int) -> torch.Tensor:
    """Cast int32 disparities (all below ``max_disparity``) to uint8 for D
    <= 256, else uint16, on their device before the copy to the host:
    lossless, with 4x (2x) fewer bytes.  Float outputs pass through."""
    if out.dtype == torch.int32:
        return out.to(torch.uint8 if max_disparity <= 256 else torch.uint16)
    return out


@dataclass
class StreamStats:
    """One ``run``'s counts and its host-clock stage split, each stage
    the sum of its ``stm/stream/*`` spans (``utils/profiling.py``):

    * decode = ``capture.read_next`` and the grayscale split (``read``);
    * dispatch = staging, upload and enqueueing a batch's frames and its
      fetch (``stage``, ``upload``, ``frames``, ``fetch``); ``stage_s``
      is the part spent filling the pinned staging buffer, the wait on
      its slot's event included, the rest is the enqueue;
    * fetch = the time ``run`` waited for a batch's result (``wait``);
      ``handoff_s`` is the part of it after the fetch thread returned
      from the batch's event (the widening on the host and the hand-off
      between the threads).

    The rest of ``seconds`` is the consumer's.  ``launches`` counts the
    hand-written kernels' launches of the frames run (padding included:
    ``frames_run``), a replayed frame counting its graph's captured
    launches.  ``device_ops`` counts the device operations enqueued for
    them: each replay's graph nodes and its copies in and out, and each
    batch's uploads, widenings, narrowing and copy to the host; None
    once a frame ran eagerly or over a mesh, where the count would miss
    PyTorch's operations.  It leaves out the stage stamps that a
    recording profiler adds, four a frame and five with a census cost
    (``stamps``); of those, ``stage_device_s`` sums the device seconds
    of each stage over the ``frames_stamped`` frames whose stamps read
    back whole, and, with a census cost, under "census_codes" those from
    the frame's first stamp to the one after its census codes."""
    frames: int = 0
    batches: int = 0
    seconds: float = 0.0
    decode_s: float = 0.0
    dispatch_s: float = 0.0
    fetch_s: float = 0.0
    stage_s: float = 0.0
    handoff_s: float = 0.0
    frames_run: int = 0
    launches: collections.Counter = field(
        default_factory=collections.Counter, repr=False)
    device_ops: Optional[int] = 0
    stamps: int = 0
    frames_stamped: int = 0
    stage_device_s: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(
            profiling.STAGE_KEYS.values(), 0.0))
    _start: Optional[float] = field(default=None, repr=False)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0

    def stage_ms_per_frame(self) -> dict:
        n = max(self.frames, 1)
        other = max(self.seconds - self.decode_s - self.dispatch_s
                    - self.fetch_s, 0.0)
        return {k: round(v / n * 1e3, 2) for k, v in [
            ("decode", self.decode_s), ("dispatch", self.dispatch_s),
            ("fetch", self.fetch_s), ("other", other),
            ("total", self.seconds)]}


# The stats of the last ``run`` to finish in this process (any
# estimator's), kept after its estimator is freed.
LAST_STATS: Optional[StreamStats] = None


class _Fetched(NamedTuple):
    """A batch as its fetch thread hands it over: the host disparities,
    the host clock when its event had completed, and what its stamps
    read (stage seconds, frames stamped, stamps), or None."""
    disparities: np.ndarray
    synced: float
    stamps: Optional[Tuple[Dict[str, float], int, int]]


class _Staging:
    """A pinned host buffer pair for one batch, and the event recorded
    after the copy that reads it."""

    def __init__(self, shape, dtype: torch.dtype):
        self.left = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.right = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.event: Optional[torch.cuda.Event] = None


class StreamingEstimator:
    """Batched estimator over stereo frame streams.

    The options are the JAX module's (``cost``, ``aggregation``,
    ``reducer`` "wta" or "dynamic_programming", the refine and speckle
    options, ``pyramid_levels``, ``mesh``); ``backend`` takes the port's
    names ("auto", "cuda", "torch"), ``cost_dtype`` a torch dtype or its
    name, and ``device`` says where frames run without a mesh: the card
    unless "cpu" is asked for.  ``pyramid_levels`` > 0 runs the census
    pyramid (it ignores ``cost``/``aggregation``/``reducer``; its
    inter-level median is ``pyramid_median``) and refuses the options
    that need a full cost volume, and a rectangular census window or the
    constant P2, which its band stage and SGM do not take.
    ``census_height`` (the census window's height, None: square) and
    ``adaptive_p2`` (False: SGM's constant P2' = max(P1, P2)) are the
    port's own options.  ``stream`` is the CUDA stream the
    frames are enqueued on (default: one the estimator creates); callers
    that share one must enqueue on it from one thread at a time.
    """

    def __init__(self, max_disparity: int, *, batch: int = 4,
                 depth: int = 2,
                 cost: str = "ssd", kernel_size: Optional[int] = None,
                 cost_dtype=torch.float32, census_window: int = 5,
                 aggregation: Optional[str] = "sgm", reducer: str = "wta",
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 cvf_radius: int = 8, cvf_eps: float = 1e-4,
                 fetch_workers: int = 4,
                 backend: str = "auto", mesh=None,
                 sgm_mode: str = "exact", overlap: int = 64,
                 pyramid_levels: int = 0, band_radius: int = 24,
                 pyramid_median: bool = True,
                 median: bool = False, subpixel: bool = False,
                 lr_check: bool = False, lr_mode: str = "volume",
                 lr_max_diff: int = 1,
                 weighted_median: bool = False, wmf_sigma: float = 10.0,
                 wmf_window: int = 5,
                 fgs_lambda=None, fgs_sigma: float = 8.0,
                 speckle: bool = False, speckle_fill: str = "zero",
                 device: Device = "cuda", stream=None,
                 census_height: Optional[int] = None,
                 adaptive_p2: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if lr_mode not in ("mirror", "volume"):
            raise ValueError(f"unknown lr_mode: {lr_mode!r}")
        if speckle_fill not in ("zero", "background"):
            raise ValueError(f"unknown fill mode: {speckle_fill!r}")
        if reducer not in _REGISTRY_REDUCERS:
            raise ValueError(f"unknown reducer {reducer!r}; expected one of "
                             f"{sorted(_REGISTRY_REDUCERS)}")
        if pyramid_levels > 0:
            shaped = [name for name, on in [
                ("census_height", census_height is not None),
                ("adaptive_p2=False", not adaptive_p2)] if on]
            if shaped:
                raise ValueError(
                    f"pyramid_levels > 0 does not support {shaped}: the "
                    "pyramid's census is square and its SGM takes the "
                    "adaptive P2 (running them instead would misreport "
                    "what ran)")
            wanted = [name for name, on in [
                ("lr_check", lr_check), ("weighted_median", weighted_median),
                ("fgs_lambda", fgs_lambda is not None)] if on]
            if wanted:
                raise ValueError(
                    f"pyramid_levels > 0 does not support {wanted}: the "
                    "band stage has no full cost volume / flat "
                    "post-processing stage (silently skipping them would "
                    "misreport what ran)")
        self.max_disparity = max_disparity
        # Batches in flight before run() waits for the oldest: 1 = fully
        # synchronous; frames yield in order at any depth.
        self.depth = depth
        # Effective fetch concurrency is min(fetch_workers, depth).
        self.fetch_workers = max(int(fetch_workers), 1)
        dtype = validation.volume_dtype(cost_dtype)
        refine = dict(subpixel=subpixel, median=median, lr_check=lr_check,
                      lr_mode=lr_mode, max_diff=lr_max_diff,
                      weighted_median=weighted_median, wmf_sigma=wmf_sigma,
                      wmf_window=wmf_window, fgs_lambda=fgs_lambda,
                      fgs_sigma=fgs_sigma)
        self._speckle_fill = speckle_fill if speckle else None
        self._sharded = None
        self._compiled = None
        self._pipeline = None
        self._pyramid = None
        # Every batch run fills this many frames or a multiple of it: the
        # mesh's batch axis (1 without a mesh).
        self.batch_multiple = 1
        if mesh is not None:
            if mesh.spans_processes:
                raise NotImplementedError(
                    "StreamingEstimator over a mesh of several processes: "
                    "each batch is fetched whole to this process's host, "
                    "and the frames of another process's batch rows never "
                    "reach it (the JAX package's stream fetches each batch "
                    "with np.asarray, which refuses an array spanning "
                    "another process's devices); stream a one-process mesh "
                    "in each process instead")
            from .parallel.mesh import BATCH_AXIS
            n_batch = self.batch_multiple = mesh.shape[BATCH_AXIS]
            self.batch = -(-max(batch, n_batch) // n_batch) * n_batch
            self.device = mesh.devices[0][0]
            if pyramid_levels > 0:
                from .parallel.pyramid_sharded import \
                    make_pyramid_sharded_estimate
                self._sharded = make_pyramid_sharded_estimate(
                    mesh, max_disparity=max_disparity, levels=pyramid_levels,
                    band_radius=band_radius, cost_dtype=dtype,
                    penalty1=penalty1, penalty2=penalty2, sgm_mode=sgm_mode,
                    overlap=overlap, backend=backend, subpixel=subpixel,
                    median=pyramid_median, speckle=speckle,
                    speckle_fill=speckle_fill)
            else:
                from .parallel.sharded import make_sharded_estimate
                self._sharded = make_sharded_estimate(
                    mesh, max_disparity=max_disparity, cost=cost,
                    kernel_size=kernel_size, cost_dtype=dtype,
                    census_window=census_window,
                    census_height=census_height, aggregation=aggregation,
                    reducer=reducer, penalty1=penalty1, penalty2=penalty2,
                    adaptive_p2=adaptive_p2,
                    cvf_radius=cvf_radius, cvf_eps=cvf_eps,
                    sgm_mode=sgm_mode, overlap=overlap, backend=backend,
                    lr_max_diff=lr_max_diff, speckle=speckle,
                    speckle_fill=speckle_fill,
                    **{k: v for k, v in refine.items() if k != "max_diff"})
        else:
            self.batch = batch
            self.device = torch.device(device)
            if pyramid_levels > 0:
                from .pyramid import PyramidPipeline
                self._pyramid = PyramidPipeline(
                    max_disparity, levels=pyramid_levels,
                    band_radius=band_radius, median=pyramid_median,
                    penalty1=penalty1, penalty2=penalty2, cost_dtype=dtype,
                    backend=backend, device=self.device)
                self._subpixel = subpixel
            else:
                self._pipeline = create_pipeline(
                    cost, _REGISTRY_REDUCERS[reducer], aggregation,
                    max_disparity=max_disparity, penalty1=penalty1,
                    penalty2=penalty2, cvf_radius=cvf_radius,
                    cvf_eps=cvf_eps, census_window=census_window,
                    backend=backend,
                    volume_dtype=validation.dtype_name(dtype),
                    device=self.device, kernel_size=kernel_size,
                    census_height=census_height, adaptive_p2=adaptive_p2)
                post = (median or subpixel or lr_check or weighted_median
                        or fgs_lambda is not None)
                self._refine = refine if post else None
                if not post and not speckle and backend != "torch":
                    self._compiled = self._pipeline.compiled()
        if self.device.type == "cuda" and stream is None:
            stream = torch.cuda.Stream(self.device)
        self._stream = stream if self.device.type == "cuda" else None
        # (batch shape, dtype) -> [ring of depth + 1 staging buffers,
        # next position].
        self._rings: Dict[tuple, list] = {}
        # (first slot, end slot, frames) of the stage stamps of the batch
        # last dispatched (utils/profiling.py).
        self._stamp_spans: List[Tuple[int, int, int]] = []
        self.stats = StreamStats()

    # -- one batch ------------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _stage(self, lefts, rights, pad: int = 0, batch=None):
        """The batch on the device, in its storage dtype: host frames go
        through the next pinned staging buffer (waiting for the copy that
        last read it), tensors are moved as they are."""
        if isinstance(lefts, torch.Tensor):
            with profiling.annotate("stm/stream/upload", batch):
                left = lefts.to(self.device, non_blocking=True)
                right = rights.to(self.device, non_blocking=True)
            if left.is_cuda:
                self._count_ops((left is not lefts) + (right is not rights))
            return left, right
        t = time.perf_counter()
        with profiling.annotate("stm/stream/stage", batch):
            left, right, slot = self._fill(lefts, rights, pad)
        self.stats.stage_s += time.perf_counter() - t
        with profiling.annotate("stm/stream/upload", batch):
            if slot is None:
                return left, right
            left = left.to(self.device, non_blocking=True)
            right = right.to(self.device, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        self._count_ops(2)
        return left, right

    def _fill(self, lefts, rights, pad: int):
        """The batch on the host, (left, right, staging buffer): the next
        pinned staging buffer of its shape, filled once the copy that last
        read it has completed; on the CPU, stacks and no buffer."""
        if self._stream is None:
            left = np.stack(list(lefts) + [lefts[-1]] * pad)
            right = np.stack(list(rights) + [rights[-1]] * pad)
            return torch.from_numpy(left), torch.from_numpy(right), None
        first = np.asarray(lefts[0])
        shape = (len(lefts) + pad,) + first.shape
        dtype = torch.from_numpy(first[:0]).dtype
        ring = self._rings.get((shape, dtype))
        if ring is None:
            ring = self._rings[shape, dtype] = [
                [_Staging(shape, dtype) for _ in range(self.depth + 1)], 0]
        slots, pos = ring
        slot = slots[pos]
        ring[1] = (pos + 1) % len(slots)
        if slot.event is not None:
            slot.event.synchronize()       # its last copy has read it
        for host, frames in ((slot.left.numpy(), lefts),
                             (slot.right.numpy(), rights)):
            for i, frame in enumerate(frames):
                host[i] = frame
            host[len(frames):] = host[len(frames) - 1]
        return slot.left, slot.right, slot

    def _count_ops(self, n: int) -> None:
        """``n`` device operations enqueued on the card."""
        if self.stats.device_ops is not None:
            self.stats.device_ops += n

    def _frame(self, left: torch.Tensor, right: torch.Tensor
               ) -> torch.Tensor:
        """One eager frame (post-processed, pyramid or plain)."""
        if self._pyramid is not None:
            disp = self._pyramid._estimate(left, right, self._subpixel)
        else:
            if self._refine is not None:
                disp = self._pipeline.estimate_refined(left, right,
                                                       **self._refine)
            else:
                disp = self._pipeline.estimate(left, right)
            if self._speckle_fill is not None:
                disp = disp.to(torch.float32)
        if self._speckle_fill is not None:
            from .ops.refine import filter_speckles
            disp = filter_speckles(disp, fill=self._speckle_fill)
        return disp

    def _run_batch(self, left: torch.Tensor, right: torch.Tensor
                   ) -> torch.Tensor:
        wide = left.to(torch.float32), right.to(torch.float32)
        if left.is_cuda:
            self._count_ops((wide[0] is not left) + (wide[1] is not right))
        left, right = wide
        if self._sharded is not None:
            counted = collections.Counter(_build.LAUNCHES)
            mark = self._stamp_mark()
            out = self._sharded(left, right)
            self.stats.launches.update(collections.Counter(_build.LAUNCHES)
                                       - counted)
            self.stats.device_ops = None
            self._note_stamps(mark, left.shape[0])
            self.stats.frames_run += left.shape[0]
            return out
        # The graph's frames are int32 (no post-processing): each replay's
        # static output is copied into its slot before the next replay.
        out = (torch.empty(left.shape, dtype=torch.int32, device=left.device)
               if self._compiled is not None else None)
        replays = out is not None and left.is_cuda
        outs = []
        key = (tuple(left.shape[1:]), left.dtype, left.device)
        for i in range(left.shape[0]):
            mark = self._stamp_mark()
            if replays:
                # A replay launches what the capture recorded, uncounted.
                ops = self._compiled.device_ops
                self._compiled(left[i], right[i], out=out[i])
                self.stats.launches.update(self._compiled.graphs[key].launches)
                self._count_ops(self._compiled.device_ops - ops)
            else:
                counted = collections.Counter(_build.LAUNCHES)
                if out is not None:
                    self._compiled(left[i], right[i], out=out[i])
                else:
                    outs.append(self._frame(left[i], right[i]))
                self.stats.launches.update(
                    collections.Counter(_build.LAUNCHES) - counted)
                self.stats.device_ops = None
            self._note_stamps(mark, 1)
            self.stats.frames_run += 1
        return out if out is not None else torch.stack(outs)

    def _stamp_mark(self) -> int:
        return (profiling.stamp_mark(self.device)
                if self._stream is not None else 0)

    def _note_stamps(self, mark: int, frames: int) -> None:
        """Keep the slots of the stamps that ``frames`` frames launched
        since ``mark``, for the batch's fetch to read."""
        end = self._stamp_mark()
        if end != mark:
            self._stamp_spans.append((mark, end, frames))

    def _dispatch(self, lefts, rights, pad: int = 0,
                  batch=None) -> torch.Tensor:
        self._stamp_spans = []
        with self._on_stream():
            left, right = self._stage(lefts, rights, pad, batch)
            with profiling.annotate("stm/stream/frames", batch):
                return self._run_batch(left, right)

    def estimate_batch(self, left, right) -> torch.Tensor:
        """[B, H, W] pair stacks (numpy, uint8 or float, or tensors) ->
        [B, H, W] disparities on the device (int32; float32 after
        sub-pixel, the smoother or a background speckle fill).  Returns
        once the batch is enqueued on the estimator's stream; reading
        the result from another stream needs that stream to wait on it
        (``host_array`` and ``.cpu()`` on the same thread are safe)."""
        if not isinstance(left, torch.Tensor):
            left, right = np.asarray(left), np.asarray(right)
        out = self._dispatch(left, right)
        if self._stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._stream)
            out.record_stream(current)
        return out

    def _fetch_async(self, out: torch.Tensor, batch=None):
        """Narrow ``out`` and start its copy to pinned host memory; returns
        (host tensor, event after the copy) (the event None on the CPU)."""
        with self._on_stream(), profiling.annotate("stm/stream/fetch",
                                                   batch):
            narrow = narrow_for_fetch(out, self.max_disparity)
            if self._stream is None:
                return narrow, None
            host = torch.empty(narrow.shape, dtype=narrow.dtype,
                               pin_memory=True)
            host.copy_(narrow, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._count_ops((narrow is not out) + 1)
        return host, event

    def _fetch_wait(self, host: torch.Tensor, event, batch,
                    spans: List[Tuple[int, int, int]]) -> _Fetched:
        """On a fetch thread: wait for the batch's event, widen its
        disparities on the host, and read its stamps."""
        with profiling.annotate("stm/stream/sync", batch):
            if event is not None:
                event.synchronize()
            synced = time.perf_counter()
            disparities = _widen_host(host.numpy())
        return _Fetched(disparities, synced,
                        self._read_stamps(spans) if spans else None)

    def _read_stamps(self, spans: List[Tuple[int, int, int]]
                     ) -> Tuple[Dict[str, float], int, int]:
        """(stage seconds, frames stamped, stamps) of a batch whose stamps
        have all run: ``spans`` holds (first slot, end slot, frames)."""
        ring = profiling.stamp_ring(self.device)
        total = dict.fromkeys(profiling.STAGE_KEYS.values(), 0.0)
        frames = stamps = 0
        for first, end, weight in spans:
            stamps += end - first
            rows = ring.read(first, end)
            if rows is None:
                continue
            seconds, complete = profiling.stage_seconds(rows)
            if complete:
                frames += weight
                for k, v in seconds.items():
                    total[k] = total.get(k, 0.0) + v
        return total, frames, stamps

    # -- the stream -----------------------------------------------------

    def run(self, capture, max_frames: Optional[int] = None
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Drive a capture (``read_next()`` protocol) to its end.

        Yields (gray_left [H, W], disparity [H, W] int32, or float32
        after sub-pixel, the smoother or a background speckle fill) per
        frame, in order, with up to ``depth`` batches in flight.  The
        last batch is padded by repeating its last frame, and the padding
        cut.  Abandoning the generator (``close()``, or dropping it)
        cancels the queued fetches, waits for the running one and joins
        the fetch threads.  The finished run's ``stats`` are left in
        ``LAST_STATS`` too.
        """
        global LAST_STATS
        self.stats = StreamStats()
        self.stats._start = time.perf_counter()
        fetcher = ThreadPoolExecutor(
            max_workers=min(self.fetch_workers, self.depth),
            thread_name_prefix="stm-fetch")
        try:
            yield from self._run_loop(capture, max_frames, fetcher)
        finally:
            fetcher.shutdown(wait=True, cancel_futures=True)
            self.stats.seconds = time.perf_counter() - self.stats._start
            LAST_STATS = self.stats

    def _run_loop(self, capture, max_frames, fetcher):
        # No span stays open across a yield: the consumer's time between
        # two frames is its own.
        pending = collections.deque()
        lefts_buf: List[np.ndarray] = []
        rights_buf: List[np.ndarray] = []
        done = False
        while not done:
            batch = self.stats.batches
            t = time.perf_counter()
            with profiling.annotate("stm/stream/read", batch):
                ok, img = capture.read_next()
                if ok:
                    gray = img if not hasattr(img, "to_grayscale") else \
                        img.to_grayscale()
                    lefts_buf.append(np.asarray(gray.left))
                    rights_buf.append(np.asarray(gray.right))
                    self.stats.frames += 1
                    if (max_frames is not None
                            and self.stats.frames >= max_frames):
                        done = True
                else:
                    done = True
            self.stats.decode_s += time.perf_counter() - t

            if len(lefts_buf) == self.batch or (done and lefts_buf):
                n = len(lefts_buf)
                t = time.perf_counter()
                out = self._dispatch(lefts_buf, rights_buf,
                                     pad=self.batch - n, batch=batch)
                host, event = self._fetch_async(
                    out[:n] if n < self.batch else out, batch)
                self.stats.dispatch_s += time.perf_counter() - t
                pending.append((lefts_buf, batch, fetcher.submit(
                    self._fetch_wait, host, event, batch,
                    self._stamp_spans)))
                self.stats.batches += 1
                lefts_buf, rights_buf = [], []
                # At most ``depth`` batches in flight; the stats count
                # only the time spent blocked on the oldest.
                while len(pending) >= self.depth:
                    yield from self._drain_one(pending)
        while pending:
            yield from self._drain_one(pending)

    def _drain_one(self, pending):
        ready_lefts, batch, fut = pending.popleft()
        t = time.perf_counter()
        with profiling.annotate("stm/stream/wait", batch):
            fetched = fut.result()
            held = time.perf_counter()
        stats = self.stats
        stats.fetch_s += held - t
        stats.handoff_s += max(held - max(fetched.synced, t), 0.0)
        if fetched.stamps is not None:
            seconds, frames, stamps = fetched.stamps
            for k, v in seconds.items():
                stats.stage_device_s[k] = (stats.stage_device_s.get(k, 0.0)
                                           + v)
            stats.frames_stamped += frames
            stats.stamps += stamps
        for i, disp in enumerate(fetched.disparities):
            yield ready_lefts[i], disp
