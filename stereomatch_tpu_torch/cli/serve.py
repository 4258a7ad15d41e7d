#!/usr/bin/env python
"""stm-serve: HTTP disparity service, the port's counterpart of
``stereomatch_tpu/cli/serve.py`` with its protocol and flags:

    python -m stereomatch_tpu_torch.cli.serve 128 -cm ssd -am sgm \
        --batch 8 --warmup 375x450

One pipeline is configured at startup as ``stm-image`` configures it
(``-cm/-am/-dm``, penalties, backend, dtype, ``--pyramid``); it runs on
the card (``--device cuda``, the default) or on the CPU (``--device
cpu``).

* ``POST /estimate``: the body is one side-by-side stereo image
  (left|right halves): a PNG (decoded by the port's codec, ``io/png``,
  as PIL's ``convert("L")``), a binary PGM/PPM, a raw ``.npy`` [H, 2W]
  grayscale array, or another format PIL reads, where PIL is installed
  (without it such a body answers 400 saying so).  Query:
  ``format=png16|png|pfm|npy`` (default ``png16``: 16-bit gray
  disparities; ``png``: the rainbow colour map; ``npy``: the smallest
  lossless dtype, uint8/uint16 for integer disparities, float32 when
  refined or speckle-filled), ``refine=1`` (median + sub-pixel),
  ``speckle=1`` (speckle filtering, background fill).  Client faults
  answer 400, server faults 500.
* ``GET /healthz``: JSON: status, the configuration, frames served, the
  latency and decode/compute/encode stage windows, and with batching the
  batcher's counters.

Device work is serialised: every frame is enqueued under one lock on one
CUDA stream, and each batch's copy to the host is enqueued right after
its frames, so a later replay of a ``Pipeline.compiled()`` graph cannot
overwrite a static output an earlier batch has not copied out; the
threads that wait for the copies wait concurrently.  Frames run as
``stream.StreamingEstimator`` runs them (the flat paths without
post-processing replay one CUDA graph a geometry).  ``--batch N``
coalesces concurrent requests of one (geometry, dtype, refine, speckle)
key, waiting at most ``--linger-ms`` for company, into batches of
powers of two (5 requests run as 4 + 1), which ``--warmup HxW``
prepares up front; ``--dispatch-workers`` threads carry batches through
their round trips and ``--pipeline-depth 1`` makes the batcher
synchronous.  ``--mesh`` serves over the ``stm-video --mesh`` mesh
(every visible card, or ``cli_common.MESH_CPU_DEVICES`` CPU devices
with ``--device cpu``): one sharded estimator per frame geometry, each
batch split over the mesh's batch axis (padded to fill it) and each
frame's rows over its tile axis, on this process's devices under any
launcher's environment (the server starts no process group, as JAX's
starts none).  SIGTERM stops the server cleanly.
"""

import argparse
import io
import json
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PNM_MAGICS = (b"P5", b"P6")


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import (AGGREGATION_METHODS, COST_METHODS,
                              DISPARITY_METHODS, add_census_sgm_options)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("max_disparity", metavar="max-disparity", type=int)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8792)
    parser.add_argument("-cm", "--cost-method", choices=COST_METHODS.keys(),
                        default="census")
    parser.add_argument("-am", "--aggregation-method",
                        choices=AGGREGATION_METHODS.keys(), default="sgm")
    parser.add_argument("-dm", "--disparity-method",
                        choices=DISPARITY_METHODS.keys(), default="wta")
    parser.add_argument("--p1", type=float, default=0.1)
    parser.add_argument("--p2", type=float, default=0.2)
    parser.add_argument("--lr-check", action="store_true",
                        help="Left-right consistency check + background "
                             "occlusion fill on every response.")
    parser.add_argument("--lr-mode", choices=("mirror", "volume"),
                        default="volume",
                        help="Right disparity for --lr-check: 'volume' "
                             "re-indexes the aggregated volume; 'mirror' "
                             "doubles the device work.")
    parser.add_argument("--fgs", type=float, default=None, metavar="LAM",
                        help="Fast-global-smoother post-filter on every "
                             "response (with --lr-check the consistency "
                             "mask weights the data term).")
    parser.add_argument("--fgs-sigma", type=float, default=8.0,
                        help="FGS edge-stop bandwidth in guide gray "
                             "levels (8-bit scale).")
    parser.add_argument("--wmf", action="store_true",
                        help="Guide-weighted median on every response.")
    parser.add_argument("--wmf-sigma", type=float, default=10.0,
                        help="WMF affinity bandwidth in guide gray levels "
                             "(8-bit scale).")
    parser.add_argument("--census-window", type=int, default=5,
                        help="-cm census: code window (odd).")
    add_census_sgm_options(parser)
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="-am cvf: box window half-size.")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="-am cvf: edge-stop regularizer.")
    parser.add_argument("--backend", choices=("auto", "cuda", "torch"),
                        default="auto",
                        help="'cuda' the hand-written kernels, 'torch' the "
                             "plain PyTorch versions, 'auto' a kernel "
                             "where it serves the shape.")
    parser.add_argument("--dtype", choices=("float32", "bfloat16", "auto"),
                        default="float32",
                        help="Cost-volume dtype; 'auto' resolves from the "
                             "--warmup geometry, the aggregation and D by "
                             "cli_common.recommended_dtype (requires "
                             "--warmup).")
    parser.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                        help="Serve the coarse-to-fine pyramid instead of "
                             "the flat pipeline (overrides -cm/-am/-dm).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the pipeline runs: the card (default) "
                             "or the CPU.")
    parser.add_argument("--warmup", default=None, metavar="HxW",
                        help="Run every (refine, speckle) program and every "
                             "batch size for this frame geometry at "
                             "startup (e.g. 375x450).")
    parser.add_argument("--batch", type=int, default=1, metavar="N",
                        help="Coalesce up to N concurrent requests into "
                             "one batch (1 = no batching).")
    parser.add_argument("--dispatch-workers", type=int, default=None,
                        metavar="N",
                        help="Worker threads that each carry one batch "
                             "through its enqueue and result fetch "
                             "(default 16); in-flight frames are bounded "
                             "at max(N, 2*batch).")
    parser.add_argument("--fetch-workers", type=int, default=None,
                        help="Deprecated alias for --dispatch-workers.")
    parser.add_argument("--no-adaptive-batch", dest="adaptive_batch",
                        action="store_false", default=True,
                        help="Disable the automatic micro-batch degrade/"
                             "restore (the batch cap halves while rolling "
                             "queue time per frame exceeds 2x device time "
                             "per frame, and restores as the queue "
                             "drains).")
    parser.add_argument("--linger-ms", type=float, default=5.0,
                        help="With --batch > 1: how long a request waits "
                             "for companions before running short.")
    parser.add_argument("--mesh", action="store_true",
                        help="Serve over the device mesh: batches split "
                             "across the mesh batch axis and image rows "
                             "over the tile axis (the stm-video --mesh "
                             "program behind the HTTP face).")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        metavar="N",
                        help="1 = synchronous batcher (gather, enqueue, "
                             "fetch one batch at a time); > 1 (default) = "
                             "concurrent batches via the "
                             "--dispatch-workers pool.")
    parser.add_argument("--request-timeout-s", type=float, default=600.0,
                        help="How long a request waits on the device "
                             "before failing with 500.")
    return parser


def _encode(disparity, fmt: str, max_disparity: int):
    """disparity [H, W] -> (bytes, content_type)."""
    disparity = np.asarray(disparity)
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, disparity)
        return buf.getvalue(), "application/octet-stream"
    if fmt == "pfm":
        from ..io.data import write_pfm
        buf = io.BytesIO()
        write_pfm(buf, np.asarray(disparity, np.float32))
        return buf.getvalue(), "application/octet-stream"
    from ..io import png
    if fmt == "png":
        from ..utils.viz import colorize_disparity
        return (png.encode(colorize_disparity(disparity, max_disparity)),
                "image/png")
    if fmt == "png16":
        d16 = np.clip(np.round(np.asarray(disparity, np.float64)),
                      0, 65535).astype(np.uint16)
        return png.encode(d16), "image/png"
    raise ValueError(f"unknown format {fmt!r}")


def _decode_gray(body: bytes) -> np.ndarray:
    """A request body -> [H, 2W] gray frame, uint8 for images (kept
    narrow across the upload; the frame widens on the device)."""
    if body[:6] == b"\x93NUMPY":
        gray = np.load(io.BytesIO(body), allow_pickle=False)
        if gray.ndim != 2:
            raise ValueError(f"npy body must be [H, 2W] grayscale, got "
                             f"shape {gray.shape}")
        return gray
    if body[:8] == b"\x89PNG\r\n\x1a\n":
        from ..io import png
        return png.convert(png.decode(body), "L")
    if body[:2] in PNM_MAGICS:
        from ..io.data import read_pnm, rgb_to_grayscale_u8
        img = read_pnm(io.BytesIO(body))
        return rgb_to_grayscale_u8(img) if img.ndim == 3 else img
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("this body is not PNG, PGM/PPM or .npy, and other "
                         "image formats need PIL, which is not "
                         "installed") from None
    return np.asarray(Image.open(io.BytesIO(body)).convert("L"), np.uint8)


class _Job:
    """One request waiting inside the batcher."""

    __slots__ = ("left", "right", "refine", "speckle", "t0", "done",
                 "result", "error")

    def __init__(self, left, right, refine, speckle):
        self.left, self.right = left, right
        self.refine, self.speckle = refine, speckle
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error = None

    @property
    def key(self):
        # dtype is part of the key: npy requests may carry float frames
        # and must not stack with (and promote) a uint8 batch.
        return (self.left.shape, str(self.left.dtype),
                self.refine, self.speckle)


class _Engine:
    """The device side: one frame estimator per (refine, speckle) key (and
    per frame geometry with ``--mesh``, whose row tiles follow the
    height), built once, every one on one CUDA stream, enqueued under
    one lock.

    ``enqueue`` stages a batch, enqueues its frames, narrows the result
    and enqueues its copy to pinned host memory, all under ``lock``;
    ``wait`` then waits for that copy's event (outside the lock, so the
    waits of concurrent batches overlap).  Results stay narrow (uint8 /
    uint16 integer disparities), as the responses carry them.
    """

    def __init__(self, args):
        import torch
        self.args = args
        self.fns = {}                     # key -> estimator
        self.lock = threading.Lock()      # enqueueing device work
        self._build_lock = threading.Lock()
        self.device = torch.device(args.device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def estimator(self, job):
        """The estimator of a job's key; with ``--mesh`` every chunk it
        runs fills its ``batch_multiple`` (the mesh's batch axis)."""
        key = job.key if self.args.mesh else (job.refine, job.speckle)
        with self._build_lock:
            if key not in self.fns:
                self.fns[key] = self._build(job)
            return self.fns[key]

    def _build(self, job):
        from ..cli_common import STREAM_REDUCERS, mesh_devices
        from ..stream import StreamingEstimator
        a = self.args
        refine, speckle = job.refine, job.speckle
        placement = dict(batch=1, device=self.device)
        if a.mesh:
            from .video import _pick_video_mesh
            placement = dict(batch=max(a.batch, 1), mesh=_pick_video_mesh(
                job.left.shape[0], 2 ** a.pyramid, mesh_devices(a.device)))
        return StreamingEstimator(
            a.max_disparity, cost=a.cost_method,
            cost_dtype=a.dtype, census_window=a.census_window,
            census_height=a.census_height, adaptive_p2=not a.constant_p2,
            aggregation=a.aggregation_method,
            reducer=STREAM_REDUCERS[a.disparity_method],
            penalty1=a.p1, penalty2=a.p2, cvf_radius=a.cvf_radius,
            cvf_eps=a.cvf_eps, backend=a.backend,
            pyramid_levels=a.pyramid, median=refine,
            subpixel=refine, lr_check=a.lr_check,
            lr_mode=a.lr_mode, weighted_median=a.wmf,
            wmf_sigma=a.wmf_sigma, fgs_lambda=a.fgs,
            fgs_sigma=a.fgs_sigma, speckle=speckle,
            speckle_fill="background", stream=self.stream,
            **placement)

    @staticmethod
    def enqueue_locked(est, lefts, rights, pad: int = 0):
        """Under the lock: the batch's frames (``pad`` copies of the last
        one after them, to fill a mesh's batch axis) and the fetch of the
        real frames' results enqueued."""
        out = est._dispatch(lefts, rights, pad)
        return est._fetch_async(out[:len(lefts)] if pad else out)

    @staticmethod
    def wait(host, event) -> np.ndarray:
        if event is not None:
            event.synchronize()
        return host.numpy()


class _Batcher:
    """Coalesces concurrent requests into batches (the JAX module's
    ``_Batcher``, same gather, linger, adaptive cap and pools).

    One gatherer thread takes the oldest pending request and waits until
    ``linger`` seconds past its arrival for more requests with the same
    (geometry, dtype, refine, speckle) key; requests with another key
    park and lead later batches.  A batch runs as power-of-two chunks
    (5 -> 4 + 1), each frame as the stream runs it, so a geometry needs
    one CUDA graph whatever the chunk and the chunk sizes bound only the
    staging buffers.  With ``--pipeline-depth`` > 1 formed batches go to
    ``--dispatch-workers`` threads, each carrying one batch through its
    enqueue (under the engine's lock) and its fetch wait (concurrent);
    in-flight frames are bounded at max(workers, 2 * batch).  While the
    effective batch is 1 or 2 a request is served directly from its
    handler thread, through a pooled future bounded by the request
    timeout.  ``close`` stops and joins every thread the batcher
    started.
    """

    def __init__(self, args, engine: _Engine):
        self.args = args
        self.engine = engine
        self.max_batch = max(args.batch, 1)
        self.linger = max(args.linger_ms, 0.0) / 1e3
        self.queue = queue.SimpleQueue()
        self.batches = 0
        self.batched_frames = 0
        self.padded_frames = 0           # frames added to fill a mesh
        self.device_s = 0.0              # enqueue -> host-result seconds
        self.queue_s = 0.0               # request arrival -> enqueue
        self.eff_batch = self.max_batch
        self.adaptive = bool(getattr(args, "adaptive_batch", True))
        self._direct_pool = None         # lazy: fetch-with-timeout pool
        self._q_ema = None               # rolling queue s/frame
        self._d_ema = None               # rolling device s/frame
        self._adapt_n = 0
        self._stats_lock = threading.Lock()
        self.inflight = 0                # batches inside enqueue->fetch
        self.depth = max(getattr(args, "pipeline_depth", 1), 1)
        self._threads = []
        if self.depth > 1:
            workers = getattr(args, "dispatch_workers", None)
            if workers is None:
                workers = getattr(args, "fetch_workers", None)  # alias
            self.workers = max(1, workers if workers is not None else 16)
            self.frame_cap = max(self.workers, 2 * self.max_batch)
            self._inflight_frames = 0
            self._cap_cv = threading.Condition()
            self._dispatch_q = queue.Queue(maxsize=1)
            for i in range(self.workers):
                self._start(self._dispatch_loop, f"stm-serve-dispatch-{i}")
        else:
            self.workers = 0
        self._start(self._loop, "stm-serve-batcher")

    @property
    def _fns(self):
        return self.engine.fns

    def _start(self, target, name):
        thread = threading.Thread(target=target, daemon=True, name=name)
        thread.start()
        self._threads.append(thread)

    def estimate(self, left, right, refine: bool, speckle: bool = False):
        job = _Job(left, right, refine, speckle)
        if self.eff_batch <= 2 and not self.args.mesh:
            return self._estimate_direct(job)
        self.queue.put(job)
        if not job.done.wait(timeout=self.args.request_timeout_s):
            # The worker may still complete the job later; this request
            # stops waiting (a hung device must not pile up handlers).
            raise RuntimeError(
                f"device work did not complete within "
                f"{self.args.request_timeout_s:g}s")
        if job.error is not None:
            raise job.error
        return job.result

    def _estimate_direct(self, job):
        """Batches of one or two gain nothing from the gather funnel: the
        request is served from its handler thread, its whole round trip
        in a pooled future bounded by the request timeout."""
        t0 = job.t0
        deadline = t0 + self.args.request_timeout_s
        with self._stats_lock:
            if self._direct_pool is None:
                self._direct_pool = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="stm-serve-direct")

        def run_direct():
            est = self._fn(job)
            lock = self.engine.lock
            if not lock.acquire(timeout=max(deadline - time.monotonic(),
                                            0.0)):
                raise RuntimeError(
                    f"device work did not complete within "
                    f"{self.args.request_timeout_s:g}s")
            try:
                now = time.monotonic()
                with self._stats_lock:
                    self.queue_s += now - t0
                host, event = self.engine.enqueue_locked(
                    est, [job.left], [job.right])
            finally:
                lock.release()
            return now, self.engine.wait(host, event)[0]

        fut = self._direct_pool.submit(run_direct)
        try:
            now, host = fut.result(
                timeout=max(deadline - time.monotonic(), 0.0))
        except FutureTimeout:
            raise RuntimeError(
                f"device work did not complete within "
                f"{self.args.request_timeout_s:g}s") from None
        batch_device_s = time.monotonic() - now
        with self._stats_lock:
            self.device_s += batch_device_s
            self.batches += 1
            self.batched_frames += 1
        self._adapt(1, now - t0, batch_device_s)
        return host

    def warmup(self, left, right, refine: bool = False,
               speckle: bool = False):
        """Run every power-of-two chunk size for one (geometry, flags) key
        with synthetic groups (bypassing the queue; stats restored)."""
        batches, frames = self.batches, self.batched_frames
        b = 1
        while b <= self.max_batch:
            group = [_Job(left, right, refine, speckle) for _ in range(b)]
            self._run(group)
            for job in group:
                if job.error is not None:
                    raise job.error
            b *= 2
        self.batches, self.batched_frames = batches, frames
        # Warm-up batches carry build and capture time: keep them out of
        # the adaptive EMAs.
        self._q_ema = None
        self._d_ema = None
        self._adapt_n = 0

    # -- worker side ----------------------------------------------------

    def _fn(self, job):
        """The frame estimator of one job's key."""
        return self.engine.estimator(job)

    @staticmethod
    def _chunk_sizes(n: int, cap: int, multiple: int = 1):
        """Decompose a group of n into power-of-two batch sizes (times the
        mesh's batch ``multiple``) up to ``cap``, largest first: no frame
        is padded but the last chunk's, to fill a mesh's batch axis."""
        sizes = []
        while n > 0:
            if n < multiple:
                sizes.append(multiple)           # the ragged mesh pad
                break
            b = multiple
            while b * 2 <= min(n, cap):
                b *= 2
            sizes.append(b)
            n -= b
        return sizes

    def _dispatch(self, group):
        """Enqueue the group's chunks and their fetches under the
        engine's lock; returns without waiting for the device."""
        now = time.monotonic()
        batch_queue_s = sum(now - j.t0 for j in group)
        with self._stats_lock:
            self.queue_s += batch_queue_s
        est = self._fn(group[0])
        fetches = []
        i = 0
        with self.engine.lock:
            for size in self._chunk_sizes(len(group), self.max_batch,
                                          est.batch_multiple):
                chunk = group[i:i + size]
                i += size
                pad = size - len(chunk)
                with self._stats_lock:
                    self.padded_frames += pad
                fetches.append(self.engine.enqueue_locked(
                    est, [j.left for j in chunk], [j.right for j in chunk],
                    pad))
        return now, batch_queue_s, fetches

    def _finish(self, group, out):
        """Wait for the batch's host copies and release its requests."""
        try:
            if isinstance(out, Exception):
                raise out
            t_disp, batch_queue_s, fetches = out
            host = np.concatenate([self.engine.wait(h, e)
                                   for h, e in fetches])
            batch_device_s = time.monotonic() - t_disp
            with self._stats_lock:
                self.device_s += batch_device_s
            self._adapt(len(group), batch_queue_s, batch_device_s)
            for job, disp in zip(group, host):
                job.result = disp
        except Exception as exc:                  # noqa: BLE001 — fan out
            for job in group:
                job.error = exc
        finally:
            with self._stats_lock:
                self.batches += 1
                self.batched_frames += len(group)
            for job in group:
                job.done.set()

    def _adapt(self, n_frames, batch_queue_s, batch_device_s):
        """Halve the effective cap while rolling per-frame queue time
        exceeds 2x device time, restore it (up to ``--batch``) while it
        stays under half; at most once per 8 batches."""
        if not self.adaptive or self.max_batch <= 1 or n_frames <= 0:
            return
        q = batch_queue_s / n_frames
        d = batch_device_s / n_frames
        alpha = 0.25
        with self._stats_lock:
            self._q_ema = q if self._q_ema is None else \
                (1 - alpha) * self._q_ema + alpha * q
            self._d_ema = d if self._d_ema is None else \
                (1 - alpha) * self._d_ema + alpha * d
            self._adapt_n += 1
            if self._adapt_n < 8:
                return
            self._adapt_n = 0
            if self._q_ema > 2.0 * self._d_ema and self.eff_batch > 1:
                self.eff_batch //= 2
            elif (self._q_ema < 0.5 * self._d_ema
                  and self.eff_batch < self.max_batch):
                self.eff_batch = min(self.eff_batch * 2, self.max_batch)

    def _run(self, group):
        """Synchronous enqueue + fetch (warmup and --pipeline-depth 1)."""
        try:
            out = self._dispatch(group)
        except Exception as exc:                  # noqa: BLE001 — fan out
            out = exc
        self._finish(group, out)

    def close(self, timeout: float = 60.0):
        """Stop and join every thread the batcher started."""
        self.queue.put(None)                       # wake the gatherer
        if self.depth > 1:
            for _ in range(self.workers):
                self._dispatch_q.put(None)
        for thread in self._threads:
            thread.join(timeout)
        if self._direct_pool is not None:
            self._direct_pool.shutdown(wait=True, cancel_futures=True)

    def _dispatch_loop(self):
        """One worker = one batch's enqueue and fetch at a time."""
        while True:
            group = self._dispatch_q.get()
            if group is None:                      # close() sentinel
                return
            n = len(group)
            with self._cap_cv:
                # Frame-based backpressure; a group alone always passes.
                while (self._inflight_frames
                       and self._inflight_frames + n > self.frame_cap):
                    self._cap_cv.wait()
                self._inflight_frames += n
            with self._stats_lock:
                self.inflight += 1
            try:
                try:
                    out = self._dispatch(group)
                except Exception as exc:          # noqa: BLE001 — fan out
                    out = exc
                self._finish(group, out)
            finally:
                with self._stats_lock:
                    self.inflight -= 1
                with self._cap_cv:
                    self._inflight_frames -= n
                    self._cap_cv.notify_all()

    def _gather(self, parked):
        """Form the next batch: the oldest request leads; same-key
        requests join until its linger deadline (then the queue is still
        drained without blocking); others park."""
        job = parked.pop(0) if parked else self.queue.get()
        if job is None:                            # close() sentinel
            return None
        key = job.key
        group = [job]
        deadline = job.t0 + self.linger
        while len(group) < self.eff_batch:
            i = next((k for k, p in enumerate(parked)
                      if p.key == key), None)
            if i is not None:
                group.append(parked.pop(i))
                continue
            remaining = deadline - time.monotonic()
            try:
                nxt = (self.queue.get_nowait() if remaining <= 0
                       else self.queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:                        # close() sentinel:
                self.queue.put(None)               # re-post for _loop
                break
            if nxt.key == key:
                group.append(nxt)
            else:
                parked.append(nxt)
        return group

    def _loop(self):
        parked = []
        while True:
            group = self._gather(parked)
            if group is None:                      # close() sentinel
                for job in parked:
                    job.error = RuntimeError("the server is closing")
                    job.done.set()
                return
            if self.depth <= 1:
                self._run(group)
                continue
            self._dispatch_q.put(group)


class _State:
    """The engine and counters shared across handler threads.  Unbatched:
    each request's frame is enqueued under the engine's lock and its
    fetch waited for outside it; batched: through the ``_Batcher``."""

    def __init__(self, args):
        self.args = args
        self.engine = _Engine(args)
        self.batcher = _Batcher(args, self.engine) if args.batch > 1 \
            else None
        self.frames = 0
        self.lock = threading.Lock()
        self._latencies = []            # rolling window, seconds
        self._stages = {}               # stage name -> rolling seconds

    def record_latency(self, seconds: float, keep: int = 512):
        with self.lock:
            self._latencies.append(seconds)
            if len(self._latencies) > keep:
                del self._latencies[:-keep]

    def record_stage(self, name: str, seconds: float, keep: int = 512):
        """Per-request stage split (decode / compute / encode)."""
        with self.lock:
            window = self._stages.setdefault(name, [])
            window.append(seconds)
            if len(window) > keep:
                del window[:-keep]

    def latency_stats(self):
        with self.lock:
            lat = sorted(self._latencies)
        if not lat:
            return None
        return {"window": len(lat),
                "p50_ms": round(lat[len(lat) // 2] * 1e3, 1),
                "p95_ms": round(lat[int(len(lat) * 0.95)] * 1e3, 1)}

    def stage_stats(self):
        with self.lock:
            snap = {k: sorted(v) for k, v in self._stages.items() if v}
        return {k: {"p50_ms": round(v[len(v) // 2] * 1e3, 2),
                    "p95_ms": round(v[int(len(v) * 0.95)] * 1e3, 2)}
                for k, v in snap.items()} or None

    def estimate(self, left, right, refine: bool, speckle: bool = False,
                 count: bool = True):
        """One frame's disparity on the host, narrow (uint8/uint16) for
        integer disparities."""
        if self.batcher is not None:
            out = self.batcher.estimate(left, right, refine, speckle)
        else:
            est = self.engine.estimator(_Job(left, right, refine, speckle))
            with self.engine.lock:
                host, event = self.engine.enqueue_locked(
                    est, [left], [right], est.batch_multiple - 1)
            out = self.engine.wait(host, event)[0]
        if count:
            with self.lock:
                self.frames += 1
        return out

    def close(self):
        if self.batcher is not None:
            self.batcher.close()


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *hargs):        # quiet by default
            pass

        def _reply(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                self._reply(404, b'{"error": "not found"}')
                return
            a = state.args
            info = {"status": "ok", "frames_served": state.frames,
                    "max_disparity": a.max_disparity,
                    "config": (f"pyramid{a.pyramid}" if a.pyramid
                               else "-".join(filter(None, [
                                   a.cost_method, a.disparity_method,
                                   a.aggregation_method]))),
                    "dtype": a.dtype, "backend": a.backend}
            if state.batcher is not None:
                b = state.batcher
                info["batching"] = {
                    "max_batch": b.max_batch,
                    "linger_ms": a.linger_ms,
                    "mesh": a.mesh,
                    "batches": b.batches,
                    "batched_frames": b.batched_frames,
                    "padded_frames": b.padded_frames,
                    "effective_batch": b.eff_batch,
                    "dispatch_workers": b.workers,
                    "in_flight_dispatches": b.inflight,
                    "device_ms_per_frame": round(
                        b.device_s / max(b.batched_frames, 1) * 1e3, 2),
                    "queue_ms_per_frame": round(
                        b.queue_s / max(b.batched_frames, 1) * 1e3, 2),
                }
            stats = state.latency_stats()
            if stats is not None:
                info["latency"] = stats
            stages = state.stage_stats()
            if stages is not None:
                info["stages"] = stages
            self._reply(200, json.dumps(info).encode())

        # Drop handlers whose socket stalls instead of blocking forever.
        timeout = 30
        _MAX_BODY = 64 * 1024 * 1024     # generous for any stereo frame

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path != "/estimate":
                self._reply(404, b'{"error": "not found"}')
                return
            q = parse_qs(url.query)
            fmt = q.get("format", ["png16"])[0]
            refine = q.get("refine", ["0"])[0] in ("1", "true")
            speckle = q.get("speckle", ["0"])[0] in ("1", "true")

            # Client-fault stages -> 400; anything past decode is a server
            # fault -> 500 (a dead device must not look like bad clients).
            t_start = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= self._MAX_BODY:
                    raise ValueError(
                        f"Content-Length must be in (0, {self._MAX_BODY}]")
                if fmt not in ("png16", "png", "pfm", "npy"):
                    raise ValueError(f"unknown format {fmt!r}")
                from ..io.capture import split_side_by_side
                gray = _decode_gray(self.rfile.read(length))
                pair = split_side_by_side(gray)
                left = np.ascontiguousarray(pair.left)
                right = np.ascontiguousarray(pair.right)
                a = state.args
                if a.mesh and a.pyramid:
                    # The sharded pyramid pools 2x2 inside each tile: a
                    # frame it cannot pool is the client's fault.
                    scale = 2 ** a.pyramid
                    h, w = left.shape
                    if h % scale or w % scale:
                        raise ValueError(
                            f"--mesh --pyramid {a.pyramid} needs frame "
                            f"sides divisible by {scale}; got {h}x{w}")
            except Exception as exc:     # noqa: BLE001 — client fault
                self._reply(400, json.dumps({"error": str(exc)}).encode())
                return
            try:
                t0 = time.perf_counter()
                state.record_stage("decode", t0 - t_start)
                disp = state.estimate(left, right, refine, speckle)
                t1 = time.perf_counter()
                state.record_stage("compute", t1 - t0)
                body, ctype = _encode(disp, fmt, state.args.max_disparity)
                state.record_stage("encode", time.perf_counter() - t1)
                state.record_latency(time.perf_counter() - t0)
            except Exception as exc:     # noqa: BLE001 — server fault
                self._reply(500, json.dumps({"error": str(exc)}).encode())
                return
            self._reply(200, body, ctype)

    return Handler


class _Server(ThreadingHTTPServer):
    """``server_close`` joins the handler threads, then closes the
    batcher, which joins its own threads."""
    daemon_threads = False
    block_on_close = True
    stm_state: _State

    def server_close(self):
        super().server_close()
        self.stm_state.close()


def make_server(args) -> ThreadingHTTPServer:
    """Build (but don't run) the server; ``server_port`` reports the bound
    port when ``--port 0`` asked for an ephemeral one, and
    ``server_close`` stops every thread the server started."""
    if args.batch < 1:
        raise ValueError("--batch must be >= 1")
    if args.dtype == "auto":
        if not args.warmup:
            raise ValueError("--dtype auto needs --warmup HxW (the "
                             "frame geometry decides the dtype)")
        from ..cli_common import recommended_dtype
        h, w = (int(v) for v in args.warmup.split("x"))
        args.dtype = recommended_dtype(h, w, args.aggregation_method,
                                       max_disparity=args.max_disparity)
        print(f"--dtype auto resolved to {args.dtype} for {h}x{w} "
              f"{args.aggregation_method} D={args.max_disparity}",
              file=sys.stderr)
    state = _State(args)
    try:
        if args.warmup:
            h, w = (int(v) for v in args.warmup.split("x"))
            # uint8, as live requests upload their decoded frames.
            z = np.zeros((h, w), np.uint8)
            for refine in (False, True):
                for speckle in (False, True):
                    if state.batcher is not None:
                        state.batcher.warmup(z, z, refine=refine,
                                             speckle=speckle)
                    else:
                        state.estimate(z, z, refine=refine, speckle=speckle,
                                       count=False)
        server = _Server((args.host, args.port), _make_handler(state))
    except BaseException:
        state.close()
        raise
    server.stm_state = state            # introspection / test seam
    return server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.wmf and args.pyramid > 0:
        print("--wmf is incompatible with --pyramid (the band stage has "
              "no integer disparity/bin range to median over).",
              file=sys.stderr)
        return 2
    if args.lr_check and args.pyramid > 0:
        print("--lr-check is incompatible with --pyramid (no full cost "
              "volume to re-index).", file=sys.stderr)
        return 2
    if args.fgs is not None and args.pyramid > 0:
        print("--fgs is incompatible with --pyramid (no flat "
              "post-processing stage there).", file=sys.stderr)
        return 2
    from ..cli_common import census_sgm_refusal, start_device
    refusal = census_sgm_refusal(args, "--pyramid") if args.pyramid else None
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    start_device(args.device)
    # Orchestrators stop containers with SIGTERM: treat it like Ctrl-C so
    # in-flight handlers finish and the socket closes cleanly.  The banner
    # tells a supervisor the server is up, so a SIGTERM sent on seeing it
    # must find the handler installed and the try below entered.
    import signal

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    server = make_server(args)
    try:
        print(f"stm-serve listening on http://{args.host}:"
              f"{server.server_port} (D={args.max_disparity})",
              file=sys.stderr, flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
