#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (stereomatch_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``stereomatch_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (teddy 375x450
D=128, 37x53 D=24 and HD 1024x1280 D=256; the SGM chunk kernel on the
row chunks of 5, 2 and 4 tiles, carries included; the DP walk also on
hand-made pointer volumes of those shapes), drives the paths
through the entry points a user calls at the golden teddy scene, each
with the launch counts set to 0 just before it and read just after:

* the main path, SSD -> 8-path SGM -> WTA, against golden ``"wta"``;
* SSD -> SGM -> scanline DP, against golden ``"dp"``;
* census -> guided-filter aggregation (CVF) -> WTA, against
  ``tests/data/golden_torch_cvf_teddy.npz``;
* the row-sharded pipeline, ``parallel.ShardedPipeline`` over 5 row
  tiles on cuda:0: exact carry hand-off with WTA and with DP, and
  overlap mode, against the goldens; then HD over 4 tiles against the
  single-card path (and, with more than one card, one tile per card);
* the post-processing: ``Pipeline.estimate_refined`` over the main path
  (the default stages, the LR check in volume mode, the confidence
  gate) against ``tests/data/golden_torch_refined_teddy.npz``; each
  stage of ``ops/refine.py`` on the card against the same stage on the
  CPU; the sharded median + sub-pixel + speckle path against the
  single-card one;
* ``backend="auto"`` past the kernels' limits (D = 600 through SSD ->
  SGM -> DP: the SSD kernel, then the plain SGM and DP on the card),
  against ``backend="torch"``, with an explicit ``"cuda"`` refused;
* ``python -m stereomatch_tpu_torch.cli.evaluate --synthetic 2`` at
  teddy size on the card, its first scene's metrics against the same
  CLI's on the CPU;
* the Birchfield, ZNCC and SSD-over-textures paths (``FAMILY_PATHS``:
  birchfield|ncc|ssd-texture -> sgm -> wta, birchfield -> sgm -> dyn,
  ncc -> cvf -> wta) at teddy and HD, each equal to ``backend="torch"``
  on the card; at teddy each cost volume equal to the CPU's and each
  path against ``tests/data/golden_torch_costs_teddy.npz``; sharded
  birchfield and ncc -> sgm -> wta (5 tiles at teddy, 4 at HD) against
  the single card; ssd-texture launching the SSD kernel;
* ``python -m stereomatch_tpu_torch.cli.image`` on teddy PNGs written
  by the port's encoder, on the card (the fast guided filter,
  ``-am cvf --cvf-subsample 2``, and ``--pyramid 1`` and ``2`` among its
  runs), its PNGs against the same command run with ``--device cpu``;
* ``Pipeline.compiled()``, a CUDA graph of a frame, on the three main
  paths and FAMILY_PATHS at teddy (float32 and bf16), the three main
  paths at HD and D = 600 under ``backend="auto"``: replay equal to the
  eager frame on two pairs in a row, the captured launch counts equal to
  an eager frame's, eager and replay times, the profiler's view of the
  replay and each graph's memory;
* the plain guided-filter paths (the masked path, ``assume_finite``,
  the fast guided filter at s = 2 and 4): card equal to CPU at teddy in
  float32 and bf16, timed at teddy and HD; the sharded CVF (5 tiles at
  teddy, 4 at HD) equal to the single-card masked path, and at teddy
  against ``tests/data/golden_torch_cvf_teddy.npz``;
* the coarse-to-fine pyramid (``PyramidPipeline`` at levels 1 and 2,
  float32 and bf16) and the video tracker (``TemporalPipeline``, single
  card and over 5 row tiles) at teddy against
  ``tests/data/golden_torch_pyramid_teddy.npz``, each launching the SGM
  kernels a frame as it should, the pyramid equal to
  ``backend="torch"``; the row-sharded pyramid (4 tiles at HD, 5 at
  380x450) against the single card, and the single card there against
  ``backend="torch"``;
* the differentiable surface: the soft SGM's forward pass at teddy
  against the SGM kernels, a tune step's time and memory at teddy,
  ``tune_penalties`` on the card against the CPU, and ``stm-eval
  --tune`` on the card against the CPU;
* streaming (``check_stream``): ``StreamingEstimator.run`` over a Y4M of
  48 teddy frames read by the port's libstmio binding, at batch 1, 4
  and 8 and depth 1 to 3, on float32 and bf16 volumes, with DP, the
  refine stages and the pyramid, then 16 HD frames: every frame equal to
  ``Pipeline.estimate`` on the card, the launches a frame equal to an
  eager frame's; frames/s and the stage split, and the profiler's idle
  share of a batched run;
* ``python -m stereomatch_tpu_torch.cli.video`` (batched, ``--temporal``
  and per frame) on the card, its PNGs against ``--device cpu``
  (``check_video_cli``), and ``stm-serve`` in this process at batch 1
  and 8 (``check_serve``): 64 requests from 8 clients, each response
  equal to the local pipeline, requests/s and latency, no thread left
  after it closes;
* the partitioners (``check_partitioners``): disparity blocks at HD
  over 4 blocks on cuda:0 (ssd+wta at D = 256 and 1024, census+cvf+wta),
  2-D tiles at HD over (1, 2, 2) (ssd+sgm with WTA, DP and LR + median
  + speckle at a covering overlap, WTA at the default 48) and at teddy
  over (1, 3, 3) (census+cvf+wta), each against the single-card path
  and launching its kernels; ``stm-video --mesh`` and ``stm-serve
  --mesh`` against the card's paths;
* the batch axis over two processes (``check_distributed``): two worker
  processes of this script (``--distributed-worker RANK HOST:PORT``) in
  a gloo ``torch.distributed`` world, teddy over a (2, 5) and HD over a
  (2, 4) hybrid mesh on ``cuda:(rank % cards)``, each rank's frame equal
  to the single card at 0 pixels (rank 0's teddy frame also to the
  goldens) in exact, overlap and DP with the launches a frame stated,
  and ``sgm_mode="auto"`` equal to the mode it resolved to; then the
  carry copy, a hand-off stage and the card's copy rate behind
  ``parallel/ici_model.py``'s defaults;
* the tile axes across two processes (``check_distributed_tiles``):
  two workers (``--distributed-tiles-worker RANK HOST:PORT``), each
  bringing ``cuda:(rank % cards)`` twice, so that the world's meshes
  split a frame between them: HD over ``make_mesh()`` (1, 4) (exact
  with WTA and DP, overlap 64, ``auto``, the pyramid, a tracked frame),
  HD 2-D tiles (1, 2, 2), HD disparity blocks (4), teddy census+cvf+wta
  over tile_w; each rank's shards equal to the single card at 0 pixels
  with its launches a frame stated, the teddy halves against the CVF
  golden; then a carry and a 64-row HD halo moved between the ranks;

times kernels, plain versions, pipelines, each post-processing flag set,
the cost-family paths and their cost stages and the float32/bf16
crossover with CUDA events, ``stm-image``'s stages with the host clock,
and profiles each path with ``torch.profiler`` (device time by kernel, idle
share; the chunk kernel's device time beside its CUDA-event time).  Every
kernel is held bit-equal to its plain version.  Any failure raises and exits non-zero; nothing falls back.  The
last line of standard output is one JSON object with ``"ok": true`` and
the device; the lines before it give each kernel's design floor (the
bytes its launches move, over the memory rate) and list the kernels with
their launch counts, errors, times and bounds.  It imports nothing of
JAX.
"""

from __future__ import annotations

import collections
import io
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_teddy_disparity.npz"
GOLDEN_CVF = ROOT / "tests" / "data" / "golden_torch_cvf_teddy.npz"
GOLDEN_BF16 = ROOT / "tests" / "data" / "golden_torch_bf16_teddy.npz"
GOLDEN_REFINED = ROOT / "tests" / "data" / "golden_torch_refined_teddy.npz"
GOLDEN_COSTS = ROOT / "tests" / "data" / "golden_torch_costs_teddy.npz"
GOLDEN_PYRAMID = ROOT / "tests" / "data" / "golden_torch_pyramid_teddy.npz"

GOLDEN_MAX_DIFF = 16        # pixels of 168,750 (0.01%); 0 expected
CVF_GOLDEN_MAX_DIFF = 169   # pixels of 168,750 (0.1%); 0 expected
WARMUP, REPS = 3, 20
# The plain versions are Python loops of small launches, hundreds of ms
# a call at HD: timed once in each of their two turns (phase 3 has run
# them at the same shapes), which keeps the run inside its time budget.
PLAIN_WARMUP, PLAIN_REPS = 0, 1
# A torch.profiler capture that comes back without one device event is
# taken again, up to this many captures in all, before the caller's
# check that the device was busy fails.
PROFILE_ATTEMPTS = 3
TEDDY_CUTS = (75, 150, 225, 300)     # 5 row tiles, as the sharded path
# Frames between teddy (0.17 MP) and HD (1.31 MP) and past it, timed in
# both volume dtypes: VGA, 720p and 1080p, each at the D beside it, and
# VGA at D=256 and 720p at D=64: fixed sizes at another D, which tell a
# rule by pixels from a rule by volume (H x W x D).
CROSSOVER_SIZES = ((480, 640, 64), (720, 1280, 128), (1080, 1920, 256),
                   (480, 640, 256), (720, 1280, 64))
# estimate_refined's flag sets: the golden's, then the timed ones.
REFINED_GOLDEN = {"default": {},
                  "lr_volume": dict(lr_check=True, lr_mode="volume"),
                  "min_confidence": dict(min_confidence=0.1)}
REFINED_TIMED = {"estimate": None, "default": {},
                 "lr_mirror": dict(lr_check=True),
                 "lr_volume": dict(lr_check=True, lr_mode="volume"),
                 "wmf": dict(weighted_median=True, wmf_sigma=0.1),
                 "min_confidence": dict(min_confidence=0.1),
                 "fgs": dict(fgs_lambda=16.0, fgs_sigma=0.08)}
# The smoother's Python loop of column steps takes hundreds of ms a
# frame: timed at teddy only, median of FGS_REPS.
FGS_REPS = 3
EVAL_ARGS = ("--synthetic", "2", "--synthetic-size", "375x450x128",
             "--configs", "ssd:wta:sgm+refine,ssd:dyn:sgm")
FAR_D = 600                 # past the SGM and DP kernels' 512
# The Birchfield, ZNCC and SSD-over-textures paths: name -> ((cost,
# reducer, aggregation), the kernels each must launch).  Their costs are
# plain PyTorch on the card (no TPU kernel computes them), except
# ssd-texture, whose float32 SSD is the SSD kernel's.
FAMILY_PATHS = {
    "birchfield_sgm_wta": (("birchfield", "wta", "sgm"),
                           ("sgm_rows", "sgm_horizontal")),
    "ncc_sgm_wta": (("ncc", "wta", "sgm"), ("sgm_rows", "sgm_horizontal")),
    "ssd_texture_sgm_wta": (("ssd-texture", "wta", "sgm"),
                            ("ssd", "sgm_rows", "sgm_horizontal")),
    "birchfield_sgm_dyn": (("birchfield", "dyn", "sgm"),
                           ("sgm_rows", "sgm_horizontal", "dp_forward",
                            "dp_backward")),
    "ncc_cvf_wta": (("ncc", "wta", "cvf"), ("cvf", "cvf_filter")),
}
# Pixels of 168,750 that each path may differ from its golden: the count
# tests/test_torch_costs_golden.py measures on the CPU (0 for all five).
COSTS_GOLDEN_MAX_DIFF = dict.fromkeys(FAMILY_PATHS, 0)
# stm-image runs on the teddy PNGs: flags after "LEFT RIGHT 128 OUT".
IMAGE_RUNS = (["-am", "sgm"],
              ["-cm", "birchfield", "-am", "sgm", "-dm", "dyn", "-fig"],
              ["-cm", "ncc", "-am", "sgm", "--refine", "--confidence",
               "CONF"],
              ["-cm", "census", "-am", "cvf", "--cvf-subsample", "2"],
              ["--pyramid", "1"],
              ["--pyramid", "2", "--refine"])
# stm-eval with --tune on the card and on the CPU (the tuned census
# penalties within the tuner's 2e-5; pyramid1's metrics within 1e-6).
TUNE_EVAL_ARGS = ("--synthetic", "1", "--tune", "1", "--tune-steps", "3",
                  "--configs", "census:wta:sgm,pyramid1")
TUNE_RTOL = 2e-5
CHUNK_CUTS = {"teddy": TEDDY_CUTS, "ragged": (12,),
              "hd": (256, 512, 768)}

# The stream phase: teddy frames of STREAM_SCENES scenes in turn, each
# run (batch, depth, options) counted, checked and timed; then HD.
STREAM_FRAMES, STREAM_SCENES = 48, 8
STREAM_RUNS = tuple((b, dp, {}) for b in (1, 4, 8) for dp in (1, 2, 3)) + (
    (4, 2, {"cost_dtype": "bfloat16"}), (8, 3, {"cost_dtype": "bfloat16"}),
    (4, 2, {"reducer": "dynamic_programming"}),
    (4, 2, {"median": True, "subpixel": True}),
    (4, 2, {"pyramid_levels": 1}))
HD_STREAM_FRAMES, HD_STREAM_SCENES = 16, 4
HD_STREAM_RUNS = ((4, 2, {}),)
# stm-video runs on the card, each against --device cpu on its first
# VIDEO_CPU_FRAMES frames (plain SGM on the host: seconds a frame).  The
# batched run is a subprocess (`python -m ...`, as a user runs it); the
# others call the CLI's main in this process, which saves a process
# start and a kernel load (about 8 s each) of the time limit.
VIDEO_RUNS = {"batched": ["--batch", "4"],
              "temporal": ["--temporal", "--keyframe-interval", "4"],
              "per-frame": []}
VIDEO_SUBPROCESS = ("batched",)
VIDEO_CPU_FRAMES = 4
# stm-serve: requests, client threads, and the servers' flags.
SERVE_REQUESTS, SERVE_CLIENTS = 64, 8
SERVE_RUNS = (["--batch", "1"], ["--batch", "8", "--warmup", "375x450"])
# The partitioners (disparity blocks, 2-D tiles): CUDA events, median of
# PARTITION_REPS after PARTITION_WARMUP (their HD frames take 0.1-1 s).
PARTITION_WARMUP, PARTITION_REPS = 1, 5

# The card's published rates (NVIDIA H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# Each kernel's C entry points, whose launches _build.LAUNCHES counts.
COUNTERS = {"ssd": ("stm_ssd_f32", "stm_ssd_i32"),
            "sgm_rows": ("stm_sgm_rows_f32",),
            "sgm_chunk": ("stm_sgm_chunk_f32",),
            "sgm_horizontal": ("stm_sgm_horizontal_f32",),
            "dp_forward": ("stm_dp_forward_f32",),
            "dp_backward": ("stm_dp_backward",),
            "cvf": ("stm_cvf_stats_f32",),
            "cvf_filter": ("stm_cvf_filter_f32",),
            "ssd_bf16": ("stm_ssd_bf16",),
            "sgm_rows_bf16": ("stm_sgm_rows_bf16",),
            "sgm_chunk_bf16": ("stm_sgm_chunk_bf16",),
            "sgm_horizontal_bf16": ("stm_sgm_horizontal_bf16",),
            "dp_forward_bf16": ("stm_dp_forward_bf16",),
            "cvf_bf16": ("stm_cvf_stats_bf16",),
            "cvf_filter_bf16": ("stm_cvf_filter_bf16",)}

# The two-process phase (check_distributed): its workers' time limit;
# each cell's tiles and runs (label -> ShardedPipeline keywords, the
# launches a frame, the golden array rank 0's frame meets); the frames
# timed (CUDA events, median of DIST_REPS after DIST_WARMUP).  The
# teddy cell's global stack is the golden scene (its k and seed) and the
# next seed; HD's, seeds 11 and 12 at k = 7.
DIST_TIMEOUT_S = 300
DIST_WARMUP, DIST_REPS = 1, 5
DIST_HD = (1024, 1280, 256, 7, (11, 12))
DIST_CELLS = {
    "teddy": (5, {
        "exact ssd+sgm+wta": (dict(sgm_mode="exact"), dict(
            ssd=5, sgm_horizontal=10, sgm_chunk=30, sgm_rows=0), "wta"),
        "overlap=300 ssd+sgm+wta": (
            dict(sgm_mode="overlap", overlap=300),
            dict(ssd=5, sgm_horizontal=10, sgm_chunk=0, sgm_rows=30), "wta"),
        "exact ssd+sgm+dyn": (
            dict(sgm_mode="exact", reducer="dynamic_programming"),
            dict(ssd=5, sgm_horizontal=10, sgm_chunk=30, dp_forward=5,
                 dp_backward=5), "dp"),
    }),
    "hd": (4, {
        "exact ssd+sgm+wta": (dict(sgm_mode="exact"), dict(
            ssd=4, sgm_horizontal=8, sgm_chunk=24, sgm_rows=0), None),
    }),
}
# The tile axes across two processes (check_distributed_tiles): HD's
# global stack (DIST_HD) over make_mesh() (1, 4) with each path's
# launches a frame on each rank (two of the four tiles); the 2-D tiles
# (1, 2, 2) at the covering overlap, one frame; the disparity blocks (4)
# of frame 0; teddy census+cvf+wta over a (1, 1, 2) mesh of one device
# of each rank (tile_w across the ranks).  The transport's moves between
# the ranks are timed over TILES_LINK_REPS round trips (host clock, both
# ranks synchronised).
TILES_RUNS = {
    "exact ssd+sgm+wta": (dict(sgm_mode="exact"), "wta", dict(
        ssd=2, sgm_horizontal=4, sgm_chunk=12, sgm_rows=0)),
    "exact ssd+sgm+dyn": (dict(sgm_mode="exact",
                               reducer="dynamic_programming"), "dyn", dict(
        ssd=2, sgm_horizontal=4, sgm_chunk=12, sgm_rows=0, dp_forward=2,
        dp_backward=2)),
    "overlap=64 ssd+sgm+wta": (dict(sgm_mode="overlap", overlap=64),
                               "one-process", dict(
        ssd=2, sgm_horizontal=4, sgm_chunk=0, sgm_rows=12)),
}
TILES_2D_OVERLAP = 640
TILES_LINK_REPS = {"carry": 20, "halo": 3}

# The rates behind parallel/ici_model.py's defaults: copies timed
# LINK_COPIES to a pair of CUDA events, hand-off stages LINK_STAGES to a
# pair; the card's copy rate on COPY_BYTES.
LINK_COPIES, LINK_STAGES = 100, 100
COPY_BYTES = 1 << 30


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def log(message: str) -> None:
    print(message, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup=WARMUP, reps=REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls after ``warmup``
    calls, each call bracketed by its own CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and float32 operations over its non-tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(h, w, d, k, r, tiles, volume_bytes=4):
    """Work of each kernel's function at [h, w, d], as {name: (bytes,
    operations, design_bytes)}.

    bytes: each input read once, each output written once (float32 4
    bytes, pointers 1 byte; a stored cost or aggregated volume
    ``volume_bytes``, 2 for bf16, whose partial sums, carries, a0 and b0
    stay float32); operations: those of the separable
    algorithm.  dp_backward reads the one pointer per pixel that its walk
    needs (and its design, :func:`dp_window_bytes` a walked column);
    sgm_chunk (the six row traversals over ``tiles`` row chunks)
    also writes and reads the [W, D] carry at each of the
    6 * (tiles - 1) hand-offs.

    design_bytes: what the kernels' launch structure moves, one launch
    per traversal as the path runs it.  sgm_rows: six traversals, each
    reading the cost volume, the image and the out volume it accumulates
    onto and writing out back (18 volumes, 6 images; a bf16 volume's
    last traversal writes its bf16 result instead); sgm_horizontal: the
    family's first launch writes out without reading it (5 volumes, 2
    images); sgm_chunk: sgm_rows' traffic plus the carries; cvf: the
    stats kernel reads its tiles of the volume and the guide with their
    halos (:func:`cvf_tile_reads`) and the guide planes and writes a0 and
    b0, the filter kernel reads its tiles of a0 and b0 and the guide and
    writes the result; dp_backward reads the final costs, writes the
    disparities and copies each walked column's window.  The other
    single-pass kernels move their function's bytes."""
    vol, img, f = h * w * d, h * w, 4        # elements; float32 bytes
    v = volume_bytes
    hd = h * d * f
    carries = 6 * (tiles - 1) * 2 * w * d * f
    rows = (6 * (v + 2 * f) - (f - v)) * vol + 6 * img * f
    single = {
        "ssd": (2 * img * f + vol * v, vol * (2 + 4 * k)),
        "dp_forward": (vol * v + vol + hd, vol * 4),
        "dp_backward": (hd + img + img * f, h * d + 2 * img),
    }
    work = {name: (nbytes, ops, nbytes)
            for name, (nbytes, ops) in single.items()}
    work["dp_backward"] = (*single["dp_backward"],
                           hd + img * f + h * (w - 1) * dp_window_bytes(d))
    work.update({
        "sgm_rows": (2 * vol * v + img * f, vol * 9 * 6, rows),
        "sgm_chunk": (2 * vol * v + img * f + carries, vol * 9 * 6,
                      rows + carries),
        "sgm_horizontal": (vol * (v + f) + img * f, vol * 9 * 2,
                           (2 * v + 3 * f) * vol + 2 * img * f),
        "cvf": (2 * vol * v + 5 * img * f + 2 * hd, vol * (16 * r + 25),
                cvf_tile_reads(h, w, d, r, 16, 2) * (d * v + f)
                + (2 * cvf_tile_reads(h, w, d, r, 8, 3) * d + 2 * vol
                   + 5 * img) * f + vol * v + 2 * hd),
    })
    return work


def dp_window_bytes(d, reach=64, sector=32):
    """Bytes of device memory that one walked column's window touches in
    ``csrc/dp.cu``'s walk: the 2 * reach + 1 disparities around a batch's
    centre, clipped to the band, in 32-byte sectors: at most 5 sectors
    (129 bytes from any alignment), at most the column's own sectors
    (counted for columns on 32-byte boundaries, D % 32 == 0, as at both
    timed geometries)."""
    return sector * min(-(-(2 * reach + 1 + sector - 1) // sector),
                        -(-d // sector))


def cvf_tile_reads(h, w, d, r, td, blocks_per_sm, sms=132, tx=32,
                   group=4):
    """Pixels (row, column pairs) that a CVF kernel with ``td``
    disparities and ``blocks_per_sm`` blocks an SM (at r = 8 on an H100:
    stats 16 and 2, filter 8 and 3) stages from device memory, halos
    included: ``csrc/cvf.cu``'s launch cuts rows into chunks so that the
    grid holds about four times the blocks the card runs at once, never
    chunks under 4r rows, and each chunk of each 32-column tile reads its
    rows and columns within r of it that lie in the image."""
    tiles = -(-w // tx) * -(-d // td)
    chunks = -(-4 * sms * blocks_per_sm // tiles)
    chunks = min(chunks, max(1, h // max(4 * r, 4 * group)))
    ch = -(-(-(-h // chunks)) // group) * group
    rows = sum(min(y0 + ch - 1 + r, h - 1) - max(y0 - r, 0) + 1
               for y0 in range(0, h, ch))
    cols = sum(min(x0 + tx - 1 + r, w - 1) - max(x0 - r, 0) + 1
               for x0 in range(0, w, tx))
    return rows * cols


def kernel_bounds(h, w, d, k, r, tiles, volume_bytes=4):
    """{name: (bound_ms, bound_by, design_floor_ms)}: the least time of
    each kernel's function (:func:`bound`) and its design bytes over the
    card's memory rate."""
    return {name: (*bound(nbytes, ops), design / HBM_BYTES_PER_S * 1e3)
            for name, (nbytes, ops, design)
            in kernel_work(h, w, d, k, r, tiles, volume_bytes).items()}


def profile_path(torch, fn, frames: int = 10):
    """Device time over ``frames`` calls of ``fn`` under ``torch.profiler``
    (after one warm-up call).  Returns (wall ms per frame, kernel ms per
    frame by name, stage ms per frame by span, device operations per
    frame): the pipeline's ``stm/*``
    spans appear on the device timeline too, and are kept apart from the
    kernels.

    The profiler's device tracing starts late: without a warm-up step the
    first frames of a capture lose some or all of their device events
    (about 1.3 of 10 eager teddy frames on the H100; a two-kernel capture
    came back empty).  So the capture runs one frame as the schedule's
    warm-up step, whose events are dropped, before the recorded ones; a
    capture that still holds no device event is taken again."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            start = time.perf_counter()
            for _ in range(frames):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3 / frames
            prof.step()
        device = [evt for evt in prof.events()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and not evt.name.startswith("ProfilerStep")]
        if device:
            break
        log(f"  [profile] capture {attempt} of {PROFILE_ATTEMPTS} held no "
            f"device event")
    kernels, spans, count = {}, {}, 0
    for evt in device:
        into = spans if evt.name.startswith("stm/") else kernels
        ms = evt.time_range.elapsed_us() / 1e3 / frames
        into[evt.name] = into.get(evt.name, 0.0) + ms
        count += into is kernels
    return wall_ms, kernels, spans, count / frames


def compare(name, ref, out, rtol, atol, exact=False, quiet=False) -> float:
    """Hold ``out`` against ``ref``: identical non-finite placement, then
    exact equality or |out - ref| <= atol + rtol * |ref|.  Returns the
    max abs error over finite cells."""
    import torch
    require(ref.shape == out.shape and ref.dtype == out.dtype,
            f"{name}: {tuple(out.shape)} {out.dtype} vs "
            f"{tuple(ref.shape)} {ref.dtype}")
    if ref.dtype.is_floating_point:
        fin = torch.isfinite(ref)
        require(torch.equal(fin, torch.isfinite(out)),
                f"{name}: non-finite placement differs")
        require(torch.equal(ref[~fin], out[~fin]),
                f"{name}: non-finite values differ")
        err = (out[fin] - ref[fin]).abs()
        max_err = float(err.max()) if err.numel() else 0.0
        if not exact:
            bound = atol + rtol * ref[fin].abs()
            require(bool((err <= bound).all()),
                    f"{name}: max abs error {max_err} exceeds the bound")
    else:
        max_err = float((out.long() - ref.long()).abs().max())
        exact = True
    bit_equal = torch.equal(ref, out)
    if exact:
        require(bit_equal, f"{name}: not bit-equal (max abs err {max_err})")
    if not quiet:
        log(f"  {name}: max_abs_err={max_err!r} bit_equal={bit_equal}")
    return max_err


def hand_made_pointers(torch, shape, dev, seed=9):
    """(kind, int8 pointer volume on ``dev``) for the walk's card check:
    all -1, all +1, a random mix of {-1, 0, +1}, and any int8 value."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    yield "all -1", torch.full(shape, -1, dtype=torch.int8, device=dev)
    yield "all +1", torch.ones(shape, dtype=torch.int8, device=dev)
    yield "mixed", torch.randint(-1, 2, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
    yield "any int8", torch.randint(-128, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8)


def chunk_spans(height, cuts, step):
    """The row chunks cut at ``cuts``, in the scan order of ``step``."""
    edges = [0, *cuts, height]
    spans = list(zip(edges[:-1], edges[1:]))
    return spans if step[0] > 0 else spans[::-1]


def check_chunks(tag, vol, image, p1, p2) -> float:
    """The chunk kernel against its plain version for the six row
    traversals, each chunk from the plain version's carry of the chunk
    before it in scan order: contributions and carries bit-equal.  On a
    bf16 volume each chunk of the last traversal also adds onto a float32
    partial (its own contributions) and rounds the sum into a bf16
    result, as the sharded path's last launches do.  Returns the max abs
    error (0)."""
    import torch
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import sgm_cuda
    max_err, n_chunks = 0.0, 0
    bf16 = vol.dtype == torch.bfloat16
    for step in agg_ops.TRAVERSALS[2:]:
        carry = (None, None)
        for rank, (a, b) in enumerate(chunk_spans(vol.shape[0],
                                                  CHUNK_CUTS[tag], step)):
            kw = dict(penalty1=p1, penalty2=p2, seed=rank == 0)
            ref, ref_carry = agg_ops.sweep_chunk_with_carry(
                vol[a:b], image[a:b], step, *carry, **kw)
            out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vol[a:b], image[a:b], step, *carry, **kw)
            name = (f"sgm_chunk{' bf16' if bf16 else ''} {tag} step {step} "
                    f"rows {a}:{b}")
            max_err = max(max_err, compare(name, ref, out, 0, 0, exact=True,
                                           quiet=True))
            for i in range(2):
                compare(f"{name} carry", ref_carry[i], out_carry[i], 0, 0,
                        exact=True, quiet=True)
            if bf16 and step == agg_ops.TRAVERSALS[-1]:
                result = torch.empty_like(vol[a:b])
                sgm_cuda.sweep_chunk_with_carry_cuda(
                    vol[a:b], image[a:b], step, *carry, out=ref.clone(),
                    accumulate=True, result=result, **kw)
                compare(f"{name} rounded result", (ref + ref).to(vol.dtype),
                        result, 0, 0, exact=True, quiet=True)
            n_chunks += 1
            carry = ref_carry
    log(f"  sgm_chunk{' bf16' if bf16 else ''} {tag}, chunks "
        f"{CHUNK_CUTS[tag]}: {n_chunks} chunk launches, contributions and "
        f"carries bit-equal{', the last rounded into bf16' if bf16 else ''}")
    return max_err


def chunked_rows(vol, image, out, p1, p2, cuts, kernel, result=None):
    """The six row traversals of ``vol`` over the row chunks cut at
    ``cuts`` with carry hand-off, through the chunk kernel (``kernel``)
    or its plain version, each added onto ``out``: the sharded exact
    path's SGM rows, which add onto the horizontal family's volume.  With
    ``result`` (a bf16 volume), the last traversal rounds its sums into
    it instead, as the sharded path does."""
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import sgm_cuda
    for step in agg_ops.TRAVERSALS[2:]:
        carry = (None, None)
        final = result is not None and step == agg_ops.TRAVERSALS[-1]
        for rank, (a, b) in enumerate(chunk_spans(vol.shape[0], cuts,
                                                  step)):
            kw = dict(penalty1=p1, penalty2=p2, seed=rank == 0)
            if kernel:
                _, carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                    vol[a:b], image[a:b], step, *carry, out=out[a:b],
                    accumulate=True, result=result[a:b] if final else None,
                    **kw)
            else:
                part, carry = agg_ops.sweep_chunk_with_carry(
                    vol[a:b], image[a:b], step, *carry, **kw)
                if final:
                    result[a:b] = (out[a:b] + part).to(result.dtype)
                else:
                    out[a:b] += part


def refine_stages(vol, disp, guide, d):
    """{name: zero-argument call} of each stage of ``ops/refine.py`` on
    an aggregated volume, its WTA disparities and the left image, on
    their device, with estimate_refined's parameters (the guide's
    intensities are in [0, 1])."""
    from stereomatch_tpu_torch.ops import refine
    disp_r = refine.right_disparity_from_volume(vol)
    mask = refine.left_right_consistency(disp, disp_r, 1, max_disparity=d)
    return {
        "subpixel_refine": lambda: refine.subpixel_refine(vol, disp),
        "median_filter_3x3": lambda: refine.median_filter_3x3(disp),
        "right_disparity_from_volume":
            lambda: refine.right_disparity_from_volume(vol),
        "left_right_consistency": lambda: refine.left_right_consistency(
            disp, disp_r, 1, max_disparity=d),
        "fill_inconsistent": lambda: refine.fill_inconsistent(disp, mask),
        "confidence_pkrn": lambda: refine.confidence_pkrn(vol),
        "weighted_median_filter": lambda: refine.weighted_median_filter(
            disp, guide, window=5, sigma=0.1, n_bins=d),
        "fgs_smooth": lambda: refine.fgs_smooth(
            disp.to(vol.dtype), guide, lam=16.0, sigma_color=0.08,
            confidence=mask.to(vol.dtype)),
        "filter_speckles": lambda: refine.filter_speckles(
            disp, fill="background"),
    }


def check_post_processing(torch, dev, shapes, run_path, mesh5, sharded_kw,
                          p1, p2) -> None:
    """Phase 4's post-processing checks (see the module docstring), each
    path with the launch counts set to 0 just before it and read just
    after."""
    from stereomatch_tpu_torch import cli_common, parallel
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import refine

    left, right, _, d, k = shapes["teddy"]
    left_np, right_np = left.cpu().numpy(), right.cpu().numpy()
    golden = np.load(GOLDEN_REFINED)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      penalty1=p1, penalty2=p2)
    pipe.cost.kernel_size = k
    for name, flags in REFINED_GOLDEN.items():
        log(f"[refined path] ssd -> sgm -> wta, estimate_refined {name} "
            f"{flags}, teddy 375x450 D=128")
        out, _ = run_path(
            f"refined {name}",
            lambda: pipe.estimate_refined(left_np, right_np, **flags),
            ("ssd", "sgm_rows", "sgm_horizontal"), dtype=torch.float32)
        n_diff = int((out != golden[name]).sum())
        log(f"  pixels differing from golden refined {name}: {n_diff} of "
            f"{out.size}")
        require(n_diff == 0, f"refined {name} differs from its golden at "
                f"{n_diff} pixels")

    log("[refine stages] each stage of ops/refine.py on the card against "
        "the same stage on the CPU, teddy inputs from the card's path")
    pipe.estimate(left, right)
    vol, disp = pipe._aggregation_volume, pipe._disparity_image
    on_card = refine_stages(vol, disp, left, d)
    on_cpu = refine_stages(vol.cpu(), disp.cpu(), left.cpu(), d)
    for name, run in on_card.items():
        out = run()
        require(out.device == dev, f"{name} left {dev}")
        compare(f"{name} card vs CPU", on_cpu[name]().to(dev), out, 0, 0,
                exact=True)

    log(f"[sharded refined] median + subpixel + speckle, teddy over 5 row "
        f"tiles on {dev}, against the single-card path")
    pipe_sh = parallel.ShardedPipeline(mesh5, d, **sharded_kw, median=True,
                                       subpixel=True, speckle=True)
    out, _ = run_path("sharded refined",
                      lambda: pipe_sh.estimate(left_np, right_np),
                      ("ssd", "sgm_chunk", "sgm_horizontal"),
                      dtype=torch.float32)
    want = refine.filter_speckles(pipe.estimate_refined(left, right))
    n_diff = int((out != want.cpu().numpy()).sum())
    log(f"  pixels differing from the single-card path: {n_diff} of "
        f"{out.size}")
    require(n_diff == 0, f"sharded refined differs at {n_diff} pixels")

    log(f"[auto past the kernels] ssd -> sgm -> dyn, 64x704 D={FAR_D}: the "
        f"SSD kernel, then the plain SGM and DP on the card")
    far_left, far_right, _ = stereo_pair(64, 704, FAR_D, seed=4)
    far = {backend: cli_common.create_pipeline(
        "ssd", "dyn", "sgm", max_disparity=FAR_D, penalty1=p1, penalty2=p2,
        backend=backend) for backend in ("auto", "torch", "cuda")}
    out, counts = run_path(
        "auto past the kernels",
        lambda: far["auto"].estimate(far_left, far_right), ("ssd",),
        shape=(64, 704), d=FAR_D)
    require(all(counts[name] == 0 for name in
                ("sgm_rows", "sgm_horizontal", "dp_forward", "dp_backward")),
            f"D={FAR_D} launched a kernel past its limit: {counts}")
    plain = far["torch"].estimate(far_left, far_right).cpu().numpy()
    require(np.array_equal(out, plain), "auto past the kernels differs from "
            "the plain path")
    log("  equal to backend='torch' at every pixel")
    try:
        far["cuda"].estimate(far_left, far_right)
    except ValueError as err:
        log(f"  backend='cuda' refused: {err}")
    else:
        raise SmokeFailure(f"backend='cuda' ran D={FAR_D}")
    del far

    log(f"[stm-eval] python -m stereomatch_tpu_torch.cli.evaluate "
        f"{' '.join(EVAL_ARGS)}, on the card and on the CPU")
    from stereomatch_tpu_torch.cli import evaluate
    with tempfile.TemporaryDirectory() as tmp:
        card_json, cpu_json = Path(tmp) / "card.json", Path(tmp) / "cpu.json"
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "stereomatch_tpu_torch.cli.evaluate",
             *EVAL_ARGS, "--json", str(card_json)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        log(f"  card run: exit {proc.returncode} in "
            f"{time.perf_counter() - start:.1f} s")
        for line in proc.stdout.strip().splitlines():
            log(f"    {line}")
        require(proc.returncode == 0, f"stm-eval failed: {proc.stderr}")
        # The CPU runs the first scene only (its plain SGM is the slow
        # part); its rows hold that scene's metrics.
        cpu_args = list(EVAL_ARGS)
        cpu_args[cpu_args.index("--synthetic") + 1] = "1"
        require(evaluate.main([*cpu_args, "--device", "cpu", "--json",
                               str(cpu_json)]) == 0, "stm-eval on the CPU")
        card_rows = json.loads(card_json.read_text())
        cpu_rows = json.loads(cpu_json.read_text())
    require([r["name"] for r in card_rows] == ["ssd-wta-sgm-refine",
                                               "ssd-dyn-sgm"],
            f"stm-eval rows {[r['name'] for r in card_rows]}")
    for row, want in zip(card_rows, cpu_rows):
        got, want = row["scenes"][0], want["scenes"][0]
        for key in ("rmse", "avg_abs_error", "bad_pixel_ratio"):
            rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
            require(np.isfinite(row[key]) and rel <= 1e-6,
                    f"stm-eval {row['name']} {key}: card {got[key]!r}, "
                    f"CPU {want[key]!r}")
        log(f"  {row['name']}: rmse {row['rmse']!r}, bad-pixel "
            f"{row['bad_pixel_ratio']!r}; scene 0 within 1e-6 of the "
            f"CPU's")


def family_pipeline(cli_common, name, d, **kw):
    """The pipeline of FAMILY_PATHS[name] at ``d`` disparities, with the
    golden's SGM and CVF parameters and each cost's default window."""
    (cost, reducer, aggr), _ = FAMILY_PATHS[name]
    g = np.load(GOLDEN_COSTS)
    return cli_common.create_pipeline(
        cost, reducer, aggr, max_disparity=d,
        penalty1=float(g["penalty1"]), penalty2=float(g["penalty2"]),
        cvf_radius=int(g["cvf_radius"]), cvf_eps=float(g["cvf_eps"]), **kw)


def check_cost_families(torch, dev, shapes, run_path) -> None:
    """Phase 4's Birchfield, ZNCC and SSD-over-textures checks: each path
    of FAMILY_PATHS at teddy and HD through ``create_pipeline`` on the
    card (launch counts set to 0 just before it and read just after),
    equal to ``backend="torch"`` on the card; at teddy each cost volume
    equal to the CPU's and each path against
    ``golden_torch_costs_teddy.npz``; the sharded birchfield and ncc
    paths (5 tiles at teddy, 4 at HD, on cuda:0) equal to the single
    card."""
    from stereomatch_tpu_torch import cli_common, parallel

    golden = np.load(GOLDEN_COSTS)
    single = {}
    for tag in ("teddy", "hd"):
        left, right, gt, d, _ = shapes[tag]
        if tag == "teddy":
            require((int(golden["height"]), int(golden["width"]),
                     int(golden["max_disparity"])) == (*left.shape, d),
                    "the teddy scene is not the golden's")
        checked_costs = set()
        for name, ((cost, _, _), kernels) in FAMILY_PATHS.items():
            log(f"[cost family] {name.replace('_', ' ')}, {tag} "
                f"{tuple(left.shape)} D={d}")
            pipe = family_pipeline(cli_common, name, d)
            disp, counts = run_path(f"{name} {tag}",
                                    lambda: pipe.estimate(left, right),
                                    kernels, shape=tuple(left.shape), d=d)
            if cost != "ssd-texture":
                require(counts["ssd"] == 0, f"{name} launched the SSD "
                        f"kernel")
            plain = family_pipeline(cli_common, name, d, backend="torch")
            want = plain.estimate(left, right).cpu().numpy()
            n_diff = int((disp != want).sum())
            log(f"  pixels differing from backend='torch' on the card: "
                f"{n_diff} of {disp.size}")
            require(n_diff == 0, f"{name} {tag}: auto differs from torch")
            if tag == "teddy":
                single[name] = disp
                if cost not in checked_costs:
                    checked_costs.add(cost)
                    compare(f"{cost} cost volume card vs CPU",
                            pipe.cost(left.cpu(), right.cpu()).to(dev),
                            pipe._cost_volume, 0, 0, exact=True)
                check_golden(name, disp, golden[name], gt, d,
                             COSTS_GOLDEN_MAX_DIFF[name],
                             float(golden[f"bad_pixel_{name}"]), 1e-4)
            else:
                single[(name, tag)] = disp
            del pipe, plain
            torch.cuda.empty_cache()

    for tag, tiles in (("teddy", 5), ("hd", 4)):
        left, right, _, d, _ = shapes[tag]
        mesh = parallel.make_mesh([dev] * tiles, n_batch=1)
        for cost, name in (("birchfield", "birchfield_sgm_wta"),
                           ("ncc", "ncc_sgm_wta")):
            log(f"[sharded cost family] exact {cost} -> sgm -> wta, {tag} "
                f"over {tiles} row tiles on {dev}, against the single card")
            g = np.load(GOLDEN_COSTS)
            pipe_sh = parallel.ShardedPipeline(
                mesh, d, cost=cost, penalty1=float(g["penalty1"]),
                penalty2=float(g["penalty2"]))
            disp, counts = run_path(
                f"sharded {cost} {tag}",
                lambda: pipe_sh.estimate(left, right),
                ("sgm_chunk", "sgm_horizontal"), shape=tuple(left.shape),
                d=d)
            require(counts["sgm_chunk"] == 6 * tiles
                    and counts["sgm_rows"] == 0,
                    f"sharded {cost} {tag} launches {counts}")
            want = single[name] if tag == "teddy" else single[(name, tag)]
            n_diff = int((disp != want).sum())
            log(f"  pixels differing from the single-card path: {n_diff} of "
                f"{disp.size}")
            require(n_diff == 0, f"sharded {cost} {tag} differs at {n_diff} "
                    f"pixels")
            del pipe_sh
            torch.cuda.empty_cache()


def check_golden(label, disp_np, want, gt, d, max_diff, golden_bad,
                 bad_slack):
    """Hold teddy disparities to a golden: at most ``max_diff`` pixels
    differ, and the bad-pixel rate is within ``bad_slack`` of the
    golden's."""
    n_diff = int((disp_np != want).sum())
    bad = float(np.mean((np.abs(disp_np - gt) > 1)[:, d:]))
    log(f"  pixels differing from golden {label}: {n_diff} of "
        f"{disp_np.size}")
    log(f"  bad-pixel vs ground truth: {bad!r} (golden {golden_bad!r})")
    require(n_diff <= max_diff, f"{n_diff} pixels differ from golden "
            f"{label}")
    require(bad <= golden_bad + bad_slack,
            f"bad-pixel {bad} above the golden's")


def check_image_cli(torch, shapes, card) -> dict:
    """stm-image (``python -m stereomatch_tpu_torch.cli.image``) on teddy
    PNGs written by the port's encoder: each of IMAGE_RUNS as a
    subprocess on the card, its output PNGs decoded to the same pixels as
    the same command run in this process with ``--device cpu``.  Returns
    the wall
    seconds of the card runs and of the first one's stages (PNG decode,
    estimate, PNG encode), timed in this process after a warm-up."""
    from stereomatch_tpu_torch import cli_common
    from stereomatch_tpu_torch.cli import image
    from stereomatch_tpu_torch.io import png
    from stereomatch_tpu_torch.io.data import load_image

    left, right, _, d, _ = shapes["teddy"]
    out = {"card_runs_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lp, rp = tmp / "left.png", tmp / "right.png"
        png.write(lp, (left.cpu().numpy() * 255).astype(np.uint8))
        png.write(rp, (right.cpu().numpy() * 255).astype(np.uint8))
        for i, flags in enumerate(IMAGE_RUNS):
            results = {}
            for where in ("card", "cpu"):
                conf = tmp / f"conf_{i}_{where}.png"
                run = [str(conf) if f == "CONF" else f for f in flags]
                dst = tmp / f"out_{i}_{where}.png"
                args = [str(lp), str(rp), str(d), str(dst), *run]
                log(f"[stm-image] {where}: {' '.join(args[3:])}")
                start = time.perf_counter()
                if where == "card":
                    proc = subprocess.run(
                        [sys.executable, "-m",
                         "stereomatch_tpu_torch.cli.image", *args],
                        cwd=ROOT, capture_output=True, text=True,
                        timeout=600)
                    rc = proc.returncode
                    require(rc == 0, f"stm-image failed: {proc.stderr}")
                else:
                    rc = image.main([*args, "--device", "cpu"])
                    require(rc == 0, "stm-image --device cpu failed")
                seconds = time.perf_counter() - start
                if where == "card":
                    out["card_runs_s"].append(seconds)
                log(f"  exit {rc} in {seconds:.2f} s")
                results[where] = [png.read(dst).array]
                if "CONF" in flags:
                    results[where].append(png.read(conf).array)
            for a, b in zip(results["card"], results["cpu"]):
                require(a.shape == b.shape and np.array_equal(a, b),
                        f"stm-image {flags}: the card's PNG differs from "
                        f"the CPU's")
            log(f"  card PNGs {[a.shape for a in results['card']]} equal "
                f"the CPU's pixel for pixel")
        # The first run's stages in this process, warm: decode both PNGs,
        # estimate on the card, colour and encode the output.
        pipe = cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=d)
        stages = {"decode": [], "estimate": [], "encode": []}
        for _ in range(6):
            t0 = time.perf_counter()
            lg = load_image(lp, "L").astype(np.float32)
            rg = load_image(rp, "L").astype(np.float32)
            t1 = time.perf_counter()
            disp = pipe.estimate(lg, rg).cpu().numpy()
            t2 = time.perf_counter()
            png.write(tmp / "timed.png", image.render_panels(disp))
            t3 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[key].append(dt)
        out.update({key: statistics.median(v[1:])
                    for key, v in stages.items()})
        log(f"  stm-image stages at teddy, median of 5 warm runs in one "
            f"process: decode {out['decode']!r} s, estimate "
            f"{out['estimate']!r} s, encode {out['encode']!r} s; card runs "
            f"{out['card_runs_s']} s wall each, process start included "
            f"[{card}]")
    return out


def time_cost_families(torch, shapes, card) -> dict:
    """Phase 5/6 for FAMILY_PATHS at teddy and HD: ms/frame of each path
    and of its cost stage alone (CUDA events, median of REPS after
    WARMUP, device-resident images), then device busy time, idle share
    and device operations per frame (torch.profiler, 10 frames)."""
    from stereomatch_tpu_torch import cli_common
    log(f"[cost family timings] median of {REPS} after {WARMUP}; then "
        f"torch.profiler over 10 frames; card: {card}")
    times = {}
    for tag in ("teddy", "hd"):
        left, right, _, d, _ = shapes[tag]
        for name in FAMILY_PATHS:
            pipe = family_pipeline(cli_common, name, d)
            e2e = time_ms(torch, lambda: pipe.estimate(left, right))
            cost_ms = time_ms(torch, lambda: pipe.cost(left, right))
            wall, by_name, spans, ops = profile_path(
                torch, lambda: pipe.estimate(left, right))
            busy = sum(by_name.values())
            require(busy > 0, f"the profiler saw no device time in {name}")
            times[f"{name} {tag}"] = {
                "ms": e2e, "cost_ms": cost_ms, "profiled_wall_ms": wall,
                "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                "device_ops": ops}
            log(f"  {name} {tag} {tuple(left.shape)} D={d}: {e2e!r} "
                f"ms/frame ({1000.0 / e2e!r} frames/s), cost stage "
                f"{cost_ms!r} ms; profiled wall {wall!r} ms/frame, device "
                f"busy {busy!r}, idle share {1.0 - busy / wall!r}, {ops!r} "
                f"device operations/frame [{card}]")
            log(f"    stage spans (device timeline) ms/frame: {spans}")
            for kname, ms in sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:6]:
                log(f"    {ms!r} ms/frame  {kname[:90]}")
            del pipe
            torch.cuda.empty_cache()
    return times


def time_post_processing(torch, shapes, p1, p2, card) -> dict:
    """Phase 5's post-processing times: estimate_refined per flag set at
    teddy and (without the smoother) at HD, and each refine stage alone
    at teddy, in ms, with CUDA events on device-resident images."""
    from stereomatch_tpu_torch import cli_common
    log(f"[refined timings] estimate_refined per flag set, ssd -> sgm -> "
        f"wta, median of {REPS} after {WARMUP} ({FGS_REPS} after 1 for the "
        f"smoother); card: {card}")
    times = {}
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        pipe = cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=d, penalty1=p1,
                                          penalty2=p2)
        pipe.cost.kernel_size = k
        times[tag] = {}
        for name, flags in REFINED_TIMED.items():
            if name == "fgs" and tag == "hd":
                continue
            if flags is None:
                def run():
                    return pipe.estimate(left, right)
            else:
                def run(flags=flags):
                    return pipe.estimate_refined(left, right, **flags)
            reps = (dict(warmup=1, reps=FGS_REPS) if name == "fgs"
                    else {})
            times[tag][name] = time_ms(torch, run, **reps)
            log(f"  {tag} {name}: {times[tag][name]!r} ms/frame [{card}]")
        if tag == "teddy":
            pipe.estimate(left, right)
            stages = refine_stages(pipe._aggregation_volume,
                                   pipe._disparity_image, left, d)
            times["teddy_stages"] = {}
            for name, run in stages.items():
                reps = (dict(warmup=1, reps=FGS_REPS)
                        if name == "fgs_smooth" else {})
                times["teddy_stages"][name] = time_ms(torch, run, **reps)
                log(f"  teddy stage {name}: "
                    f"{times['teddy_stages'][name]!r} ms [{card}]")
        del pipe
        torch.cuda.empty_cache()
    return times


# The kernel (``__global__`` function) each C entry point launches, by
# the entry point's prefix: the names a profile of a graph replay shows.
KERNEL_OF_ENTRY = {"stm_ssd": "ssd_kernel", "stm_sgm_rows": "sgm_rows_kernel",
                   "stm_sgm_horizontal": "sgm_horizontal_kernel",
                   "stm_sgm_chunk": "sgm_chunk_kernel",
                   "stm_dp_forward": "dp_forward_kernel",
                   "stm_dp_backward": "dp_backward_kernel",
                   "stm_cvf": "cvf_kernel"}


def compiled_paths(cli_common, shapes, p1, p2):
    """(label, tag, pipeline factory, second pair's seed) of each path
    whose ``compiled()`` is checked: at teddy the three main paths and
    FAMILY_PATHS, float32 and (where the cost stores it) bf16; at HD
    ssd+sgm+wta, ssd+sgm+dyn and census+cvf+wta; at 64x704 D = 600 under
    backend="auto" (the SSD kernel, then the plain SGM and DP)."""
    found = []
    main_paths = (("ssd+sgm+wta", ("ssd", "wta", "sgm")),
                  ("ssd+sgm+dyn", ("ssd", "dyn", "sgm")),
                  ("census+cvf+wta", ("census", "wta", "cvf")))
    for tag in ("teddy", "hd"):
        _, _, _, d, k = shapes[tag]
        for label, (cost, reducer, aggr) in main_paths:
            for dtype in (("float32", "bfloat16") if tag == "teddy"
                          else ("float32",)):
                def make(cost=cost, reducer=reducer, aggr=aggr, dtype=dtype,
                         d=d, k=k):
                    pipe = cli_common.create_pipeline(
                        cost, reducer, aggr, max_disparity=d, penalty1=p1,
                        penalty2=p2, volume_dtype=dtype)
                    if cost == "ssd":
                        pipe.cost.kernel_size = k
                    return pipe
                suffix = " bf16" if dtype != "float32" else ""
                found.append((label + suffix, tag, make))
    d = shapes["teddy"][3]
    for name, ((cost, _, _), _) in FAMILY_PATHS.items():
        for dtype in ("float32", "bfloat16") if cost == "ncc" else (
                "float32",):
            suffix = " bf16" if dtype != "float32" else ""
            found.append((name + suffix, "teddy",
                          lambda name=name, dtype=dtype: family_pipeline(
                              cli_common, name, d, volume_dtype=dtype)))
    found.append(("ssd+sgm+dyn D=600 auto", "far", lambda: (
        cli_common.create_pipeline("ssd", "dyn", "sgm", max_disparity=FAR_D,
                                   penalty1=p1, penalty2=p2))))
    return found


def check_compiled(torch, dev, shapes, p1, p2, card) -> dict:
    """``Pipeline.compiled()`` on the card (ROADMAP A.4): for each of
    :func:`compiled_paths`, the replay equals the eager frame bit for bit
    on two different pairs in a row (the static inputs refreshed, the
    first result not overwritten); the capture's launch counts equal one
    eager frame's, counted from 0 just before it; eager and replay
    ms/frame (CUDA events, median of REPS after WARMUP); the profiler
    over 10 replays: device busy time, idle share, device operations per
    frame, and each captured kernel seen on the device; the device memory
    each graph's pool holds."""
    import collections
    from stereomatch_tpu_torch import cli_common
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import _build

    def second(h, w, d, seed):
        left, right, _ = stereo_pair(h, w, d, seed=seed)
        return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)

    far = stereo_pair(64, 704, FAR_D, seed=3)[:2]
    pairs = {
        "teddy": [shapes["teddy"][:2], second(375, 450, 128, 7)],
        "hd": [shapes["hd"][:2], second(1024, 1280, 256, 12)],
        "far": [tuple(torch.from_numpy(a).to(dev) for a in far),
                second(64, 704, FAR_D, 4)]}
    log(f"[compiled] Pipeline.compiled(): a CUDA graph of a frame against "
        f"the eager frame; ms median of {REPS} after {WARMUP}, then "
        f"torch.profiler over 10 replays; card: {card}")
    out = {}
    for label, tag, make in compiled_paths(cli_common, shapes, p1, p2):
        pipe = make()
        two = pairs[tag]
        eager = [pipe.estimate(*pair).clone() for pair in two]
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        pipe.estimate(*two[0])
        torch.cuda.synchronize()
        eager_counts = collections.Counter(_build.LAUNCHES)
        fn = pipe.compiled()
        start = time.perf_counter()
        first = fn(*two[0])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - start
        replayed = fn(*two[1])
        torch.cuda.synchronize()
        require(torch.equal(first, eager[0]) and torch.equal(replayed,
                                                             eager[1]),
                f"compiled {label} {tag}: the replay differs from the eager "
                f"frame")
        (graph,) = fn.graphs.values()
        require(graph.launches == eager_counts,
                f"compiled {label} {tag}: captured launches "
                f"{dict(graph.launches)}, eager {dict(eager_counts)}")
        t_eager = time_ms(torch, lambda: pipe.estimate(*two[0]))
        t_replay = time_ms(torch, lambda: fn(*two[0]))
        wall, by_name, _, ops = profile_path(torch, lambda: fn(*two[0]))
        busy = sum(by_name.values())
        require(busy > 0, f"the profiler saw no device time in the replay "
                f"of {label} {tag}")
        for entry in graph.launches:
            kernel = next(v for k, v in KERNEL_OF_ENTRY.items()
                          if entry.startswith(k))
            require(any(kernel in name for name in by_name),
                    f"compiled {label} {tag}: {kernel} ({entry}) not seen "
                    f"in the profile of the replay")
        out[f"{label} {tag}"] = {
            "eager_ms": t_eager, "replay_ms": t_replay,
            "replay_profiled_wall_ms": wall, "replay_device_busy_ms": busy,
            "replay_idle_share": 1.0 - busy / wall, "replay_device_ops": ops,
            "graph_mb": graph.memory_bytes / 2 ** 20,
            "capture_s": capture_s, "launches": dict(graph.launches)}
        log(f"  {label} {tag} {tuple(two[0][0].shape)}: replay = eager on "
            f"two pairs; captured launches {dict(graph.launches)} = "
            f"eager's; eager {t_eager!r} ms/frame, replay {t_replay!r} "
            f"ms/frame; replay profiled wall {wall!r} ms/frame, device busy "
            f"{busy!r}, idle share {1.0 - busy / wall!r}, {ops!r} device "
            f"operations/frame; graph pool "
            f"{graph.memory_bytes / 2 ** 20:.1f} MiB; first call "
            f"(eager warm-up + capture + replay) {capture_s:.3f} s [{card}]")
        del fn, graph, pipe, eager, first, replayed
        torch.cuda.empty_cache()
    return out


# The plain CVF paths of ROADMAP A.9 at the golden's radius and eps.
CVF_PLAIN = {"masked": {}, "assume_finite": {"assume_finite": True},
             "fast_s2": {"subsample": 2}, "fast_s4": {"subsample": 4}}
CVF_HD_REPS = 3


def check_plain_cvf(torch, dev, shapes, card) -> dict:
    """The generic guided-filter paths (ROADMAP A.9), plain PyTorch on the
    card: at teddy, float32 and bf16, each of CVF_PLAIN on the census
    volume (``assume_finite`` on it with its +inf wedge set to 25, past
    every Hamming distance of the 5x5 code) equal to the same call on the
    CPU bit for bit; each timed at teddy (median of REPS) and HD (median
    of CVF_HD_REPS after one); the sharded CVF (5 tiles at teddy, 4 at
    HD, on cuda:0) equal at every pixel to the single-card masked
    pipeline, in either dtype, and at teddy against
    ``golden_torch_cvf_teddy.npz`` (the wedge path's) within the CVF
    golden gate."""
    from stereomatch_tpu_torch import cli_common, parallel
    from stereomatch_tpu_torch.ops import cost as cost_ops
    from stereomatch_tpu_torch.ops import cvf as cvf_ops

    golden_cvf = np.load(GOLDEN_CVF)
    radius, eps = int(golden_cvf["cvf_radius"]), float(golden_cvf["cvf_eps"])
    window = int(golden_cvf["census_window"])
    log(f"[plain cvf] masked, assume_finite, fast s=2 / s=4 on the census "
        f"volume, r={radius}, eps={eps}; card: {card}")
    out = {}
    for tag in ("teddy", "hd"):
        left, right, gt, d, _ = shapes[tag]
        census = cost_ops.census_hamming_cost_volume(
            left, right, max_disparity=d, window_size=window)
        for dtype in (torch.float32, torch.bfloat16):
            vol = census.to(dtype)     # Hamming distances: exact in bf16
            for name, kw in CVF_PLAIN.items():
                v = (torch.where(torch.isinf(vol), 25.0, vol).to(dtype)
                     if kw.get("assume_finite") else vol)
                label = f"cvf {name} {tag} {str(dtype)[6:]}"

                def run(v=v, kw=kw):
                    return cvf_ops.guided_filter_aggregate(
                        v, left, radius=radius, eps=eps, **kw)
                if tag == "teddy":
                    compare(f"{label} card vs CPU",
                            cvf_ops.guided_filter_aggregate(
                                v.cpu(), left.cpu(), radius=radius, eps=eps,
                                **kw).to(dev), run(), 0, 0, exact=True)
                    ms = time_ms(torch, run)
                else:
                    ms = time_ms(torch, run, warmup=1, reps=CVF_HD_REPS)
                out[label] = ms
                log(f"  {label}: {ms!r} ms [{card}]")
                torch.cuda.empty_cache()
        del census
        # Sharded CVF against the single-card masked pipeline.
        for dtype in ("float32", "bfloat16"):
            single = cli_common.create_pipeline(
                "census", "wta", "cvf", max_disparity=d, cvf_radius=radius,
                cvf_eps=eps, census_window=window, volume_dtype=dtype)
            single.aggregation.wedge_offset = None      # the masked path
            want = single.estimate(left, right).cpu().numpy()
            tiles = 5 if tag == "teddy" else 4
            pipe = parallel.ShardedPipeline(
                parallel.make_mesh([dev] * tiles, n_batch=1), d,
                cost="census", census_window=window, aggregation="cvf",
                cvf_radius=radius, cvf_eps=eps, cost_dtype=dtype)
            got = pipe.estimate(left, right).cpu().numpy()
            n_diff = int((got != want).sum())
            log(f"  sharded cvf {tag} {dtype}, {tiles} tiles on {dev}: "
                f"{n_diff} of {got.size} pixels differ from the single-card "
                f"masked path")
            require(n_diff == 0, f"sharded cvf {tag} {dtype} differs from "
                    f"the single-card masked path at {n_diff} pixels")
            ms = time_ms(torch, lambda: pipe.estimate(left, right),
                         **({} if tag == "teddy"
                            else dict(warmup=1, reps=CVF_HD_REPS)))
            single_ms = time_ms(torch, lambda: single.estimate(left, right),
                                **({} if tag == "teddy"
                                   else dict(warmup=1, reps=CVF_HD_REPS)))
            out[f"sharded census+cvf+wta {tag} {dtype}"] = ms
            out[f"census+masked cvf+wta {tag} {dtype}"] = single_ms
            log(f"  sharded census+cvf+wta {tag} {dtype}: {ms!r} ms/frame; "
                f"single-card census+masked cvf+wta {single_ms!r} ms/frame "
                f"[{card}]")
            if tag == "teddy" and dtype == "float32":
                check_golden("sharded census_cvf_wta (masked)", got,
                             golden_cvf["census_cvf_wta"], gt, d,
                             CVF_GOLDEN_MAX_DIFF,
                             float(golden_cvf["bad_pixel_vs_gt"]), 1e-3)
            del single, pipe
            torch.cuda.empty_cache()
    return out


def pyramid_video(golden):
    """The golden's 8-frame teddy video: 5 frames of one sequence, then a
    scene cut to 3 of another (``tests/test_torch_pyramid_golden.py``)."""
    from stereomatch_tpu_torch.io.synthetic import stereo_sequence
    h, w, d = (int(golden[k]) for k in ("height", "width", "max_disparity"))
    return (stereo_sequence(h, w, d, 5, seed=int(golden["seed"]), motion=1)
            + stereo_sequence(h, w, d, 3, seed=int(golden["cut_seed"]),
                              motion=1))


def pyramid_golden_key(levels: int, dtype: str) -> str:
    """The golden's entry of ``PyramidPipeline.estimate`` at ``levels`` on
    a ``dtype`` coarse volume."""
    return f"pyramid{levels}_{'bf16' if dtype == 'bfloat16' else 'estimate'}"


def check_pyramid_temporal(torch, dev, shapes, run_path, card) -> dict:
    """The coarse-to-fine pyramid and the video tracker on the card.

    * ``PyramidPipeline`` at teddy, levels 1 and 2, float32 and bf16
      coarse volumes: 0 pixels off ``tests/data/
      golden_torch_pyramid_teddy.npz`` (estimate, and estimate_refined
      in float32), equal to ``backend="torch"`` on the card, the SGM
      kernels launched 6 (rows) and 2 (horizontal) times a frame;
    * ``parallel.make_pyramid_sharded_estimate`` over 4 tiles at HD
      (levels 1 and 2) and 5 tiles at 380x450 (level 1): equal to the
      single card, the chunk kernel launched 6 times a tile; the single
      card there equal to ``backend="torch"``, which holds the SGM
      kernels at the coarse shapes (512x640 D=128, 256x320 D=64,
      190x225 D=64) against their plain version;
    * ``TemporalPipeline(128, keyframe_interval=4)`` on the golden's
      8-frame video, single-card and over 5 row tiles: each frame and
      both keyframe counters equal to the golden's; keyframes launch the
      SGM kernels (sharded: the chunk kernel), tracked frames none.

    Returns ms/frame (CUDA events, median of REPS) of the pyramids, the
    sharded pyramids, tracked frames and keyframes at teddy and HD, and
    the profiler's view of pyramid1 and a tracked frame at both."""
    from stereomatch_tpu_torch import parallel
    from stereomatch_tpu_torch.io.synthetic import (stereo_pair,
                                                    stereo_sequence)
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    from stereomatch_tpu_torch.temporal import TemporalPipeline

    golden = np.load(GOLDEN_PYRAMID)
    left, right, gt, d, _ = shapes["teddy"]
    out = {"ms": {}, "profile": {}}
    for levels in (1, 2):
        for dtype in ("float32", "bfloat16"):
            sfx = "_bf16" if dtype == "bfloat16" else ""
            label = f"pyramid{levels} {dtype}"
            log(f"[pyramid] {label}, teddy 375x450 D=128")
            pipe = PyramidPipeline(d, levels=levels, cost_dtype=dtype)
            disp_np, counts = run_path(
                label, lambda: pipe.estimate(left.cpu().numpy(),
                                             right.cpu().numpy()),
                (f"sgm_rows{sfx}", f"sgm_horizontal{sfx}"))
            require(counts[f"sgm_rows{sfx}"] == 6
                    and counts[f"sgm_horizontal{sfx}"] == 2
                    and counts["sgm_chunk"] == 0,
                    f"{label} launches {counts}")
            key = pyramid_golden_key(levels, dtype)
            check_golden(key, disp_np, golden[key], gt, d, 0,
                         float(golden[f"bad_pixel_{key}"]), 0.0)
            plain = PyramidPipeline(d, levels=levels, cost_dtype=dtype,
                                    backend="torch")
            require(np.array_equal(plain.estimate(left, right).cpu().numpy(),
                                   disp_np),
                    f"{label}: the kernels differ from backend='torch'")
            log("  equal to backend='torch' on the card")
            if not sfx:
                refined = pipe.estimate_refined(left, right).cpu().numpy()
                key = f"pyramid{levels}_refined"
                n_diff = int((refined != golden[key]).sum())
                log(f"  estimate_refined: {n_diff} pixels differ from "
                    f"golden {key}")
                require(n_diff == 0, f"{key} differs at {n_diff} pixels")
            out["ms"][f"{label} teddy"] = time_ms(
                torch, lambda: pipe.estimate(left, right))
            log(f"  {label} teddy: {out['ms'][f'{label} teddy']!r} "
                f"ms/frame [{card}]")
            del pipe, plain
    torch.cuda.empty_cache()

    hd_left, hd_right, _, hd_d, _ = shapes["hd"]
    l380, r380, _ = stereo_pair(380, 450, 128, seed=2026)
    l380 = torch.from_numpy(l380).to(dev)
    r380 = torch.from_numpy(r380).to(dev)
    for tag, (sl, sr, sd), tiles, levels in (
            ("hd", shapes["hd"][:2] + (hd_d,), 4, 1),
            ("hd", shapes["hd"][:2] + (hd_d,), 4, 2),
            ("380x450", (l380, r380, 128), 5, 1)):
        label = f"sharded pyramid{levels} {tag}, {tiles} tiles"
        log(f"[pyramid] {label} on {dev}, against the single card")
        single = PyramidPipeline(sd, levels=levels)
        want = single.estimate(sl, sr).cpu().numpy()
        plain = PyramidPipeline(sd, levels=levels, backend="torch")
        n_diff = int((plain.estimate(sl, sr).cpu().numpy() != want).sum())
        log(f"  single card against backend='torch': {n_diff} pixels differ")
        require(n_diff == 0, f"pyramid{levels} {tag}: the kernels differ "
                f"from backend='torch' at {n_diff} pixels")
        fn = parallel.make_pyramid_sharded_estimate(
            parallel.make_mesh([dev] * tiles, n_batch=1), max_disparity=sd,
            levels=levels)
        disp_np, counts = run_path(label, lambda: fn(sl[None], sr[None])[0],
                                   ("sgm_chunk", "sgm_horizontal"),
                                   shape=tuple(sl.shape), d=sd)
        require(counts["sgm_chunk"] == 6 * tiles and counts["sgm_rows"] == 0,
                f"{label} launches {counts}")
        n_diff = int((disp_np != want).sum())
        log(f"  pixels differing from the single card: {n_diff}")
        require(n_diff == 0, f"{label} differs at {n_diff} pixels")
        if tag == "hd":
            out["ms"][f"pyramid{levels} float32 hd"] = time_ms(
                torch, lambda: single.estimate(sl, sr))
            out["ms"][label] = time_ms(torch, lambda: fn(sl[None], sr[None]))
            log(f"  pyramid{levels} hd single card "
                f"{out['ms'][f'pyramid{levels} float32 hd']!r} ms/frame, "
                f"sharded {out['ms'][label]!r} ms/frame [{card}]")
        del single, plain, fn
        torch.cuda.empty_cache()
    del l380, r380

    h, w = int(golden["height"]), int(golden["width"])
    video = pyramid_video(golden)
    interval = int(golden["keyframe_interval"])
    for label, kw, key_kernel, key_launches in (
            ("temporal", {}, "sgm_rows", 6),
            ("sharded temporal, 5 tiles",
             dict(mesh=parallel.make_mesh([dev] * 5, n_batch=1)),
             "sgm_chunk", 30)):
        log(f"[temporal] {label}: the golden's 8-frame teddy video, "
            f"keyframe_interval={interval}")
        pipe = TemporalPipeline(d, keyframe_interval=interval, **kw)
        for i, (fl, fr, _) in enumerate(video):
            before = pipe.keyframes
            disp_np, counts = run_path(f"{label} frame {i}",
                                       lambda: pipe.estimate(fl, fr), ())
            keyframe = pipe.keyframes > before
            require((counts[key_kernel] == key_launches) if keyframe
                    else sum(counts.values()) == 0,
                    f"{label} frame {i} (keyframe {keyframe}) launches "
                    f"{counts}")
            n_diff = int((disp_np != golden["video"][i]).sum())
            require(n_diff == 0 and pipe.keyframes == golden["keyframes"][i]
                    and pipe.drift_keyframes == golden["drift_keyframes"][i],
                    f"{label} frame {i}: {n_diff} pixels off the golden, "
                    f"keyframes {pipe.keyframes}/{pipe.drift_keyframes}")
            if not keyframe:
                require(np.array_equal(pipe.host_disparity().numpy(),
                                       disp_np),
                        "the pinned host copy differs from the disparity")
        log(f"  8 frames 0 pixels off the golden; keyframes "
            f"{pipe.keyframes}, drift keyframes {pipe.drift_keyframes}")
        del pipe

    for tag, (sh, sw, sd, seed) in (("teddy", (h, w, d, 2026)),
                                    ("hd", (1024, 1280, hd_d, 11))):
        (l0, r0, _), (l1, r1, _) = stereo_sequence(sh, sw, sd, 2, seed=seed,
                                                   motion=1)
        pipe = TemporalPipeline(sd, keyframe_interval=0)
        l1 = torch.from_numpy(l1).to(dev)
        r1 = torch.from_numpy(r1).to(dev)
        pipe.estimate(l0, r0)
        out["ms"][f"tracked frame {tag}"] = time_ms(
            torch, lambda: pipe.estimate(l1, r1))
        require(pipe.keyframes == 1, f"tracking {tag} lost its anchor")
        out["ms"][f"keyframe {tag}"] = time_ms(
            torch, lambda: pipe.keyframe.estimate(l1, r1))
        log(f"  {tag}: tracked frame {out['ms'][f'tracked frame {tag}']!r} "
            f"ms (host read included), keyframe "
            f"{out['ms'][f'keyframe {tag}']!r} ms [{card}]")
        pyr = PyramidPipeline(sd, levels=1)
        sl, sr = shapes[tag][:2]
        for name, fn in (("pyramid1", lambda: pyr.estimate(sl, sr)),
                         ("tracked frame", lambda: pipe.estimate(l1, r1))):
            wall, by_name, spans, ops = profile_path(torch, fn)
            busy = sum(by_name.values())
            require(busy > 0, f"the profiler saw no device time in {name}")
            out["profile"][f"{name} {tag}"] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall, "device_ops": ops}
            log(f"  {name} {tag}: wall {wall!r} ms/frame, device busy "
                f"{busy!r}, idle share {1.0 - busy / wall!r}, {ops!r} device "
                f"operations/frame [{card}]")
            for kname, ms in sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:5]:
                log(f"    {ms!r} ms/frame  {kname[:90]}")
        del pipe, pyr
        torch.cuda.empty_cache()
    return out


def check_tune(torch, dev, shapes, card) -> dict:
    """The differentiable surface on the card: the soft SGM's forward pass
    at teddy equal to the SGM kernels' aggregation bit for bit; a tune
    step at teddy timed (host clock, 2 steps after one, the volume built
    in each run) with its peak memory above what was already held; ``tune_penalties`` at 96x128, D=32 on the
    card against the CPU within TUNE_RTOL (the card's exp and sums are
    not the CPU's); ``stm-eval`` with ``--tune`` on the card against the
    CPU."""
    from stereomatch_tpu_torch import tune
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import cost as cost_ops
    from stereomatch_tpu_torch.ops import sgm_cuda
    from stereomatch_tpu_torch.ops.soft import semiglobal_aggregate_diff

    left, right, gt, d, _ = shapes["teddy"]
    out = {}
    log("[soft sgm] semiglobal_aggregate_diff at teddy (census volume) "
        "against the SGM kernels")
    vol = cost_ops.census_hamming_cost_volume(left, right, max_disparity=d)
    for p1, p2 in ((0.1, 0.2), (3.0, 9.0)):
        want = sgm_cuda.semiglobal_aggregate_cuda(vol, left, penalty1=p1,
                                                  penalty2=p2)
        got = semiglobal_aggregate_diff(vol, left, p1, p2)
        compare(f"soft forward P1={p1} P2={p2}", want, got, 0, 0,
                exact=True)
    out["soft_forward_ms"] = time_ms(
        torch, lambda: semiglobal_aggregate_diff(vol, left, 0.1, 0.2),
        warmup=1, reps=3)
    log(f"  soft forward teddy: {out['soft_forward_ms']!r} ms [{card}]")
    del vol, want, got

    log("[tune] tune_penalties, teddy 375x450 D=128, one scene")
    scenes = [(left, right, gt)]
    tune.tune_penalties(scenes, max_disparity=d, steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    start = time.perf_counter()
    res = tune.tune_penalties(scenes, max_disparity=d, steps=2)
    torch.cuda.synchronize()
    out["teddy_step_ms"] = (time.perf_counter() - start) * 1e3 / 2
    # The tuner's own peak: what the run allocated above what was held.
    out["teddy_peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                      - held)
    require(np.all(np.isfinite(res.loss_history)),
            f"tune losses {res.loss_history}")
    log(f"  {out['teddy_step_ms']!r} ms/step, peak memory "
        f"{out['teddy_peak_memory_bytes'] / 2**30!r} GiB; losses "
        f"{res.loss_history.tolist()} [{card}]")
    torch.cuda.empty_cache()

    log(f"[tune] 96x128 D=32, 2 scenes, 8 steps: card against CPU within "
        f"{TUNE_RTOL}")
    small = [stereo_pair(96, 128, 32, seed=s) for s in (7, 8)]
    kw = dict(max_disparity=32, steps=8, tau=0.5, learning_rate=0.1)
    on_card = tune.tune_penalties(small, **kw)
    on_cpu = tune.tune_penalties(small, device="cpu", **kw)
    for name in ("loss_history", "penalty_history"):
        a, b = getattr(on_card, name), getattr(on_cpu, name)
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        log(f"  {name}: largest relative difference {rel!r}")
        require(rel <= TUNE_RTOL, f"tune {name}: card {a}, CPU {b}")

    log(f"[stm-eval] {' '.join(TUNE_EVAL_ARGS)}, on the card and the CPU")
    from stereomatch_tpu_torch.cli import evaluate
    with tempfile.TemporaryDirectory() as tmp:
        card_json, cpu_json = Path(tmp) / "card.json", Path(tmp) / "cpu.json"
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "stereomatch_tpu_torch.cli.evaluate",
             *TUNE_EVAL_ARGS, "--json", str(card_json)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        out["eval_tune_card_s"] = time.perf_counter() - start
        require(proc.returncode == 0, f"stm-eval --tune failed: "
                f"{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            log(f"    {line}")
        require(evaluate.main([*TUNE_EVAL_ARGS, "--device", "cpu", "--json",
                               str(cpu_json)]) == 0, "stm-eval --tune on CPU")
        card_rows = json.loads(card_json.read_text())
        cpu_rows = json.loads(cpu_json.read_text())
    require([r["name"] for r in card_rows] == ["census-wta-sgm-tuned",
                                               "pyramid1"],
            f"stm-eval rows {[r['name'] for r in card_rows]}")
    tuned, pyr = zip(card_rows, cpu_rows)
    for key in ("penalty1", "penalty2"):
        rel = abs(tuned[0][key] - tuned[1][key]) / abs(tuned[1][key])
        log(f"  tuned {key}: card {tuned[0][key]!r}, CPU {tuned[1][key]!r}")
        require(rel <= TUNE_RTOL, f"stm-eval tuned {key} differs by {rel}")
    for key in ("rmse", "avg_abs_error", "bad_pixel_ratio"):
        rel = abs(pyr[0][key] - pyr[1][key]) / max(abs(pyr[1][key]), 1e-12)
        require(rel <= 1e-6, f"stm-eval pyramid1 {key}: card {pyr[0][key]}, "
                f"CPU {pyr[1][key]}")
        log(f"  census-wta-sgm-tuned {key}: card {tuned[0][key]!r}, CPU "
            f"{tuned[1][key]!r}")
    log(f"  pyramid1 metrics equal the CPU's within 1e-6; card run "
        f"{out['eval_tune_card_s']:.1f} s")
    return out


def teddy_video(golden, n_scenes=STREAM_SCENES):
    """``n_scenes`` different side-by-side teddy frames [375, 900] uint8:
    the golden scene, then the scenes of the seeds after it."""
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    seed = int(golden["seed"])
    frames = []
    for i in range(n_scenes):
        left, right, _ = stereo_pair(375, 450, 128, seed=seed + i)
        frames.append(np.concatenate([(left * 255).astype(np.uint8),
                                      (right * 255).astype(np.uint8)],
                                     axis=1))
    return frames


def launch_counts(counters, launches) -> dict:
    return {name: sum(launches[e] for e in entries)
            for name, entries in counters.items()}


def check_stream(torch, dev, golden, counters, card) -> dict:
    """``stream.StreamingEstimator.run`` over ``io.capture.Y4MCapture`` (the
    port's libstmio binding) on the card, each run of STREAM_RUNS with
    the launch counts set to 0 just before it and read just after:
    STREAM_FRAMES teddy frames (STREAM_SCENES scenes in turn, written
    with ``native.write_y4m``), then HD_STREAM_FRAMES HD frames.  Every
    yielded disparity equals ``Pipeline.estimate`` (``estimate_refined``,
    ``PyramidPipeline.estimate``) of the same uint8 frame on the card;
    the run launched each kernel of its path, and its launches a frame
    (a replayed frame counting its graph's) equal an eager frame's.  A
    second run of each estimator is timed with the host clock (frames/s
    and the stage split), beside ``Pipeline.estimate`` timed with CUDA
    events on device-resident images; one batched run is profiled for
    the device's idle share."""
    from stereomatch_tpu_torch import cli_common, native
    from stereomatch_tpu_torch.io.capture import Y4MCapture
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import _build
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    from stereomatch_tpu_torch.stream import StreamingEstimator

    k = int(golden["kernel_size"])
    p1, p2 = float(golden["penalty1"]), float(golden["penalty2"])
    out = {"runs": []}

    def reference(d, options, kernel_size):
        """(frame function on uint8 pair -> card tensor, the kernels the
        path launches)."""
        sfx = "_bf16" if options.get("cost_dtype") == "bfloat16" else ""
        flat = (f"ssd{sfx}", f"sgm_rows{sfx}", f"sgm_horizontal{sfx}")
        if options.get("pyramid_levels"):
            pyr = PyramidPipeline(d, levels=options["pyramid_levels"],
                                  penalty1=p1, penalty2=p2)
            return pyr.estimate, ("sgm_rows", "sgm_horizontal")
        dyn = options.get("reducer") == "dynamic_programming"
        pipe = cli_common.create_pipeline(
            "ssd", "dyn" if dyn else "wta", "sgm", max_disparity=d,
            penalty1=p1, penalty2=p2,
            volume_dtype=options.get("cost_dtype", "float32"),
            kernel_size=kernel_size)
        if options.get("subpixel"):
            return (lambda l, r: pipe.estimate_refined(l, r, subpixel=True,
                                                       median=True), flat)
        return pipe.estimate, flat + (("dp_forward", "dp_backward")
                                      if dyn else ())

    def on_card(frame):
        w = frame.shape[1] // 2
        return (torch.from_numpy(frame[:, :w]).to(dev).float(),
                torch.from_numpy(frame[:, w:]).to(dev).float())

    def stream_runs(tag, path, scenes, n_frames, d, runs, kernel_size):
        for batch, depth, options in runs:
            label = (f"{tag} batch {batch} depth {depth} "
                     f"{options or 'ssd+sgm+wta'}")
            log(f"[stream] {label}")
            frame_fn, kernels = reference(d, options, kernel_size)
            pairs = [on_card(f) for f in scenes]
            refs = [frame_fn(*p).cpu().numpy() for p in pairs]
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            frame_fn(*pairs[0])
            torch.cuda.synchronize()
            eager = collections.Counter(_build.LAUNCHES)
            est = StreamingEstimator(d, batch=batch, depth=depth,
                                     kernel_size=kernel_size, penalty1=p1,
                                     penalty2=p2, **options)
            # The counted run: counts from 0 just before, read just after.
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            cap = Y4MCapture(path)
            outs = list(est.run(cap))
            cap.close()
            torch.cuda.synchronize()
            counts = launch_counts(counters, _build.LAUNCHES)
            stream_counts = launch_counts(counters, est.stats.launches)
            require(len(outs) == n_frames, f"{label}: {len(outs)} frames")
            for i, (_, disp) in enumerate(outs):
                ref = refs[i % len(scenes)]
                require(disp.dtype == (np.float32 if ref.dtype == np.float32
                                       else np.int32)
                        and np.array_equal(disp, ref),
                        f"{label}: frame {i} differs from the pipeline's")
            for name in kernels:
                require(counts[name] > 0 and stream_counts[name] > 0,
                        f"{label} launched {name} no time")
            n_run = est.stats.frames_run
            require(est.stats.launches == collections.Counter(
                {e: c * n_run for e, c in eager.items()}),
                f"{label}: launches {dict(est.stats.launches)} over "
                f"{n_run} frames, an eager frame {dict(eager)}")
            # The timed run, warm.
            cap = Y4MCapture(path)
            n = sum(1 for _ in est.run(cap))
            cap.close()
            require(n == n_frames, f"{label}: timed run {n} frames")
            s = est.stats
            estimate_ms = time_ms(torch, lambda: frame_fn(*pairs[0]))
            row = {"tag": tag, "batch": batch, "depth": depth,
                   "options": options, "frames": s.frames,
                   "fps": s.fps, "stage_ms_per_frame":
                       s.stage_ms_per_frame(),
                   "estimate_ms": estimate_ms,
                   "estimate_fps": 1e3 / estimate_ms,
                   "launches_per_frame": {e: c // n_run for e, c in
                                          est.stats.launches.items()},
                   "graph": est._compiled is not None}
            out["runs"].append(row)
            log(f"  {n_frames} frames equal the pipeline's; launches a "
                f"frame {row['launches_per_frame']} = an eager frame's; "
                f"{s.fps!r} frames/s (host clock), stages ms/frame "
                f"{row['stage_ms_per_frame']}; Pipeline.estimate "
                f"{estimate_ms!r} ms = {1e3 / estimate_ms!r} frames/s "
                f"(CUDA events, device-resident) [{card}]")
            del est, pairs
            torch.cuda.empty_cache()

    teddy = teddy_video(golden)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "teddy.y4m"
        native.write_y4m(path, np.stack([teddy[i % len(teddy)]
                                         for i in range(STREAM_FRAMES)]))
        stream_runs("teddy", path, teddy, STREAM_FRAMES, 128, STREAM_RUNS,
                    k)

        log("[stream profile] teddy batch 4 depth 2, one run of "
            f"{STREAM_FRAMES} frames")
        est = StreamingEstimator(128, batch=4, depth=2, kernel_size=k,
                                 penalty1=p1, penalty2=p2)

        def one_run():
            cap = Y4MCapture(path)
            for _ in est.run(cap):
                pass
            cap.close()

        wall, by_name, _, ops = profile_path(torch, one_run, frames=1)
        busy = sum(by_name.values())
        require(busy > 0, "the profiler saw no device time in the stream")
        out["profile"] = {"wall_ms_per_frame": wall / STREAM_FRAMES,
                          "busy_ms_per_frame": busy / STREAM_FRAMES,
                          "idle_share": 1.0 - busy / wall,
                          "device_ops_per_frame": ops / STREAM_FRAMES}
        log(f"  wall {wall / STREAM_FRAMES!r} ms/frame, device busy "
            f"{busy / STREAM_FRAMES!r} ms/frame, idle share "
            f"{1.0 - busy / wall!r}, {ops / STREAM_FRAMES!r} device "
            f"operations/frame [{card}]")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {ms / STREAM_FRAMES!r} ms/frame  {name[:90]}")
        del est

        hd = []
        for i in range(HD_STREAM_SCENES):
            left, right, _ = stereo_pair(1024, 1280, 256, seed=11 + i)
            hd.append(np.concatenate([(left * 255).astype(np.uint8),
                                      (right * 255).astype(np.uint8)],
                                     axis=1))
        path.unlink()
        path = Path(tmp) / "hd.y4m"
        native.write_y4m(path, np.stack([hd[i % len(hd)] for i in
                                         range(HD_STREAM_FRAMES)]))
        stream_runs("hd", path, hd, HD_STREAM_FRAMES, 256, HD_STREAM_RUNS,
                    7)
    return out


def check_video_cli(torch, golden, card) -> dict:
    """``stm-video`` on a teddy Y4M: each of VIDEO_RUNS on the card (those
    of VIDEO_SUBPROCESS as ``python -m stereomatch_tpu_torch.cli.video``,
    the others through its ``main`` in this process), its PNGs of the
    first VIDEO_CPU_FRAMES frames equal to the same command's in this
    process with ``--device cpu --max-frames VIDEO_CPU_FRAMES``.  Returns
    the card runs' wall seconds (a subprocess's with its start) and
    frames/s over them."""
    from stereomatch_tpu_torch import native
    from stereomatch_tpu_torch.cli import video
    from stereomatch_tpu_torch.io import png

    frames = teddy_video(golden)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "teddy.y4m"
        native.write_y4m(path, np.stack(frames))
        for name, flags in VIDEO_RUNS.items():
            base = ["y4m", str(path), "128", "--headless", *flags]
            log(f"[stm-video] {name}: {' '.join(base[2:])}")
            card_argv = [*base, "--output-dir", str(tmp / f"{name}_card")]
            start = time.perf_counter()
            if name in VIDEO_SUBPROCESS:
                proc = subprocess.run(
                    [sys.executable, "-m",
                     "stereomatch_tpu_torch.cli.video", *card_argv],
                    cwd=ROOT, capture_output=True, text=True, timeout=600)
                rc, said = proc.returncode, proc.stdout.strip()
                where, err = "a subprocess, its start included", proc.stderr
            else:
                rc, said = video.main(card_argv), ""
                where, err = "in this process", ""
            seconds = time.perf_counter() - start
            require(rc == 0, f"stm-video {name} failed on the card: {err}")
            log(f"  card: {said} ({seconds:.2f} s wall, {where}) [{card}]")
            require(video.main([*base, "--device", "cpu", "--max-frames",
                                str(VIDEO_CPU_FRAMES), "--output-dir",
                                str(tmp / f"{name}_cpu")]) == 0,
                    f"stm-video {name} --device cpu failed")
            card_pngs = sorted((tmp / f"{name}_card").glob("depth_*.png"))
            cpu_pngs = sorted((tmp / f"{name}_cpu").glob("depth_*.png"))
            require(len(card_pngs) == len(frames)
                    and len(cpu_pngs) == VIDEO_CPU_FRAMES,
                    f"stm-video {name}: {len(card_pngs)} card PNGs, "
                    f"{len(cpu_pngs)} CPU PNGs")
            for a, b in zip(card_pngs, cpu_pngs):
                require(np.array_equal(png.read(a).array,
                                       png.read(b).array),
                        f"stm-video {name}: {a.name} differs from the "
                        f"CPU's")
            out[name] = {"wall_s": seconds, "frames": len(frames),
                         "fps_wall": len(frames) / seconds,
                         "subprocess": name in VIDEO_SUBPROCESS}
            log(f"  the first {VIDEO_CPU_FRAMES} PNGs equal the CPU's "
                f"pixel for pixel")
    return out


def check_serve(torch, golden, counters, card) -> dict:
    """``stm-serve`` (``cli.serve.make_server``) in this process, port 0,
    teddy ssd+sgm+wta, once for each of SERVE_RUNS, the launch counts set
    to 0 before and read after: SERVE_REQUESTS requests from
    SERVE_CLIENTS client threads, npy and PNG bodies, npy and png16
    responses, some with ``refine=1``, each decoded and equal to the
    local ``Pipeline.estimate`` (``estimate_refined``) of its frame on
    the card.  Returns requests/s, client latency p50/p99 and /healthz's
    stage windows; closing the server must leave no thread of it."""
    import threading
    import urllib.request

    from stereomatch_tpu_torch import cli_common
    from stereomatch_tpu_torch.cli import serve
    from stereomatch_tpu_torch.io import png
    from stereomatch_tpu_torch.ops import _build

    frames = teddy_video(golden)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=128)
    plain, refined, bodies = [], [], []
    for frame in frames:
        left = torch.from_numpy(frame[:, :450]).to("cuda").float()
        right = torch.from_numpy(frame[:, 450:]).to("cuda").float()
        plain.append(pipe.estimate(left, right).cpu().numpy())
        refined.append(pipe.estimate_refined(left, right).cpu().numpy())
        buf = io.BytesIO()
        np.save(buf, frame)
        bodies.append({"npy": buf.getvalue(), "png": png.encode(frame)})

    def request(j):
        """(scene, body kind, response format, refine) of request j."""
        return (j % len(frames), ("npy", "png")[j % 2],
                ("npy", "png16")[(j // 2) % 2], j % 16 == 0)

    out = {}
    for flags in SERVE_RUNS:
        label = " ".join(flags)
        log(f"[stm-serve] 128 -cm ssd -am sgm {label}: {SERVE_REQUESTS} "
            f"requests from {SERVE_CLIENTS} clients")
        before = {t.ident for t in threading.enumerate()}
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        args = serve.build_parser().parse_args(
            ["128", "-cm", "ssd", "-am", "sgm", "--port", "0", *flags])
        srv = serve.make_server(args)
        thread = threading.Thread(target=srv.serve_forever)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_port}"
        latencies, responses, failures = [], {}, []

        def post(j):
            scene, kind, fmt, refine = request(j)
            query = f"format={fmt}" + ("&refine=1" if refine else "")
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    f"{url}/estimate?{query}", data=bodies[scene][kind]),
                    timeout=300) as resp:
                responses[j] = resp.read()
            latencies.append(time.perf_counter() - t0)

        def check(j):
            """Response j decoded against the local pipeline (after the
            timed window: the clients share this process's interpreter
            lock with the server)."""
            scene, _, fmt, refine = request(j)
            raw = responses.pop(j)
            got = (np.load(io.BytesIO(raw)) if fmt == "npy"
                   else png.decode(raw).array)
            want = refined[scene] if refine else plain[scene]
            if fmt == "png16":
                want = np.clip(np.round(want), 0, 65535).astype(np.uint16)
            if not (got.shape == want.shape
                    and np.array_equal(got.astype(want.dtype), want)):
                failures.append(j)

        def client(c):
            try:
                for j in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                    post(j)
            except Exception as err:               # noqa: BLE001
                failures.append(repr(err))

        try:
            for j in (0, 1, 16, 17):               # build, capture: untimed
                post(j)
                check(j)
            latencies.clear()
            start = time.perf_counter()
            clients = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(600)
            wall = time.perf_counter() - start
            with urllib.request.urlopen(f"{url}/healthz") as resp:
                health = json.loads(resp.read())
            for j in sorted(responses):
                check(j)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(60)
        torch.cuda.synchronize()
        counts = launch_counts(counters, _build.LAUNCHES)
        left = [t.name for t in threading.enumerate()
                if t.ident not in before]
        require(not failures, f"stm-serve {label}: requests {failures} "
                f"differ from the local pipeline or failed")
        require(len(latencies) == SERVE_REQUESTS and not responses,
                f"stm-serve {label}: {len(latencies)} responses")
        require(not left, f"stm-serve {label}: threads left {left}")
        for name in ("ssd", "sgm_rows", "sgm_horizontal"):
            require(counts[name] > 0, f"stm-serve {label} launched {name} "
                    f"no time")
        lat = sorted(latencies)
        row = {"requests_per_s": SERVE_REQUESTS / wall,
               "p50_ms": lat[len(lat) // 2] * 1e3,
               "p99_ms": lat[min(int(len(lat) * 0.99), len(lat) - 1)] * 1e3,
               "healthz_stages": health.get("stages"),
               "healthz_latency": health.get("latency"),
               "batching": health.get("batching")}
        out[label] = row
        log(f"  {SERVE_REQUESTS} responses equal the local pipeline's; "
            f"{row['requests_per_s']!r} requests/s, p50 {row['p50_ms']!r} "
            f"ms, p99 {row['p99_ms']!r} ms (client clock); /healthz "
            f"stages {row['healthz_stages']}; batching "
            f"{row['batching']}; no thread left; launches {counts} "
            f"[{card}]")
    return out


def check_partitioners(torch, dev, shapes, run_path, golden, p1, p2,
                       card) -> dict:
    """The disparity blocks, the 2-D tiles and the mesh CLIs (A.14a-c),
    each against the single-card path at 0 differing pixels, its launches
    counted from 0 around one frame and read after it, timed with CUDA
    events (PARTITION_WARMUP, PARTITION_REPS) and every volume freed
    before the next path:

    * ``make_disp_sharded_wta`` over 4 blocks on ``dev`` (and one block a
      card where there are several) at HD: ssd+wta at D = 256 and 1024,
      census+cvf+wta at D = 256 (the registry's K9 wedge path is the
      single-card one), the profiler showing the SSD and CVF kernels;
    * ``make_tiled2d_estimate`` over (1, 2, 2) on ``dev`` at HD: ssd+sgm
      with WTA, with DP and with the LR check, median and background
      speckle fill at the covering overlap 640, and the share of pixels
      off the single card at the default overlap 48 (under 0.02); each
      tile launching the SSD and SGM kernels, the profiler showing them;
      census+cvf+wta at teddy over (1, 3, 3) against the single-card
      masked filter;
    * ``stm-video --mesh`` on the teddy Y4M against the same run without
      ``--mesh``, and ``stm-serve --mesh`` answering requests equal to the
      card's pipeline.

    Returns the paths' times (ms a frame, CUDA events) and launches."""
    import threading
    import urllib.request

    from stereomatch_tpu_torch import cli_common, native, parallel
    from stereomatch_tpu_torch.aggregation import CostFilter
    from stereomatch_tpu_torch.cli import serve, video
    from stereomatch_tpu_torch.io import png
    from stereomatch_tpu_torch.ops import refine

    out = {}
    left, right, _, hd_d, hd_k = shapes["hd"]
    n_cards = torch.cuda.device_count()

    def timed(label, fn, frames=1):
        ms = time_ms(torch, fn, warmup=PARTITION_WARMUP,
                     reps=PARTITION_REPS) / frames
        log(f"  {label}: {ms!r} ms/frame (CUDA events, median of "
            f"{PARTITION_REPS}) [{card}]")
        return ms

    def profiled(label, fn, names):
        _, by_name, _, _ = profile_path(torch, fn, frames=1)
        for name in names:
            require(any(name in k for k in by_name),
                    f"the profiler saw no {name} in {label}")
        log(f"  profiler: {', '.join(names)} on the device timeline")

    def equal(label, got, want):
        n_diff = int((np.asarray(got) != np.asarray(want)).sum())
        log(f"  pixels differing from the single-card path: {n_diff} of "
            f"{np.asarray(want).size}")
        require(n_diff == 0, f"{label} differs from the single-card path "
                f"at {n_diff} pixels")

    # Disparity blocks at HD.
    block_runs = (("ssd+wta", dict(), hd_d), ("ssd+wta", dict(), 1024),
                  ("census+cvf+wta", dict(cost="census", aggregation="cvf"),
                   hd_d))
    for label, kw, d in block_runs:
        single = cli_common.create_pipeline(
            kw.get("cost", "ssd"), "wta", kw.get("aggregation"),
            max_disparity=d, kernel_size=hd_k if "cost" not in kw else None)
        want = single.estimate(left, right).cpu().numpy()
        del single
        torch.cuda.empty_cache()
        kernels = (("cvf", "cvf_filter") if "cost" in kw else ("ssd",))
        layouts = [("4 blocks on " + str(dev), [dev] * 4)]
        if n_cards > 1:
            layouts.append((f"{min(n_cards, 4)} blocks, one a card",
                            [torch.device("cuda", i)
                             for i in range(min(n_cards, 4))]))
        for where, devices in layouts:
            log(f"[partitioners] disparity blocks, {label} hd 1024x1280 "
                f"D={d}, {where}")
            fn = parallel.make_disp_sharded_wta(
                parallel.make_disp_mesh(devices), max_disparity=d,
                kernel_size=None if "cost" in kw else hd_k, **kw)
            got, counts = run_path(f"disparity blocks {label}",
                                   lambda: fn(left, right), kernels,
                                   shape=(1024, 1280), d=d)
            for name in kernels:
                require(counts[name] == len(devices),
                        f"disparity blocks {label}: {counts[name]} {name} "
                        f"launches for {len(devices)} blocks")
            equal(f"disparity blocks {label} D={d}", got, want)
            key = f"disp_blocks {label} D={d} {len(devices)}x"
            if where.startswith("4 blocks on"):
                profiled(f"disparity blocks {label}",
                         lambda: fn(left, right),
                         ("ssd_kernel",) if "cost" not in kw
                         else ("cvf_kernel",))
            out[key] = {"ms": timed(key, lambda: fn(left, right)),
                        "launches": {n: counts[n] for n in kernels}}
            del fn
            torch.cuda.empty_cache()

    # 2-D tiles at HD over (1, 2, 2) on one card.
    mesh4 = parallel.make_mesh_2d([dev] * 4, n_batch=1, n_tile=2,
                                  n_tile_w=2)
    pipe_wta = cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=hd_d, penalty1=p1,
                                          penalty2=p2, kernel_size=hd_k)
    agg = pipe_wta.aggregation(pipe_wta.cost(left, right), left)
    single_wta = disp_wta = pipe_wta.disparity_reduce(agg)
    mask = refine.left_right_consistency(
        disp_wta, refine.right_disparity_from_volume(agg), 1,
        max_disparity=hd_d)
    single_refined = refine.filter_speckles(
        refine.median_filter_3x3(refine.fill_inconsistent(disp_wta, mask)),
        fill="background").cpu().numpy()
    single_wta = single_wta.cpu().numpy()
    del agg, mask, disp_wta
    pipe_dyn = cli_common.create_pipeline("ssd", "dyn", "sgm",
                                          max_disparity=hd_d, penalty1=p1,
                                          penalty2=p2, kernel_size=hd_k)
    single_dyn = pipe_dyn.estimate(left, right).cpu().numpy()
    del pipe_wta, pipe_dyn
    torch.cuda.empty_cache()
    tile_kw = dict(max_disparity=hd_d, kernel_size=hd_k, penalty1=p1,
                   penalty2=p2)
    tile_runs = (
        ("ssd+sgm+wta", dict(overlap=640), single_wta, torch.int32),
        ("ssd+sgm+dyn", dict(overlap=640, reducer="dynamic_programming"),
         single_dyn, torch.int32),
        ("ssd+sgm+wta lr+median+speckle", dict(
            overlap=640, lr_check=True, median=True, speckle=True,
            speckle_fill="background"), single_refined, torch.float32),
        ("ssd+sgm+wta overlap 48", dict(overlap=48), single_wta,
         torch.int32))
    for label, kw, want, dtype in tile_runs:
        log(f"[partitioners] 2-D tiles (1, 2, 2) on {dev}, {label}, hd "
            f"1024x1280 D={hd_d}")
        fn = parallel.make_tiled2d_estimate(mesh4, **tile_kw, **kw)
        frames = (left[None], right[None])
        got, counts = run_path(f"2-D tiles {label}",
                               lambda: fn(*frames)[0],
                               ("ssd", "sgm_rows", "sgm_horizontal"),
                               shape=(1024, 1280), d=hd_d, dtype=dtype)
        require(counts["ssd"] == 4 and counts["sgm_rows"] == 24
                and counts["sgm_horizontal"] == 8,
                f"2-D tiles {label}: launches {counts}, not one SSD and 8 "
                f"SGM traversals a tile")
        if kw["overlap"] == 48:
            share = float(np.mean(got != want))
            log(f"  share of pixels off the single card at overlap 48: "
                f"{share!r} (JAX's bound 0.02)")
            require(share < 0.02, f"2-D tiles at overlap 48 differ at a "
                    f"share {share!r} of pixels")
        else:
            equal(f"2-D tiles {label}", got, want)
        if label == "ssd+sgm+wta":
            profiled("2-D tiles", lambda: fn(*frames),
                     ("ssd_kernel", "sgm_rows_kernel",
                      "sgm_horizontal_kernel"))
        reps = 1 if "dyn" in label or "lr" in label else None
        key = f"tiled2d {label}"
        ms = (time_ms(torch, lambda: fn(*frames), warmup=0, reps=reps)
              if reps else timed(key, lambda: fn(*frames)))
        if reps:
            log(f"  {key}: {ms!r} ms/frame (CUDA events, one frame: plain "
                f"Python loops) [{card}]")
        out[key] = {"ms": ms, "launches": {
            n: counts[n] for n in ("ssd", "sgm_rows", "sgm_horizontal")}}
        del fn
        torch.cuda.empty_cache()
    del single_wta, single_dyn, single_refined

    t_left, t_right, _, t_d, _ = shapes["teddy"]
    log(f"[partitioners] 2-D tiles (1, 3, 3) on {dev}, census+cvf+wta, "
        f"teddy 375x450 D={t_d}, against the single-card masked filter")
    masked = cli_common.create_pipeline("census", "wta", "cvf",
                                        max_disparity=t_d)
    masked.aggregation = CostFilter(8, 1e-4, wedge_offset=None)
    want = masked.estimate(t_left, t_right).cpu().numpy()
    fn = parallel.make_tiled2d_estimate(
        parallel.make_mesh_2d([dev] * 9, n_batch=1, n_tile=3, n_tile_w=3),
        max_disparity=t_d, cost="census", aggregation="cvf")
    got, _ = run_path("2-D tiles census+cvf+wta",
                      lambda: fn(t_left[None], t_right[None])[0], (),
                      shape=(375, 450), d=t_d)
    equal("2-D tiles census+cvf+wta teddy", got, want)
    out["tiled2d census+cvf+wta teddy 3x3"] = {"ms": timed(
        "tiled2d census+cvf+wta teddy", lambda: fn(t_left[None],
                                                   t_right[None]))}
    del fn, masked
    torch.cuda.empty_cache()

    frames = teddy_video(golden)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "teddy.y4m"
        native.write_y4m(path, np.stack(frames))
        runs = {}
        for name, flags in (("per-frame", []), ("mesh", ["--mesh"])):
            argv = ["y4m", str(path), "128", "-am", "sgm", "--headless",
                    *flags, "--output-dir", str(tmp / name)]
            log(f"[partitioners] stm-video {' '.join(argv[2:-2])}")
            start = time.perf_counter()
            require(video.main(argv) == 0, f"stm-video {name} failed")
            runs[name] = time.perf_counter() - start
            log(f"  {runs[name]:.2f} s wall for {len(frames)} frames, in "
                f"this process [{card}]")
        for a, b in zip(sorted((tmp / "mesh").glob("depth_*.png")),
                        sorted((tmp / "per-frame").glob("depth_*.png"))):
            require(np.array_equal(png.read(a).array, png.read(b).array),
                    f"stm-video --mesh: {a.name} differs")
        require(len(list((tmp / "mesh").glob("depth_*.png")))
                == len(frames), "stm-video --mesh wrote too few PNGs")
        log(f"  {len(frames)} --mesh PNGs equal the run without --mesh")
        out["stm-video --mesh"] = {"wall_s": runs["mesh"],
                                   "wall_s_without_mesh": runs["per-frame"]}

    log("[partitioners] stm-serve --mesh --batch 4: 8 requests from 4 "
        "clients")
    pipe = cli_common.create_pipeline("census", "wta", "sgm",
                                      max_disparity=128)
    srv = serve.make_server(serve.build_parser().parse_args(
        ["128", "--port", "0", "--mesh", "--batch", "4"]))
    thread = threading.Thread(target=srv.serve_forever)
    thread.start()
    answers, failures = {}, []

    def client(c):
        try:
            for j in range(c, 8, 4):
                buf = io.BytesIO()
                np.save(buf, frames[j])
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{srv.server_port}/estimate"
                        f"?format=npy", data=buf.getvalue()),
                        timeout=300) as resp:
                    answers[j] = np.load(io.BytesIO(resp.read()))
        except Exception as err:                   # noqa: BLE001
            failures.append(repr(err))

    try:
        start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        wall = time.perf_counter() - start
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)
    require(not failures and len(answers) == 8,
            f"stm-serve --mesh: {failures}")
    for j, got in answers.items():
        frame = torch.from_numpy(frames[j]).to(dev).float()
        want = pipe.estimate(frame[:, :450], frame[:, 450:]).cpu().numpy()
        require(np.array_equal(got.astype(np.int32), want),
                f"stm-serve --mesh: response {j} differs from the card's "
                f"pipeline")
    log(f"  8 responses equal the card's pipeline; {wall:.2f} s wall, "
        f"builds included [{card}]")
    out["stm-serve --mesh"] = {"wall_s": wall}
    return out


def distributed_worker(rank: int, address: str) -> int:
    """One rank of ``check_distributed``: ``python3 chip_smoke.py
    --distributed-worker RANK HOST:PORT``.

    Joins the two-process gloo world (``initialize_distributed``), lays
    a (2, tiles) hybrid mesh over ``cuda:(RANK % cards)`` repeated, and
    runs each cell's global stack through ``ShardedPipeline``: its own
    frame must equal the single-card ``Pipeline.estimate`` at 0 pixels
    (rank 0's teddy frame also the golden), with the launches a frame
    stated, then ``sgm_mode="auto"`` must equal the mode it resolved to,
    bit for bit.  Both ranks time each run at once (a barrier before
    each), so they share the card.  Loads the kernels phase 2 built and
    prints one ``DISTRIBUTED_RESULT {json}`` line."""
    import logging

    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "stereomatch_tpu_torch").is_dir() and GOLDEN.is_file(),
            f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from stereomatch_tpu_torch import cli_common, parallel
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import _build
    from stereomatch_tpu_torch.parallel import mesh as mesh_mod

    built = _build.build()
    require(built.seconds == 0.0, f"rank {rank} built the kernels; phase 2 "
            f"builds them before the workers start")
    _build.library()
    parallel.initialize_distributed(
        coordinator_address=address, num_processes=2, process_id=rank,
        initialization_timeout=DIST_TIMEOUT_S)
    require(mesh_mod.process_count() == 2, "the world is not two processes")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    golden = np.load(GOLDEN)
    p1, p2 = float(golden["penalty1"]), float(golden["penalty2"])
    seed = int(golden["seed"])
    picks = []

    class Picks(logging.Handler):
        def emit(self, record):
            picks.append(record.getMessage())

    logger = logging.getLogger("stereomatch_tpu_torch.parallel.sharded")
    logger.setLevel(logging.INFO)
    logger.addHandler(Picks())

    def counted(fn):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, {name: sum(_build.LAUNCHES[e] for e in entries)
                     for name, entries in COUNTERS.items()}

    result = {"rank": rank, "device": str(dev)}
    geometry = {"teddy": (375, 450, 128, int(golden["kernel_size"]),
                          (seed, seed + 1)), "hd": DIST_HD}
    for tag, (h, w, d, k, seeds) in geometry.items():
        tiles, runs = DIST_CELLS[tag]
        scenes = [stereo_pair(h, w, d, seed=s) for s in seeds]
        left = np.stack([scene[0] for scene in scenes])
        right = np.stack([scene[1] for scene in scenes])
        mesh = parallel.make_hybrid_mesh(devices=[dev] * tiles)
        require(mesh.shape == {"batch": 2, "tile": tiles}
                and mesh.owned_rows() == [rank]
                and mesh.frame_indices(2) == [rank],
                f"rank {rank}: mesh {mesh.shape}, rows {mesh.owned_rows()}")
        gt = scenes[rank][2]
        singles, cell = {}, {}

        def sharded(**kw):
            return parallel.ShardedPipeline(mesh, d, kernel_size=k,
                                            penalty1=p1, penalty2=p2, **kw)

        for label, (kw, want, golden_key) in runs.items():
            reducer = "dyn" if "reducer" in kw else "wta"
            if reducer not in singles:
                pipe = cli_common.create_pipeline(
                    "ssd", reducer, "sgm", max_disparity=d, penalty1=p1,
                    penalty2=p2)
                pipe.cost.kernel_size = k
                singles[reducer] = pipe.estimate(
                    left[rank], right[rank], device=dev).cpu().numpy()
            log(f"[rank {rank}] {label} {tag}, frame {rank} of a "
                f"(2, {tiles}) mesh on {dev}")
            pipe_sh = sharded(**kw)
            out, counts = counted(lambda: pipe_sh.estimate(left, right))
            require(out.device == dev and out.dtype == torch.int32
                    and tuple(out.shape) == (1, h, w),
                    f"disparity {out.device} {out.dtype} {tuple(out.shape)}")
            disp = out[0].cpu().numpy()
            n_diff = int((disp != singles[reducer]).sum())
            log(f"  launches: {dict((n, c) for n, c in counts.items() if c)}"
                f"; pixels differing from the single card: {n_diff} of "
                f"{disp.size}")
            require(n_diff == 0, f"rank {rank} {label} {tag} differs from "
                    f"the single card at {n_diff} pixels")
            for name, n in want.items():
                require(counts[name] == n, f"rank {rank} {label} {tag} "
                        f"launched {name} {counts[name]} times, not {n}")
            if golden_key is not None and rank == 0:
                golden_bad = float(np.mean(
                    (np.abs(golden[golden_key] - gt) > 1)[:, d:]))
                check_golden(golden_key, disp, golden[golden_key], gt, d,
                             GOLDEN_MAX_DIFF, golden_bad, 1e-4)
            dist.barrier()
            ms = time_ms(torch, lambda: pipe_sh.estimate(left, right),
                         warmup=DIST_WARMUP, reps=DIST_REPS)
            cell[label] = {"ms": ms, "pixels_differing": n_diff,
                           "launches": {n: c for n, c in counts.items()
                                        if c}}
            del pipe_sh, out
        picks.clear()
        pipe_auto = sharded(sgm_mode="auto")
        auto = pipe_auto.estimate(left, right)
        require(len(picks) == 1, f"sgm_mode=auto logged {picks}")
        mode = picks[0].split("'")[1]
        require(torch.equal(auto, sharded(sgm_mode=mode).estimate(left,
                                                                  right)),
                f"rank {rank} {tag}: sgm_mode=auto differs from {mode!r}")
        n_diff = int((auto[0].cpu().numpy() != singles["wta"]).sum())
        log(f"[rank {rank}] {tag}: {picks[0]}; equal to {mode!r} bit for "
            f"bit, {n_diff} pixels off the single card")
        dist.barrier()
        ms = time_ms(torch, lambda: pipe_auto.estimate(left, right),
                     warmup=DIST_WARMUP, reps=DIST_REPS)
        cell["auto"] = {"resolved": mode, "log": picks[0], "ms": ms,
                        "pixels_differing": n_diff}
        result[tag] = cell
        del auto, pipe_auto, singles
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    require("jax" not in sys.modules, "jax was imported")
    print("DISTRIBUTED_RESULT " + json.dumps(result), flush=True)
    return 0


def distributed_tiles_worker(rank: int, address: str) -> int:
    """One rank of ``check_distributed_tiles``: ``python3 chip_smoke.py
    --distributed-tiles-worker RANK HOST:PORT``.

    Joins the two-process gloo world bringing ``cuda:(RANK % cards)``
    twice, so the world's meshes lay their tile axes across both ranks,
    and runs each path on the global stacks: each rank computes its own
    tiles (or blocks), what crosses the ranks moves host-staged over
    ``torch.distributed``, and each rank's shards must equal, at their
    indices, the single card (``Pipeline.estimate``, ``PyramidPipeline``,
    the tracker's step; the overlap warm-up and ``auto``, which is not
    exact against one card, the same partitioner in one process) at 0
    pixels, with the launches a frame stated.  Both ranks time each path
    at once behind a barrier (CUDA events), then one carry move and one
    64-row HD volume halo between them.  Loads the kernels phase 2 built
    and prints one ``DISTRIBUTED_TILES_RESULT {json}`` line."""
    import logging

    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "stereomatch_tpu_torch").is_dir() and GOLDEN.is_file(),
            f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from stereomatch_tpu_torch import cli_common, parallel
    from stereomatch_tpu_torch.aggregation import CostFilter
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import _build
    from stereomatch_tpu_torch.parallel import mesh as mesh_mod
    from stereomatch_tpu_torch.parallel import transport
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    from stereomatch_tpu_torch.temporal import TemporalPipeline

    built = _build.build()
    require(built.seconds == 0.0, f"rank {rank} built the kernels; phase 2 "
            f"builds them before the workers start")
    _build.library()
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    parallel.initialize_distributed(
        coordinator_address=address, num_processes=2, process_id=rank,
        local_devices=[dev] * 2, initialization_timeout=DIST_TIMEOUT_S)
    golden = np.load(GOLDEN)
    p1, p2 = float(golden["penalty1"]), float(golden["penalty2"])
    picks = []

    class Picks(logging.Handler):
        def emit(self, record):
            picks.append(record.getMessage())

    logger = logging.getLogger("stereomatch_tpu_torch.parallel.sharded")
    logger.setLevel(logging.INFO)
    logger.addHandler(Picks())

    def counted(fn):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, {name: sum(_build.LAUNCHES[e] for e in entries)
                     for name, entries in COUNTERS.items()}

    def compare(label, shards, want, n_shards=2):
        """0 pixels between each shard and ``want`` at its index."""
        require(len(shards) == n_shards, f"rank {rank} {label}: "
                f"{len(shards)} shards, not {n_shards}")
        n_diff = 0
        for index, data in shards:
            require(data.device == dev, f"{label}: a shard on {data.device}")
            got = data.cpu().numpy()
            require(got.shape == want[index].shape, f"{label}: shard "
                    f"{got.shape} at {index}")
            n_diff += int((got != want[index]).sum())
        log(f"  pixels differing from the reference: {n_diff}")
        require(n_diff == 0, f"rank {rank} {label} differs at {n_diff} "
                f"pixels")
        return n_diff

    def per_frame(counts, frames):
        return {n: c // frames for n, c in counts.items() if c}

    def timed(fn, reps=DIST_REPS, warmup=DIST_WARMUP):
        dist.barrier()
        return time_ms(torch, fn, warmup=warmup, reps=reps)

    h, w, d, k, seeds = DIST_HD
    scenes = [stereo_pair(h, w, d, seed=s) for s in seeds]
    left = np.stack([scene[0] for scene in scenes])
    right = np.stack([scene[1] for scene in scenes])
    frames = len(seeds)
    mesh = parallel.make_mesh()
    positions = [(0, 2 * rank), (0, 2 * rank + 1)]
    require(mesh.shape == {"batch": 1, "tile": 4}
            and mesh.processes == ((0, 0, 1, 1),)
            and mesh.owned_positions() == positions,
            f"rank {rank}: make_mesh() {mesh.shape} {mesh.processes}")
    result = {"rank": rank, "device": str(dev), "hd": {}}
    singles = {}
    for reducer in ("wta", "dyn"):
        pipe = cli_common.create_pipeline("ssd", reducer, "sgm",
                                          max_disparity=d, penalty1=p1,
                                          penalty2=p2)
        pipe.cost.kernel_size = k
        singles[reducer] = np.stack([
            pipe.estimate(left[f], right[f], device=dev).cpu().numpy()
            for f in range(frames)])
        del pipe
    one_process = parallel.make_mesh([dev] * 4, n_batch=1)

    def sharded(where, **kw):
        return parallel.ShardedPipeline(where, d, kernel_size=k,
                                        penalty1=p1, penalty2=p2, **kw)

    runs = dict(TILES_RUNS)
    picks.clear()
    sharded(mesh, sgm_mode="auto").estimate(left, right)
    require(len(picks) == 1, f"sgm_mode=auto logged {picks}")
    mode = picks[0].split("'")[1]
    auto_kw, _, auto_launches = runs[next(
        label for label in runs if label.startswith(mode))]
    runs["auto"] = (dict(sgm_mode="auto"), "one-process", auto_launches)
    for label, (kw, reference, launches) in runs.items():
        log(f"[rank {rank}] {label} hd, tiles {2 * rank} and "
            f"{2 * rank + 1} of make_mesh() (1, 4) on {dev}")
        pipe_sh = sharded(mesh, **kw)
        shards, counts = counted(lambda: pipe_sh.estimate(left, right))
        if reference == "one-process":
            want = sharded(one_process, **{**kw, **(
                dict(sgm_mode=mode) if label == "auto" else {})}).estimate(
                    left, right).cpu().numpy()
        else:
            want = singles[reference]
        compare(f"{label} hd", shards, want)
        counts = per_frame(counts, frames)
        log(f"  launches a frame on rank {rank}: {counts}")
        for name, n in launches.items():
            require(counts.get(name, 0) == n, f"rank {rank} {label}: "
                    f"{name} {counts.get(name, 0)} a frame, not {n}")
        ms = timed(lambda: pipe_sh.estimate(left, right)) / frames
        result["hd"][label] = {"ms": ms, "launches": counts,
                               "reference": reference}
        if label == "auto":
            result["hd"][label].update(resolved=mode, log=picks[0])
        del pipe_sh, shards
        torch.cuda.empty_cache()

    log(f"[rank {rank}] pyramid1 hd over make_mesh() (1, 4), against "
        f"PyramidPipeline on the card")
    single = PyramidPipeline(d, levels=1, penalty1=p1, penalty2=p2)
    want = np.stack([single.estimate(left[f], right[f]).cpu().numpy()
                     for f in range(frames)])
    fn = parallel.make_pyramid_sharded_estimate(
        mesh, max_disparity=d, levels=1, penalty1=p1, penalty2=p2)
    shards, counts = counted(lambda: fn(left, right))
    compare("pyramid1 hd", shards, want)
    counts = per_frame(counts, frames)
    log(f"  launches a frame on rank {rank}: {counts}")
    require(counts.get("sgm_chunk") == 12 and counts.get("sgm_rows", 0) == 0
            and counts.get("sgm_horizontal") == 4,
            f"pyramid1 hd launches {counts}")
    result["hd"]["pyramid1"] = {"ms": timed(lambda: fn(left, right))
                                / frames, "launches": counts}
    del single, fn, shards

    log(f"[rank {rank}] tracked frame hd over make_mesh() (1, 4), against "
        f"the single card's tracking step")
    prev = singles["wta"]
    tracker = TemporalPipeline(d, device=dev)
    steps = [tracker._track(torch.from_numpy(left[f]).to(dev),
                            torch.from_numpy(right[f]).to(dev),
                            torch.from_numpy(prev[f]).to(dev))
             for f in range(frames)]
    want = np.stack([disp.cpu().numpy() for disp, _ in steps])
    want_frac = np.stack([frac.cpu().numpy() for _, frac in steps])
    fn = parallel.make_temporal_track_sharded(mesh, max_disparity=d)
    (shards, fracs), counts = counted(lambda: fn(left, right, prev))
    compare("tracked frame hd", shards, want)
    for index, frac in fracs:
        require(np.array_equal(frac.cpu().numpy(), want_frac[index]),
                f"tracked frame hd: poor fraction {frac} at {index}, not "
                f"{want_frac[index]}")
    log(f"  poor fraction equal to the single card's on both shards; "
        f"launches a frame: {per_frame(counts, frames)} (the band stage is "
        f"plain PyTorch)")
    result["hd"]["tracked frame"] = {
        "ms": timed(lambda: fn(left, right, prev)) / frames,
        "launches": per_frame(counts, frames)}
    del tracker, steps, fn, shards, fracs
    torch.cuda.empty_cache()

    log(f"[rank {rank}] 2-D tiles (1, 2, 2) hd, overlap "
        f"{TILES_2D_OVERLAP}, tile axis across the ranks, frame 0")
    mesh_2d = parallel.make_mesh_2d(None, 1, 2, 2)
    require(mesh_2d.processes == (((0, 0), (1, 1)),),
            f"make_mesh_2d(None, 1, 2, 2): {mesh_2d.processes}")
    fn = parallel.make_tiled2d_estimate(
        mesh_2d, max_disparity=d, kernel_size=k, penalty1=p1, penalty2=p2,
        overlap=TILES_2D_OVERLAP)
    shards, counts = counted(lambda: fn(left[:1], right[:1]))
    compare("2-D tiles hd", shards, singles["wta"][:1])
    counts = per_frame(counts, 1)
    log(f"  launches a frame on rank {rank}: {counts}")
    require(counts.get("ssd") == 2 and counts.get("sgm_rows") == 12
            and counts.get("sgm_horizontal") == 4,
            f"2-D tiles hd launches {counts}")
    del shards
    result["hd"]["tiled2d (1, 2, 2)"] = {
        "ms": timed(lambda: fn(left[:1], right[:1]), reps=1, warmup=0),
        "launches": counts}
    del fn, mesh_2d
    torch.cuda.empty_cache()

    log(f"[rank {rank}] disparity blocks hd, ssd+wta over make_disp_mesh() "
        f"(4 blocks), frame 0")
    single = cli_common.create_pipeline("ssd", "wta", None, max_disparity=d,
                                        kernel_size=k)
    want = single.estimate(left[0], right[0], device=dev).cpu().numpy()
    fn = parallel.make_disp_sharded_wta(parallel.make_disp_mesh(),
                                        max_disparity=d, kernel_size=k)
    shards, counts = counted(lambda: fn(left[0], right[0]))
    compare("disparity blocks hd", shards, want)
    counts = per_frame(counts, 1)
    log(f"  launches a frame on rank {rank}: {counts}")
    require(counts.get("ssd") == 2, f"disparity blocks launches {counts}")
    result["hd"]["disparity blocks"] = {
        "ms": timed(lambda: fn(left[0], right[0])), "launches": counts}
    del single, fn, shards
    torch.cuda.empty_cache()

    golden_cvf = np.load(GOLDEN_CVF)
    radius, eps = int(golden_cvf["cvf_radius"]), float(golden_cvf["cvf_eps"])
    window = int(golden_cvf["census_window"])
    t_left, t_right, t_gt = stereo_pair(375, 450, 128, seed=int(
        golden["seed"]))
    # A (1, 1, 2) grid of one device of each rank: tile_w across them
    # (375 rows do not split over two row tiles).
    world = mesh_mod.world_devices()
    mesh_w = parallel.Mesh([[[world[0][0], world[1][0]]]],
                           axis_names=(parallel.BATCH_AXIS, parallel.TILE_AXIS,
                                       parallel.TILE_W_AXIS),
                           processes=[[[0, 1]]])
    log(f"[rank {rank}] teddy census+cvf+wta over a (1, 1, 2) mesh of one "
        f"device of each rank, tile_w across them, against the single-card "
        f"masked filter")
    masked = cli_common.create_pipeline("census", "wta", "cvf",
                                        max_disparity=128,
                                        census_window=window)
    masked.aggregation = CostFilter(radius, eps, wedge_offset=None)
    want = masked.estimate(t_left, t_right, device=dev).cpu().numpy()
    fn = parallel.make_tiled2d_estimate(
        mesh_w, max_disparity=128,
        cost="census", census_window=window, aggregation="cvf",
        cvf_radius=radius, cvf_eps=eps)
    shards, counts = counted(lambda: fn(t_left[None], t_right[None]))
    compare("2-D tiles census+cvf+wta teddy", shards, want[None], 1)
    (index, data), = shards
    got = data[0].cpu().numpy()
    cols = index[2]
    scored = np.zeros((375, 450), bool)
    scored[:, 128:] = True
    bad = (np.abs(got - t_gt[:, cols]) > 1) & scored[:, cols]
    result["teddy cvf"] = {
        "ms": timed(lambda: fn(t_left[None], t_right[None])),
        "launches": per_frame(counts, 1),
        "golden_diff": int((got != golden_cvf["census_cvf_wta"][:, cols])
                           .sum()),
        "bad": int(bad.sum()), "scored": int(scored[:, cols].sum())}
    log(f"  launches a frame on rank {rank}: {per_frame(counts, 1)} (census "
        f"and the 2-D masked filter are plain PyTorch)")
    del masked, fn, shards, mesh_w

    log(f"[rank {rank}] moves between the ranks, host-staged over gloo")
    carry = (torch.rand((w, d), device=dev), torch.rand((w,), device=dev))
    volume = torch.rand((64, w, d), device=dev)
    link = {}
    for name, blocks in (("carry", carry), ("halo", (volume,))):
        reps = TILES_LINK_REPS[name]
        here = [b if rank == 0 else transport.Remote(0, dev) for b in blocks]
        dist.barrier()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            there = transport.move(here, transport.Remote(1, dev), name)
            here = transport.move(there, transport.Remote(0, dev), name)
        torch.cuda.synchronize()
        one_way = (time.perf_counter() - start) / (2 * reps) * 1e3
        n_bytes = sum(b.numel() * b.element_size() for b in blocks)
        link[name] = {"ms": one_way, "bytes": n_bytes,
                      "gbps": n_bytes / one_way / 1e6}
        log(f"  {name} ({n_bytes} bytes) one way: {one_way!r} ms = "
            f"{link[name]['gbps']!r} GB/s")
        if rank == 0:
            require(all(torch.equal(a, b) for a, b in zip(here, blocks)),
                    f"the {name} came back changed")
    result["link"] = link
    dist.barrier()
    dist.destroy_process_group()
    require("jax" not in sys.modules, "jax was imported")
    print("DISTRIBUTED_TILES_RESULT " + json.dumps(result), flush=True)
    return 0


def measure_link(torch, dev, shapes, p1, p2, card) -> dict:
    """The rates behind ``parallel/ici_model.py``'s defaults, with CUDA
    events (median of DIST_REPS after DIST_WARMUP), at teddy and HD:

    * the [3, W, D] float32 carry copied to the next tile's device
      (``cuda:1`` where there are two cards; with one, a copy within the
      card), LINK_COPIES copies to a pair of events;
    * one exact hand-off stage: the carry copied to the next tile's
      device and a chunk-kernel launch (the TPU's K5) on one row from
      it, LINK_STAGES chained to a pair;
    * the card's copy rate: COPY_BYTES copied once, 2 * COPY_BYTES
      moved."""
    from stereomatch_tpu_torch.ops import cost as cost_ops
    from stereomatch_tpu_torch.ops import sgm_cuda

    other = torch.device("cuda", 1 % torch.cuda.device_count())
    out = {"other_device": str(other)}
    step = (1, 0)
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        w = left.shape[1]
        carry3 = torch.rand((3, w, d), device=dev)
        dst3 = torch.empty((3, w, d), device=other)

        def copies():
            for _ in range(LINK_COPIES):
                dst3.copy_(carry3)

        copy_ms = time_ms(torch, copies, warmup=DIST_WARMUP,
                          reps=DIST_REPS) / LINK_COPIES
        vol = cost_ops.ssd_cost_volume(left[:1], right[:1], max_disparity=d,
                                       kernel_size=k)
        rows = [(vol.to(x).contiguous(), left[:1].to(x).contiguous())
                for x in (dev, other)]
        _, (carry, _) = sgm_cuda.sweep_chunk_with_carry_cuda(
            rows[0][0], rows[0][1], step, penalty1=p1, penalty2=p2,
            seed=True)
        landing = [torch.empty_like(carry, device=x) for x in (dev, other)]

        def stages():
            c = carry
            for i in range(LINK_STAGES):
                vol_i, img_i = rows[(i + 1) % 2]
                nxt = landing[(i + 1) % 2].copy_(c)
                _, (c, _) = sgm_cuda.sweep_chunk_with_carry_cuda(
                    vol_i, img_i, step, nxt, img_i[0], penalty1=p1,
                    penalty2=p2, seed=False)

        stage_ms = time_ms(torch, stages, warmup=DIST_WARMUP,
                           reps=DIST_REPS) / LINK_STAGES
        out[tag] = {"carry_copy_us": copy_ms * 1e3,
                    "carry_gbps": carry3.numel() * 4 / copy_ms / 1e6,
                    "stage_us": stage_ms * 1e3}
        log(f"  carry [3, {w}, {d}] float32 {dev} -> {other}: "
            f"{out[tag]['carry_copy_us']!r} us = {out[tag]['carry_gbps']!r} "
            f"GB/s; one hand-off stage (copy + 1-row chunk launch): "
            f"{out[tag]['stage_us']!r} us [{card}]")
        del carry3, dst3, vol, rows, carry, landing
    a = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    ms = time_ms(torch, lambda: b.copy_(a), warmup=DIST_WARMUP,
                 reps=DIST_REPS)
    out["copy_gbps"] = 2 * COPY_BYTES / ms / 1e6
    log(f"  copy rate: {COPY_BYTES} bytes in {ms!r} ms = "
        f"{out['copy_gbps']!r} GB/s read + written [{card}]")
    del a, b
    torch.cuda.empty_cache()
    return out


def spawn_workers(flag: str, marker: str) -> list:
    """Two worker processes of this script (``flag RANK HOST:PORT``) in
    one gloo world; fails unless both exit 0 within DIST_TIMEOUT_S with
    their ``marker`` lines, killing both on the first failure.  Logs
    their other lines and returns both results (rank order)."""
    sock = socket.socket()
    sock.bind(("localhost", 0))
    address = f"localhost:{sock.getsockname()[1]}"
    sock.close()
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(rank),
         address],
        stdout=logs[rank], stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for rank in range(2)]
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while (any(p.poll() is None for p in procs)
               and all(p.returncode in (None, 0) for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
    results = []
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        lines = [line for line in text.splitlines()
                 if line.startswith(marker + " ")]
        for line in text.splitlines():
            if not line.startswith(marker + " "):
                log(f"  {line}")
        require(proc.returncode == 0 and lines,
                f"{flag[2:]} {rank} exited {proc.returncode} (a timeout of "
                f"{DIST_TIMEOUT_S} s or its partner's failure kills it)")
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    return results


def check_distributed(torch, dev, shapes, p1, p2, card) -> dict:
    """The batch axis over two processes: two worker processes of this
    script (``distributed_worker``) joined in a gloo world on this card
    (one card each where there are two), teddy over (2, 5) and HD over
    (2, 4).  Fails unless both exit 0 within DIST_TIMEOUT_S with their
    result lines, killing both on the first failure.  Then, with the
    card free, ``measure_link``.  Returns both ranks' results and the
    link measurements."""
    from stereomatch_tpu_torch.parallel import ici_model

    log(f"[distributed] two worker processes, a gloo world, teddy over "
        f"(2, 5) and HD over (2, 4) on cuda:(rank % "
        f"{torch.cuda.device_count()}); both ranks share the card")
    results = spawn_workers("--distributed-worker", "DISTRIBUTED_RESULT")
    for result in results:
        for tag, (_, runs) in DIST_CELLS.items():
            for label in [*runs, "auto"]:
                shown = label if label != "auto" else (
                    f"sgm_mode=auto ({result[tag]['auto']['resolved']}) "
                    f"ssd+sgm+wta")
                log(f"  rank {result['rank']} {shown} {tag}: "
                    f"{result[tag][label]['ms']!r} ms/frame (CUDA events, "
                    f"median of {DIST_REPS} after {DIST_WARMUP}, images on "
                    f"the host, the other rank timing at once on the same "
                    f"card) [{card}]")
    link = measure_link(torch, dev, shapes, p1, p2, card)
    log(f"  ici_model defaults: carry {ici_model.CARRY_GBPS!r} GB/s, stage "
        f"{ici_model.STAGE_US!r} us, copy {ici_model.COPY_GBPS!r} GB/s")
    return {"ranks": results, "link": link}


def check_distributed_tiles(card) -> dict:
    """The tile axes across two processes (ROADMAP A.14e): two worker
    processes of this script (``distributed_tiles_worker``) in a gloo
    world, each bringing ``cuda:(rank % cards)`` twice, so that the
    world's meshes lay their tile axes across the ranks: HD over
    ``make_mesh()`` (1, 4) (exact with WTA and DP, overlap 64, auto, the
    pyramid, the tracked frame), the 2-D tiles (1, 2, 2), the disparity
    blocks (4) and teddy census+cvf+wta over a (1, 1, 2) mesh of one
    device of each rank, every rank's
    shards at 0 pixels against the single card (or the one-process
    partitioner, for the warm-up modes), and the teddy run's two halves
    together against ``golden_torch_cvf_teddy.npz`` (CVF_GOLDEN_MAX_DIFF
    pixels).  Returns both ranks' times, launches and link times."""
    log("[distributed tiles] two worker processes, a gloo world, each "
        "bringing cuda:(rank % cards) twice: HD over make_mesh() (1, 4), "
        "2-D tiles (1, 2, 2), disparity blocks (4), teddy over (1, 1, 2) "
        "(one device of each rank); "
        "both ranks share the card")
    results = spawn_workers("--distributed-tiles-worker",
                            "DISTRIBUTED_TILES_RESULT")
    golden_cvf = np.load(GOLDEN_CVF)
    cvf = [r["teddy cvf"] for r in results]
    n_diff = sum(c["golden_diff"] for c in cvf)
    bad = sum(c["bad"] for c in cvf) / sum(c["scored"] for c in cvf)
    golden_bad = float(golden_cvf["bad_pixel_vs_gt"])
    log(f"  teddy census+cvf+wta, both halves: {n_diff} pixels differ from "
        f"golden census_cvf_wta (bound {CVF_GOLDEN_MAX_DIFF}); bad-pixel "
        f"vs ground truth {bad!r} (golden {golden_bad!r})")
    require(n_diff <= CVF_GOLDEN_MAX_DIFF, f"{n_diff} pixels differ from "
            f"golden census_cvf_wta")
    require(bad <= golden_bad + 1e-3, f"bad-pixel {bad} above the golden's")
    for result in results:
        for label, run in {**result["hd"],
                           "teddy census+cvf+wta (1, 1, 2)":
                               result["teddy cvf"]}.items():
            log(f"  rank {result['rank']} {label}: {run['ms']!r} ms/frame "
                f"(CUDA events, both ranks timing at once on the card, "
                f"host images), launches a frame {run['launches']} [{card}]")
        for name, link in result["link"].items():
            log(f"  rank {result['rank']} {name} move, one way: "
                f"{link['ms']!r} ms for {link['bytes']} bytes (host clock, "
                f"{TILES_LINK_REPS[name]} round trips) [{card}]")
    return {"ranks": results}


def main() -> int:
    started = time.perf_counter()
    import torch

    def elapsed(after: str) -> None:
        """When each phase ended (the script must stay well inside its
        time limit as phases are added)."""
        log(f"[elapsed] {time.perf_counter() - started:.1f} s after {after}")

    # Phase 1: device.
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "stereomatch_tpu_torch").is_dir() and GOLDEN.is_file()
            and GOLDEN_CVF.is_file() and GOLDEN_BF16.is_file()
            and GOLDEN_REFINED.is_file() and GOLDEN_COSTS.is_file()
            and GOLDEN_PYRAMID.is_file(),
            f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    BF16 = torch.bfloat16

    from stereomatch_tpu_torch import cli_common, parallel
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import (_build, cvf_cuda, dp_cuda,
                                           sgm_cuda, ssd_cuda)
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import cost as cost_ops
    from stereomatch_tpu_torch.ops import cvf as cvf_ops
    from stereomatch_tpu_torch.ops import disparity as disp_ops

    # Phase 2: build.
    start = time.perf_counter()
    built = _build.build()
    _build.library()
    log(f"[build] {built.path.name} in {time.perf_counter() - start:.2f} s "
        f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    golden = np.load(GOLDEN)
    k_teddy = int(golden["kernel_size"])
    p1, p2 = float(golden["penalty1"]), float(golden["penalty2"])

    def images(h, w, d, seed):
        left, right, gt = stereo_pair(h, w, d, seed=seed)
        return (torch.from_numpy(left).to(dev),
                torch.from_numpy(right).to(dev), gt)

    rng = np.random.default_rng(5)
    shapes = {
        "teddy": images(375, 450, 128, int(golden["seed"])) + (128, k_teddy),
        "ragged": (torch.from_numpy(rng.random((37, 53), np.float32)).to(dev),
                   torch.from_numpy(rng.random((37, 53), np.float32)).to(dev),
                   None, 24, 3),
        "hd": images(1024, 1280, 256, 11) + (256, 7),
    }

    # Phase 3: kernels against their plain versions, on the card.
    log("[kernels vs plain]")
    errors = {}
    for tag, (left, right, _, d, k) in shapes.items():
        kw = dict(max_disparity=d, kernel_size=k)
        # The SSD kernel: f32 SSD and SAD, and the int32 chain on uint8
        # images, each bit-equal to its plain version.
        left8 = (left * 255).to(torch.uint8)
        right8 = (right * 255).to(torch.uint8)
        for label, images, dtype, absolute in (
                ("ssd f32", (left, right), torch.float32, False),
                ("sad f32", (left, right), torch.float32, True),
                ("ssd int32 (uint8 images)", (left8, right8), torch.int32,
                 False)):
            err = compare(
                f"{label} {tag}",
                cost_ops._diff_cost_volume(*images, cost_dtype=dtype,
                                           absolute=absolute, **kw),
                ssd_cuda.diff_cost_volume_cuda(*images, cost_dtype=dtype,
                                               absolute=absolute, **kw),
                0, 0, exact=True)
            errors.setdefault(f"ssd_{tag}", err)
        ref = cost_ops.ssd_cost_volume(left, right, **kw)
        # Each SGM kernel on its own family, then the whole aggregation:
        # the ring walk keeps the recurrence's every operation and the
        # plain version's order, so both are bit-equal.
        for fam, steps in (("sgm_horizontal", agg_ops.TRAVERSALS[:2]),
                           ("sgm_rows", agg_ops.TRAVERSALS[2:])):
            plain = None
            for step in steps:
                c = agg_ops.sweep(ref, left, p1, p2, step)
                plain = c if plain is None else plain + c
            kern = torch.empty_like(ref)
            for i, step in enumerate(steps):
                sgm_cuda.traverse_cuda(ref, left, kern, step, p1, p2,
                                       accumulate=i > 0)
            errors[f"{fam}_{tag}"] = compare(f"{fam} family {tag}", plain,
                                             kern, 0, 0, exact=True)
            del plain, kern
        compare(f"semiglobal_aggregate {tag}",
                agg_ops.semiglobal_aggregate(ref, left, penalty1=p1,
                                             penalty2=p2),
                sgm_cuda.semiglobal_aggregate_cuda(ref, left, penalty1=p1,
                                                   penalty2=p2),
                0, 0, exact=True)
        # The chunk kernel (K5; at HD also K6's discharge) on the chunks
        # of the sharded path's row tiles.
        errors[f"sgm_chunk_{tag}"] = check_chunks(tag, ref, left, p1, p2)
        # The DP kernels on the SSD volume: each against its plain step.
        ptr_ref, final_ref = disp_ops.dp_forward(ref)
        ptr, final = dp_cuda.dp_forward_cuda(ref)
        errors[f"dp_forward_{tag}"] = max(
            compare(f"dp_forward pointers {tag}", ptr_ref, ptr, 0, 0,
                    exact=True),
            compare(f"dp_forward final costs {tag}", final_ref, final, 0, 0,
                    exact=True))
        errors[f"dp_backward_{tag}"] = compare(
            f"dp_backward {tag}",
            disp_ops.dp_backward(ptr_ref,
                                 disp_ops.dp_end_disparities(final_ref)),
            dp_cuda.dp_backward_cuda(ptr_ref, final_ref), 0, 0, exact=True)
        # The walk on hand-made pointers of the same shape: all -1 and all
        # +1 (both clips), a mix of {-1, 0, +1}, and any int8 (steps off
        # the kernel's window, read from device memory).
        for kind, ptr_made in hand_made_pointers(torch, ptr_ref.shape, dev):
            compare(f"dp_backward {tag} {kind} pointers",
                    disp_ops.dp_backward(
                        ptr_made, disp_ops.dp_end_disparities(final_ref)),
                    dp_cuda.dp_backward_cuda(ptr_made, final_ref), 0, 0,
                    exact=True)
            del ptr_made
        del ref, ptr_ref, final_ref, ptr, final
        # Census on the card equals census on the CPU; CVF on its volume.
        census_kw = dict(max_disparity=d, window_size=5, kernel_size=1)
        census = cost_ops.census_hamming_cost_volume(left, right, **census_kw)
        compare(f"census plain card vs CPU {tag}",
                cost_ops.census_hamming_cost_volume(left.cpu(), right.cpu(),
                                                    **census_kw).to(dev),
                census, 0, 0, exact=True)
        cvf_kw = dict(radius=8, eps=1e-4, wedge_offset=0)
        errors[f"cvf_{tag}"] = compare(
            f"cvf {tag}", cvf_ops.guided_filter_aggregate(census, left,
                                                          **cvf_kw),
            cvf_cuda.guided_filter_aggregate_cuda(census, left, **cvf_kw),
            0, 0, exact=True)
        del census
        torch.cuda.empty_cache()

        # bf16 volumes: the SSD kernel storing bf16, the SGM kernels, the
        # chunk kernel, DP's forward pass and the CVF kernels reading it,
        # each bit-equal to its plain version (partial sums, carries, a0,
        # b0 and the DP's outputs stay float32).
        for label, absolute in (("ssd bf16", False), ("sad bf16", True)):
            err = compare(
                f"{label} {tag}",
                cost_ops._diff_cost_volume(left, right, cost_dtype=BF16,
                                           absolute=absolute, **kw),
                ssd_cuda.diff_cost_volume_cuda(left, right, cost_dtype=BF16,
                                               absolute=absolute, **kw),
                0, 0, exact=True)
            errors.setdefault(f"ssd_bf16_{tag}", err)
        ref16 = cost_ops.ssd_cost_volume(left, right, cost_dtype=BF16, **kw)
        horiz = agg_ops.TRAVERSALS[:2]
        plain = agg_ops.sweep(ref16, left, p1, p2, horiz[0])
        plain += agg_ops.sweep(ref16, left, p1, p2, horiz[1])
        kern = torch.empty(ref16.shape, device=dev)
        for i, step in enumerate(horiz):
            sgm_cuda.traverse_cuda(ref16, left, kern, step, p1, p2,
                                   accumulate=i > 0)
        errors[f"sgm_horizontal_bf16_{tag}"] = compare(
            f"sgm_horizontal family bf16 {tag}", plain, kern, 0, 0,
            exact=True)
        del plain, kern
        errors[f"sgm_rows_bf16_{tag}"] = compare(
            f"semiglobal_aggregate bf16 {tag} (the row family rounding the "
            f"sum once)",
            agg_ops.semiglobal_aggregate(ref16, left, penalty1=p1,
                                         penalty2=p2),
            sgm_cuda.semiglobal_aggregate_cuda(ref16, left, penalty1=p1,
                                               penalty2=p2),
            0, 0, exact=True)
        errors[f"sgm_chunk_bf16_{tag}"] = check_chunks(tag, ref16, left, p1,
                                                       p2)
        ptr_ref, final_ref = disp_ops.dp_forward(ref16)
        ptr, final = dp_cuda.dp_forward_cuda(ref16)
        errors[f"dp_forward_bf16_{tag}"] = max(
            compare(f"dp_forward bf16 pointers {tag}", ptr_ref, ptr, 0, 0,
                    exact=True),
            compare(f"dp_forward bf16 final costs {tag}", final_ref, final,
                    0, 0, exact=True))
        del ref16, ptr_ref, final_ref, ptr, final
        census16 = cost_ops.census_hamming_cost_volume(
            left, right, cost_dtype=BF16, **census_kw)
        errors[f"cvf_bf16_{tag}"] = compare(
            f"cvf bf16 {tag}",
            cvf_ops.guided_filter_aggregate(census16, left, **cvf_kw),
            cvf_cuda.guided_filter_aggregate_cuda(census16, left, **cvf_kw),
            0, 0, exact=True)
        del census16
        torch.cuda.empty_cache()

    elapsed("the kernels against their plain versions")

    # Phase 4: the paths, through the entry points a user calls; the
    # launch counts are set to 0 just before each and read just after.
    counters = COUNTERS
    # The float32 kernels a bf16 path must not launch: no cast of a bf16
    # volume to float32 in front of them.
    f32_only = ("ssd", "sgm_rows", "sgm_chunk", "sgm_horizontal",
                "dp_forward", "cvf", "cvf_filter")

    def run_path(label, run, kernels, shape=(375, 450), d=128,
                 dtype=torch.int32):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        disp = run()
        torch.cuda.synchronize()
        counts = {name: sum(_build.LAUNCHES[e] for e in entries)
                  for name, entries in counters.items()}
        log(f"  launches: {counts}")
        for name in kernels:
            require(counts[name] > 0, f"{label} launched {name} no time")
        require(disp.is_cuda and disp.dtype == dtype
                and tuple(disp.shape) == shape,
                f"disparity {disp.device} {disp.dtype} {tuple(disp.shape)}")
        disp_np = disp.cpu().numpy()
        require(disp_np.min() >= 0 and disp_np.max() < d,
                "disparity out of range")
        return disp_np, counts

    log("[main path] ssd -> sgm -> wta, teddy 375x450 D=128")
    left, right, gt, d, k = shapes["teddy"]
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      penalty1=p1, penalty2=p2)
    pipe.cost.kernel_size = k
    left_np, right_np = left.cpu().numpy(), right.cpu().numpy()
    disp_np, launches = run_path(
        "the main path",
        lambda: pipe.estimate(left_np, right_np, device="cuda"),
        ("ssd", "sgm_rows", "sgm_horizontal"))
    check_golden("wta", disp_np, golden["wta"], gt, d, GOLDEN_MAX_DIFF,
                 float(golden["bad_pixel_vs_gt"]), 1e-4)

    # WTA ties go to the lower disparity on the card, as on the CPU.
    tied = torch.from_numpy(
        rng.integers(0, 3, (64, 96, 40)).astype(np.float32)).to(dev)
    want = np.argmin(tied.cpu().numpy(), axis=2)
    got = pipe.disparity_reduce(tied).cpu().numpy()
    require(np.array_equal(got, want), "argmin tie order differs on CUDA")
    log("  wta tie check: ties go to the lower disparity")

    log("[dyn path] ssd -> sgm -> dyn, teddy 375x450 D=128, default device")
    pipe_dyn = cli_common.create_pipeline("ssd", "dyn", "sgm",
                                          max_disparity=d, penalty1=p1,
                                          penalty2=p2)
    pipe_dyn.cost.kernel_size = k
    disp_np, dyn_counts = run_path(
        "ssd -> sgm -> dyn", lambda: pipe_dyn.estimate(left_np, right_np),
        ("ssd", "sgm_rows", "sgm_horizontal", "dp_forward", "dp_backward"))
    golden_dp_bad = float(np.mean((np.abs(golden["dp"] - gt) > 1)[:, d:]))
    check_golden("dp", disp_np, golden["dp"], gt, d, GOLDEN_MAX_DIFF,
                 golden_dp_bad, 1e-4)
    launches.update(dp_forward=dyn_counts["dp_forward"],
                    dp_backward=dyn_counts["dp_backward"])

    log("[cvf path] census -> cvf -> wta, teddy 375x450 D=128, default "
        "device")
    golden_cvf = np.load(GOLDEN_CVF)
    pipe_cvf = cli_common.create_pipeline(
        "census", "wta", "cvf", max_disparity=d,
        cvf_radius=int(golden_cvf["cvf_radius"]),
        cvf_eps=float(golden_cvf["cvf_eps"]),
        census_window=int(golden_cvf["census_window"]))
    disp_np, cvf_counts = run_path(
        "census -> cvf -> wta", lambda: pipe_cvf.estimate(left_np, right_np),
        ("cvf", "cvf_filter"))
    check_golden("census_cvf_wta", disp_np, golden_cvf["census_cvf_wta"], gt,
                 d, CVF_GOLDEN_MAX_DIFF,
                 float(golden_cvf["bad_pixel_vs_gt"]), 1e-3)
    launches["cvf"] = cvf_counts["cvf"]
    launches["cvf_filter"] = cvf_counts["cvf_filter"]
    require(cvf_counts["cvf"] == cvf_counts["cvf_filter"],
            "the two CVF kernels launched a different number of times")

    # The three teddy paths on bf16 volumes (volume_dtype="bfloat16")
    # against the bf16 golden, made by JAX's XLA ops, which the plain
    # versions and the kernels equal bit for bit: 0 pixels may differ.
    golden16 = np.load(GOLDEN_BF16)
    for name, (cost, reducer, aggr), kernels in (
            ("ssd_sgm_wta", ("ssd", "wta", "sgm"),
             ("ssd_bf16", "sgm_rows_bf16", "sgm_horizontal_bf16")),
            ("ssd_sgm_dyn", ("ssd", "dyn", "sgm"),
             ("ssd_bf16", "sgm_rows_bf16", "sgm_horizontal_bf16",
              "dp_forward_bf16", "dp_backward")),
            ("census_cvf_wta", ("census", "wta", "cvf"),
             ("cvf_bf16", "cvf_filter_bf16"))):
        log(f"[bf16 path] {cost} -> {aggr} -> {reducer}, teddy 375x450 "
            f"D=128, volume_dtype=bfloat16")
        pipe16 = cli_common.create_pipeline(
            cost, reducer, aggr, max_disparity=d, penalty1=p1, penalty2=p2,
            cvf_radius=int(golden16["cvf_radius"]),
            cvf_eps=float(golden16["cvf_eps"]),
            census_window=int(golden16["census_window"]),
            volume_dtype="bfloat16")
        if cost == "ssd":
            pipe16.cost.kernel_size = k
        disp_np, counts = run_path(
            f"bf16 {name}", lambda: pipe16.estimate(left_np, right_np),
            kernels)
        require(all(counts[n] == 0 for n in f32_only),
                f"bf16 {name} launched a float32 kernel: {counts}")
        require(pipe16._aggregation_volume.dtype == BF16,
                f"bf16 {name} aggregated into "
                f"{pipe16._aggregation_volume.dtype}")
        check_golden(f"bf16 {name}", disp_np, golden16[name], gt, d, 0,
                     float(golden16[f"bad_pixel_{name}"]), 0.0)
        launches.update((n, counts[n]) for n in kernels if n.endswith("bf16"))

    # The row-sharded pipeline: 5 row tiles of 75 rows on one card.
    mesh5 = parallel.make_mesh([dev] * 5, n_batch=1)
    sharded_kw = dict(kernel_size=k, penalty1=p1, penalty2=p2)

    def sharded_run(label, want, max_diff, golden_bad, kernels, counts_want,
                    **kw):
        log(f"[sharded path] {label}, teddy over 5 row tiles on {dev}")
        pipe_sh = parallel.ShardedPipeline(mesh5, d, **sharded_kw, **kw)
        disp_np, counts = run_path(
            f"sharded {label}", lambda: pipe_sh.estimate(left_np, right_np),
            kernels)
        for name, n in counts_want.items():
            require(counts[name] == n, f"sharded {label} launched {name} "
                    f"{counts[name]} times, not {n}")
        check_golden(label, disp_np, want, gt, d, max_diff, golden_bad,
                     1e-4)
        return counts

    sharded_counts = sharded_run(
        "exact ssd -> sgm -> wta", golden["wta"], GOLDEN_MAX_DIFF,
        float(golden["bad_pixel_vs_gt"]),
        ("ssd", "sgm_chunk", "sgm_horizontal"),
        dict(ssd=5, sgm_chunk=30, sgm_rows=0, sgm_horizontal=10))
    launches["sgm_chunk"] = sharded_counts["sgm_chunk"]
    sharded_run("exact ssd -> sgm -> dyn", golden["dp"], GOLDEN_MAX_DIFF,
                golden_dp_bad,
                ("ssd", "sgm_chunk", "sgm_horizontal", "dp_forward",
                 "dp_backward"),
                dict(sgm_chunk=30, sgm_rows=0, dp_forward=5, dp_backward=5),
                reducer="dynamic_programming")
    sharded_run("overlap=300 ssd -> sgm -> wta", golden["wta"],
                GOLDEN_MAX_DIFF, float(golden["bad_pixel_vs_gt"]),
                ("ssd", "sgm_rows", "sgm_horizontal"),
                dict(sgm_chunk=0, sgm_rows=30), sgm_mode="overlap",
                overlap=300)
    # bf16 tiles: each tile's sum rounded once, so every pixel equals the
    # single-card bf16 path (golden16, which that path met above).
    counts = sharded_run(
        "exact bf16 ssd -> sgm -> wta", golden16["ssd_sgm_wta"], 0,
        float(golden16["bad_pixel_ssd_sgm_wta"]),
        ("ssd_bf16", "sgm_chunk_bf16", "sgm_horizontal_bf16"),
        dict(ssd=0, sgm_chunk=0, sgm_horizontal=0, ssd_bf16=5,
             sgm_chunk_bf16=30, sgm_horizontal_bf16=10),
        cost_dtype="bfloat16")
    launches["sgm_chunk_bf16"] = counts["sgm_chunk_bf16"]
    sharded_run("exact bf16 ssd -> sgm -> dyn", golden16["ssd_sgm_dyn"], 0,
                float(golden16["bad_pixel_ssd_sgm_dyn"]),
                ("sgm_chunk_bf16", "dp_forward_bf16", "dp_backward"),
                dict(sgm_chunk_bf16=30, dp_forward=0, dp_forward_bf16=5),
                cost_dtype="bfloat16", reducer="dynamic_programming")
    sharded_run("overlap=300 bf16 ssd -> sgm -> wta",
                golden16["ssd_sgm_wta"], 0,
                float(golden16["bad_pixel_ssd_sgm_wta"]),
                ("ssd_bf16", "sgm_rows_bf16", "sgm_horizontal_bf16"),
                dict(sgm_rows=0, sgm_chunk_bf16=0, sgm_rows_bf16=30),
                cost_dtype="bfloat16", sgm_mode="overlap", overlap=300)

    log(f"[sharded path] exact ssd -> sgm -> wta, hd over 4 row tiles on "
        f"{dev}, against the single-card path")
    hd_left, hd_right, _, hd_d, hd_k = shapes["hd"]
    pipe_hd = cli_common.create_pipeline("ssd", "wta", "sgm",
                                         max_disparity=hd_d, penalty1=p1,
                                         penalty2=p2)
    pipe_hd.cost.kernel_size = hd_k
    single_hd = pipe_hd.estimate(hd_left, hd_right).cpu().numpy()
    pipe_sh = parallel.ShardedPipeline(
        parallel.make_mesh([dev] * 4, n_batch=1), hd_d, kernel_size=hd_k,
        penalty1=p1, penalty2=p2)
    disp_np, counts = run_path(
        "sharded hd", lambda: pipe_sh.estimate(hd_left, hd_right),
        ("ssd", "sgm_chunk", "sgm_horizontal"), shape=(1024, 1280), d=hd_d)
    require(counts["sgm_chunk"] == 24 and counts["sgm_rows"] == 0,
            f"sharded hd launches {counts}")
    hd_chunk_launches = counts["sgm_chunk"]
    n_diff = int((disp_np != single_hd).sum())
    log(f"  pixels differing from the single-card path: {n_diff} of "
        f"{disp_np.size}")
    require(n_diff == 0, f"sharded hd differs from the single-card path at "
            f"{n_diff} pixels")
    del pipe_hd, pipe_sh
    torch.cuda.empty_cache()

    log(f"[sharded path] exact bf16 ssd -> sgm -> wta, hd over 4 row tiles "
        f"on {dev}, against the single-card bf16 path")
    pipe_hd16 = cli_common.create_pipeline(
        "ssd", "wta", "sgm", max_disparity=hd_d, penalty1=p1, penalty2=p2,
        volume_dtype="bfloat16")
    pipe_hd16.cost.kernel_size = hd_k
    single_hd16 = pipe_hd16.estimate(hd_left, hd_right).cpu().numpy()
    pipe_sh16 = parallel.ShardedPipeline(
        parallel.make_mesh([dev] * 4, n_batch=1), hd_d, kernel_size=hd_k,
        penalty1=p1, penalty2=p2, cost_dtype="bfloat16")
    disp_np, counts = run_path(
        "sharded hd bf16", lambda: pipe_sh16.estimate(hd_left, hd_right),
        ("ssd_bf16", "sgm_chunk_bf16", "sgm_horizontal_bf16"),
        shape=(1024, 1280), d=hd_d)
    require(counts["sgm_chunk_bf16"] == 24 and counts["sgm_chunk"] == 0,
            f"sharded hd bf16 launches {counts}")
    hd_chunk_launches_bf16 = counts["sgm_chunk_bf16"]
    n_diff = int((disp_np != single_hd16).sum())
    log(f"  pixels differing from the single-card bf16 path: {n_diff} of "
        f"{disp_np.size}")
    require(n_diff == 0, f"sharded hd bf16 differs from the single-card "
            f"bf16 path at {n_diff} pixels")
    del pipe_hd16, pipe_sh16, single_hd16
    torch.cuda.empty_cache()

    # With several cards, one tile per card (teddy: 375 rows in 3 or 5
    # tiles; HD: 1024 rows in 2, 4 or 8), against the goldens and the
    # single-card path, timed beside the same tiling on cuda:0.
    n_cards = torch.cuda.device_count()
    for tag, choices in (("teddy", (3, 5)), ("hd", (2, 4, 8))):
        tiles = max([t for t in choices if t <= n_cards], default=1)
        if tiles == 1:
            log(f"[sharded path] one tile per card, {tag}: not run "
                f"({n_cards} card)")
            continue
        log(f"[sharded path] exact ssd -> sgm -> wta, {tag} over {tiles} "
            f"row tiles, one per card")
        t_left, t_right, _, t_d, t_k = shapes[tag]
        spread, stacked = (parallel.ShardedPipeline(
            parallel.make_mesh(devices, n_batch=1), t_d, kernel_size=t_k,
            penalty1=p1, penalty2=p2) for devices in (
                [torch.device("cuda", i) for i in range(tiles)],
                [dev] * tiles))
        disp_np, _ = run_path(
            f"sharded {tag} one tile per card",
            lambda: spread.estimate(t_left.cpu().numpy(),
                                    t_right.cpu().numpy()),
            ("ssd", "sgm_chunk", "sgm_horizontal"),
            shape=tuple(t_left.shape), d=t_d)
        if tag == "teddy":
            check_golden("wta", disp_np, golden["wta"], gt, d,
                         GOLDEN_MAX_DIFF, float(golden["bad_pixel_vs_gt"]),
                         1e-4)
        else:
            require(np.array_equal(disp_np, single_hd),
                    "hd over one tile per card differs from the single-card "
                    "path")
            log("  pixels differing from the single-card path: 0")
        t_spread = time_ms(torch, lambda: spread.estimate(t_left, t_right))
        t_stacked = time_ms(torch, lambda: stacked.estimate(t_left, t_right))
        log(f"  end-to-end {tag}, {tiles} tiles: one per card {t_spread!r} "
            f"ms/frame, all on {dev} {t_stacked!r} ms/frame "
            f"(images on {dev}) [{card}]")
        del spread, stacked
        torch.cuda.empty_cache()
    del single_hd

    elapsed("the main paths")
    check_post_processing(torch, dev, shapes, run_path, mesh5, sharded_kw,
                          p1, p2)
    elapsed("post-processing")
    check_cost_families(torch, dev, shapes, run_path)
    elapsed("the cost families")
    image_cli = check_image_cli(torch, shapes, card)
    elapsed("stm-image")
    compiled_ms = check_compiled(torch, dev, shapes, p1, p2, card)
    elapsed("compiled()")
    cvf_plain_ms = check_plain_cvf(torch, dev, shapes, card)
    elapsed("plain CVF")
    pyramid_ms = check_pyramid_temporal(torch, dev, shapes, run_path, card)
    elapsed("the pyramid and tracker")
    tune_ms = check_tune(torch, dev, shapes, card)
    elapsed("the tuner")
    stream_out = check_stream(torch, dev, golden, counters, card)
    elapsed("the stream")
    video_out = check_video_cli(torch, golden, card)
    elapsed("stm-video")
    serve_out = check_serve(torch, golden, counters, card)
    elapsed("stm-serve")
    partition_out = check_partitioners(torch, dev, shapes, run_path, golden,
                                       p1, p2, card)
    elapsed("the partitioners")
    distributed_out = check_distributed(torch, dev, shapes, p1, p2, card)
    elapsed("the meshes over two processes")
    tiles_out = check_distributed_tiles(card)
    elapsed("the tile axes over two processes")

    def paths(tag):
        """(label, pipeline factory) of each timed path at one geometry:
        the three single-card paths, each on float32 and then on bf16
        volumes, and the sharded exact paths over sharded_tiles[tag] row
        tiles on cuda:0."""
        _, _, _, d, k = shapes[tag]
        found = []
        for label, (cost, reducer, aggr) in (
                ("ssd+sgm+wta", ("ssd", "wta", "sgm")),
                ("ssd+sgm+dyn", ("ssd", "dyn", "sgm")),
                ("census+cvf+wta", ("census", "wta", "cvf"))):
            for dtype in ("float32", "bfloat16"):
                def make(cost=cost, reducer=reducer, aggr=aggr, dtype=dtype):
                    pipe_tag = cli_common.create_pipeline(
                        cost, reducer, aggr, max_disparity=d, penalty1=p1,
                        penalty2=p2, volume_dtype=dtype)
                    if cost == "ssd":
                        pipe_tag.cost.kernel_size = k
                    return pipe_tag
                found.append((label + (" bf16" if dtype != "float32"
                                       else ""), make))
        mesh = parallel.make_mesh([dev] * sharded_tiles[tag], n_batch=1)
        for label, reducer, dtype in (
                ("sharded ssd+sgm+wta", "wta", "float32"),
                ("sharded ssd+sgm+dyn", "dynamic_programming", "float32"),
                ("sharded ssd+sgm+wta bf16", "wta", "bfloat16")):
            found.append((label, lambda reducer=reducer, dtype=dtype:
                          parallel.ShardedPipeline(
                              mesh, d, kernel_size=k, reducer=reducer,
                              penalty1=p1, penalty2=p2, cost_dtype=dtype)))
        return found

    # Phase 5: timings (CUDA events, median of REPS after WARMUP; plain
    # versions median of PLAIN_REPS after PLAIN_WARMUP); float32 and bf16
    # side by side.
    log(f"[timings] kernels and paths median of {REPS} after {WARMUP} "
        f"warm-ups, plain versions median of {PLAIN_REPS} after "
        f"{PLAIN_WARMUP}; card: {card}")
    times, bounds = {}, {}
    sharded_tiles = {"teddy": 5, "hd": 4}
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        h, w = left.shape
        bounds[tag] = kernel_bounds(h, w, d, k, 8, sharded_tiles[tag])
        bounds[tag].update(
            (f"{name}_bf16", b) for name, b in kernel_bounds(
                h, w, d, k, 8, sharded_tiles[tag], volume_bytes=2).items())
        kw = dict(max_disparity=d, kernel_size=k)
        vol = cost_ops.ssd_cost_volume(left, right, **kw)
        vol16 = cost_ops.ssd_cost_volume(left, right, cost_dtype=BF16, **kw)
        image = left.contiguous()
        out = torch.zeros_like(vol)
        result16 = torch.empty_like(vol16)
        ptr, final = dp_cuda.dp_forward_cuda(vol)
        census = cost_ops.census_hamming_cost_volume(left, right,
                                                     max_disparity=d)
        census16 = census.to(BF16)      # Hamming distances: exact in bf16
        cvf_kw = dict(radius=8, eps=1e-4, wedge_offset=0)

        def ssd_kernel(dtype):
            return lambda: ssd_cuda.diff_cost_volume_cuda(
                left, right, cost_dtype=dtype, absolute=False, **kw)

        def family_kernel(steps, volume, result=None):
            """One family's traversals as the main path launches them:
            the horizontal family writes out first, the row family adds
            onto it (a bf16 volume's last traversal rounding into
            ``result``)."""
            onto = steps[0][0] != 0

            def run():
                for i, step in enumerate(steps):
                    last = result is not None and i == len(steps) - 1
                    sgm_cuda.traverse_cuda(volume, image, out, step, p1, p2,
                                           accumulate=onto or i > 0,
                                           result=result if last else None)
            return run

        def family_plain(steps, volume):
            def run():
                acc = None
                for step in steps:
                    c = agg_ops.sweep(volume, image, p1, p2, step)
                    acc = c if acc is None else acc + c
                return acc.to(volume.dtype)
            return run

        def chunks(volume, kernel, result=None):
            return lambda: chunked_rows(volume, image, out, p1, p2,
                                        CHUNK_CUTS[tag], kernel=kernel,
                                        result=result)

        rows, horiz = agg_ops.TRAVERSALS[2:], agg_ops.TRAVERSALS[:2]
        pairs = {
            "ssd": (ssd_kernel(torch.float32),
                    lambda: cost_ops.ssd_cost_volume(left, right, **kw)),
            "sgm_rows": (family_kernel(rows, vol), family_plain(rows, vol)),
            "sgm_horizontal": (family_kernel(horiz, vol),
                               family_plain(horiz, vol)),
            "sgm_chunk": (chunks(vol, True), chunks(vol, False)),
            "dp_forward": (lambda: dp_cuda.dp_forward_cuda(vol),
                           lambda: disp_ops.dp_forward(vol)),
            "dp_backward": (
                lambda: dp_cuda.dp_backward_cuda(ptr, final),
                lambda: disp_ops.dp_backward(
                    ptr, disp_ops.dp_end_disparities(final))),
            "cvf": (lambda: cvf_cuda.guided_filter_aggregate_cuda(
                        census, image, **cvf_kw),
                    lambda: cvf_ops.guided_filter_aggregate(
                        census, image, **cvf_kw)),
            "ssd_bf16": (ssd_kernel(BF16), lambda: cost_ops.ssd_cost_volume(
                left, right, cost_dtype=BF16, **kw)),
            "sgm_rows_bf16": (family_kernel(rows, vol16, result16),
                              family_plain(rows, vol16)),
            "sgm_horizontal_bf16": (family_kernel(horiz, vol16),
                                    family_plain(horiz, vol16)),
            "sgm_chunk_bf16": (chunks(vol16, True, result16),
                               chunks(vol16, False, result16)),
            "dp_forward_bf16": (lambda: dp_cuda.dp_forward_cuda(vol16),
                                lambda: disp_ops.dp_forward(vol16)),
            "cvf_bf16": (lambda: cvf_cuda.guided_filter_aggregate_cuda(
                             census16, image, **cvf_kw),
                         lambda: cvf_ops.guided_filter_aggregate(
                             census16, image, **cvf_kw)),
        }
        for name, (kern, plain) in pairs.items():
            # Plain, kernel, kernel, plain: the two orders cancel drift.
            plain_reps = dict(warmup=PLAIN_WARMUP, reps=PLAIN_REPS)
            t_plain = [time_ms(torch, plain, **plain_reps)]
            t_kern = [time_ms(torch, kern), time_ms(torch, kern)]
            t_plain.append(time_ms(torch, plain, **plain_reps))
            times[(name, tag)] = (min(t_kern), min(t_plain))
            b_ms, b_by, floor_ms = bounds[tag][name]
            log(f"  {name} {tag}: kernel {t_kern} ms, plain {t_plain} ms, "
                f"bound {b_ms!r} ms ({b_by}), design floor {floor_ms!r} ms "
                f"[{card}]")

        for label, volume in (("float32", vol), ("bf16", vol16)):
            t_wta = time_ms(torch, lambda: pipe.disparity_reduce(volume))
            log(f"  wta (torch.argmin) {label} {tag}: {t_wta!r} ms "
                f"[{card}]")
        t_census = time_ms(torch, lambda: cost_ops.census_hamming_cost_volume(
            left, right, max_disparity=d))
        log(f"  census plain {tag}: {t_census!r} ms [{card}]")
        # The whole CVF call (pairs["cvf"]) is the guide planes in PyTorch
        # plus the two launches; each timed alone here.
        planes = cvf_ops.guide_planes(image, 8, 0, d)
        for name, volume in (("cvf", census), ("cvf_bf16", census16)):
            t_cvf = [time_ms(torch, lambda: cvf_cuda._launch_kernels(
                volume, planes, 8, 1e-4, 0)) for _ in range(2)]
            times[(f"{name}_kernels", tag)] = min(t_cvf)
            log(f"  {name} {tag}: stats + filter launches alone {t_cvf} ms, "
                f"whole call {times[(name, tag)][0]!r} ms [{card}]")
        t_planes = time_ms(torch, lambda: cvf_ops.guide_planes(image, 8, 0, d))
        log(f"  cvf guide planes {tag}: {t_planes!r} ms [{card}]")
        del planes
        del vol, vol16, out, result16, ptr, final, census, census16
        torch.cuda.empty_cache()

        # Each path twice, in order and then in reverse, so that float32
        # and bf16 take both places; the lower median of the two is kept.
        order = paths(tag)
        for label, make in order + order[::-1]:
            pipe_tag = make()
            e2e = time_ms(torch, lambda: pipe_tag.estimate(left, right))
            times[(label, tag)] = min(e2e, times.get((label, tag), e2e))
            log(f"  end-to-end {label} {tag} {tuple(left.shape)} D={d}: "
                f"{e2e!r} ms/frame = {1000.0 / e2e!r} frames/s "
                f"(device-resident images) [{card}]")
            del pipe_tag
            torch.cuda.empty_cache()

    # Where bf16 storage starts to pay for SGM: ssd+sgm+wta on float32
    # and on bf16 volumes, in turns, at frame sizes between teddy and HD
    # (cli_common.recommended_dtype takes its threshold from these).
    log(f"[dtype crossover] ssd+sgm+wta, float32 against bf16, median of "
        f"{REPS}, turns f32, bf16, bf16, f32; card: {card}")
    for h, w, d in CROSSOVER_SIZES:
        c_left, c_right, _ = stereo_pair(h, w, d, seed=3)
        c_left = torch.from_numpy(c_left).to(dev)
        c_right = torch.from_numpy(c_right).to(dev)
        ms = {"float32": [], "bfloat16": []}
        for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
            pipe_c = cli_common.create_pipeline(
                "ssd", "wta", "sgm", max_disparity=d, penalty1=p1,
                penalty2=p2, volume_dtype=dtype)
            ms[dtype].append(time_ms(
                torch, lambda: pipe_c.estimate(c_left, c_right)))
            del pipe_c
        log(f"  {h}x{w} D={d} ({h * w / 1e6:.2f} MP): float32 "
            f"{ms['float32']} ms, bf16 {ms['bfloat16']} ms [{card}]")
        del c_left, c_right
        torch.cuda.empty_cache()

    refined_ms = time_post_processing(torch, shapes, p1, p2, card)
    family_ms = time_cost_families(torch, shapes, card)

    elapsed("the timings, the dtype crossover and the refined and "
            "cost-family timings")

    # Phase 6: where the time goes, per path and geometry, from a
    # torch.profiler capture (device kernel time against host wall time).
    log("[profile] torch.profiler, 10 frames after one warm-up, "
        "device-resident images")
    chunk_device = {}
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        for label, make in paths(tag):
            pipe_tag = make()
            wall, by_name, spans, ops = profile_path(
                torch, lambda: pipe_tag.estimate(left, right))
            busy = sum(by_name.values())
            require(busy > 0, f"the profiler saw no device time in {label}")
            log(f"  {label} {tag}: wall {wall!r} ms/frame, device busy "
                f"{busy!r} ms/frame, idle share {1.0 - busy / wall!r}, "
                f"{ops!r} device operations/frame [{card}]")
            log(f"    stage spans (device timeline) ms/frame: {spans}")
            if label.startswith("sharded ssd+sgm+wta"):
                # The chunk kernel's device time against its CUDA-event
                # time (phase 5), which also holds the host's time to
                # enqueue its launches.
                key = "sgm_chunk" + ("_bf16" if "bf16" in label else "")
                chunk_device[(key, tag)] = sum(
                    ms for name, ms in by_name.items()
                    if "sgm_chunk_kernel" in name)
                require(chunk_device[(key, tag)] > 0,
                        f"the profiler saw no sgm_chunk_kernel in {label}")
                log(f"    {key} {tag}: device {chunk_device[(key, tag)]!r} "
                    f"ms/frame (profiler), CUDA events "
                    f"{times[(key, tag)][0]!r} ms (its launches alone, host "
                    f"enqueueing included) [{card}]")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            for name, ms in top:
                log(f"    {ms!r} ms/frame  {name[:90]}")
            del pipe_tag
            torch.cuda.empty_cache()

    require("jax" not in sys.modules, "jax was imported")
    require(not any(m == "stereomatch_tpu" or m.startswith("stereomatch_tpu.")
                    for m in sys.modules),
            "the JAX package was imported")

    sources = {"ssd": ("stereomatch_tpu_torch/csrc/ssd.cu",
                       "stereomatch_tpu/ops/ssd_pallas.py:121"),
               "sgm_rows": ("stereomatch_tpu_torch/csrc/sgm.cu",
                            "stereomatch_tpu/ops/sgm_pallas.py:323"),
               "sgm_horizontal": ("stereomatch_tpu_torch/csrc/sgm.cu",
                                  "stereomatch_tpu/ops/sgm_pallas.py:150"),
               "dp_forward": ("stereomatch_tpu_torch/csrc/dp.cu",
                              "stereomatch_tpu/ops/dp_pallas.py:40"),
               "dp_backward": ("stereomatch_tpu_torch/csrc/dp.cu",
                               "stereomatch_tpu/ops/dp_pallas.py:83"),
               "cvf": ("stereomatch_tpu_torch/csrc/cvf.cu",
                       "stereomatch_tpu/ops/cvf_pallas.py:105"),
               "sgm_chunk": ("stereomatch_tpu_torch/csrc/sgm.cu",
                             "stereomatch_tpu/ops/sgm_pallas.py:552")}
    # The bf16 instantiations of the same kernels, in the same sources;
    # the DP walk reads no costs and has none.
    for name in ("ssd", "sgm_rows", "sgm_horizontal", "dp_forward", "cvf",
                 "sgm_chunk"):
        sources[f"{name}_bf16"] = sources[name]
    kernels = []
    for name, (source, replaces) in sources.items():
        b_ms, b_by, _ = bounds["teddy"][name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[f"{name}_teddy"],
            "ms": times[(name, "teddy")][0],
            "plain_ms": times[(name, "teddy")][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "hd_ms": times[(name, "hd")][0],
            "hd_plain_ms": times[(name, "hd")][1],
            "hd_bound_ms": bounds["hd"][name][0],
        }
        if name.startswith("cvf"):
            # K10, the W-chunked form of the same TPU kernel, at HD.
            entry["also_replaces"] = "stereomatch_tpu/ops/cvf_pallas.py:679"
            entry["launches_filter_kernel"] = launches[
                name.replace("cvf", "cvf_filter")]
            # The two launches alone, on precomputed guide planes.
            entry["kernel_ms"] = times[(f"{name}_kernels", "teddy")]
            entry["hd_kernel_ms"] = times[(f"{name}_kernels", "hd")]
        if name.startswith("sgm_chunk"):
            # K6, the W-on-grid form of the same TPU kernel, at HD; the
            # launches are those of the sharded exact path (teddy, 5
            # tiles; HD, 4 tiles).
            entry["also_replaces"] = "stereomatch_tpu/ops/sgm_pallas.py:627"
            entry["hd_launches"] = (hd_chunk_launches_bf16
                                    if name.endswith("bf16")
                                    else hd_chunk_launches)
            # Device time a frame in the sharded path (profiler).
            entry["device_ms"] = chunk_device[(name, "teddy")]
            entry["hd_device_ms"] = chunk_device[(name, "hd")]
        kernels.append(entry)
    e2e = {label: {tag: times[(label, tag)] for tag in ("teddy", "hd")}
           for label, _ in paths("teddy")}
    # Computed from the shapes, as bound_ms is; kept off the kernels line,
    # whose other numbers are measured.
    log(json.dumps({"design_floor_ms": {
        name: {tag: bounds[tag][name][2] for tag in ("teddy", "hd")}
        for name in sources}, "card": card}))
    log(json.dumps({"refined_ms": refined_ms, "card": card}))
    log(json.dumps({"cost_families": family_ms, "stm_image_s": image_cli,
                    "card": card}))
    log(json.dumps({"compiled": compiled_ms, "cvf_plain_ms": cvf_plain_ms,
                    "card": card}))
    log(json.dumps({"pyramid_temporal": pyramid_ms, "tune": tune_ms,
                    "card": card}))
    log(json.dumps({"stream": stream_out, "video_cli": video_out,
                    "serve": serve_out, "card": card}))
    log(json.dumps({"partitioners": partition_out, "card": card}))
    log(json.dumps({"distributed": distributed_out, "card": card}))
    log(json.dumps({"distributed_tiles": tiles_out, "card": card}))
    log(json.dumps({"kernels": kernels, "e2e_ms": e2e, "card": card}))
    log(f"[done] in {time.perf_counter() - started:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(distributed_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--distributed-tiles-worker"]:
        sys.exit(distributed_tiles_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
