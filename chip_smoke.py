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

times kernels, plain versions and pipelines with CUDA events, and
profiles each path with ``torch.profiler`` (device time by kernel, idle
share; the chunk kernel's device time beside its CUDA-event time).  Every
kernel is held bit-equal to its plain version.  Any failure raises and exits non-zero; nothing falls back.  The
last line of standard output is one JSON object with ``"ok": true`` and
the device; the lines before it give each kernel's design floor (the
bytes its launches move, over the memory rate) and list the kernels with
their launch counts, errors, times and bounds.  It imports nothing of
JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_teddy_disparity.npz"
GOLDEN_CVF = ROOT / "tests" / "data" / "golden_torch_cvf_teddy.npz"

GOLDEN_MAX_DIFF = 16        # pixels of 168,750 (0.01%); 0 expected
CVF_GOLDEN_MAX_DIFF = 169   # pixels of 168,750 (0.1%); 0 expected
WARMUP, REPS = 3, 20
# The plain versions are Python loops of small launches, hundreds of ms
# a call at HD: fewer repetitions keep the run inside its time budget.
PLAIN_WARMUP, PLAIN_REPS = 1, 3
TEDDY_CUTS = (75, 150, 225, 300)     # 5 row tiles, as the sharded path
CHUNK_CUTS = {"teddy": TEDDY_CUTS, "ragged": (12,),
              "hd": (256, 512, 768)}

# The card's published rates (NVIDIA H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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


def kernel_work(h, w, d, k, r, tiles):
    """Work of each kernel's function at [h, w, d], as {name: (bytes,
    operations, design_bytes)}.

    bytes: each input read once, each output written once (float32 4
    bytes, pointers 1 byte); operations: those of the separable
    algorithm.  dp_backward reads the one pointer per pixel that its walk
    needs (and its design, :func:`dp_window_bytes` a walked column);
    sgm_chunk (the six row traversals over ``tiles`` row chunks)
    also writes and reads the [W, D] carry at each of the
    6 * (tiles - 1) hand-offs.

    design_bytes: what the kernels' launch structure moves, one launch
    per traversal as the path runs it.  sgm_rows: six traversals, each
    reading the cost volume, the image and the out volume it accumulates
    onto and writing out back (18 volumes, 6 images); sgm_horizontal: the
    family's first launch writes out without reading it (5 volumes, 2
    images); sgm_chunk: sgm_rows' traffic plus the carries; cvf: the
    stats kernel reads its tiles of the volume and the guide with their
    halos (:func:`cvf_tile_reads`) and the guide planes and writes a0 and
    b0, the filter kernel reads its tiles of a0 and b0 and the guide and
    writes the result; dp_backward reads the final costs, writes the
    disparities and copies each walked column's window.  The other
    single-pass kernels move their function's bytes."""
    vol, img, f = h * w * d, h * w, 4        # elements; float32 bytes
    hd = h * d * f
    carries = 6 * (tiles - 1) * 2 * w * d * f
    rows = (18 * vol + 6 * img) * f
    single = {
        "ssd": ((2 * img + vol) * f, vol * (2 + 4 * k)),
        "dp_forward": (vol * f + vol + hd, vol * 4),
        "dp_backward": (hd + img + img * f, h * d + 2 * img),
    }
    work = {name: (nbytes, ops, nbytes)
            for name, (nbytes, ops) in single.items()}
    work["dp_backward"] = (*single["dp_backward"],
                           hd + img * f + h * (w - 1) * dp_window_bytes(d))
    work.update({
        "sgm_rows": ((2 * vol + img) * f, vol * 9 * 6, rows),
        "sgm_chunk": ((2 * vol + img) * f + carries, vol * 9 * 6,
                      rows + carries),
        "sgm_horizontal": ((2 * vol + img) * f, vol * 9 * 2,
                           (5 * vol + 2 * img) * f),
        "cvf": ((2 * vol + 5 * img) * f + 2 * hd, vol * (16 * r + 25),
                (cvf_tile_reads(h, w, d, r, 16, 2) * (d + 1)
                 + 2 * cvf_tile_reads(h, w, d, r, 8, 3) * d
                 + 3 * vol + 5 * img) * f + 2 * hd),
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


def kernel_bounds(h, w, d, k, r, tiles):
    """{name: (bound_ms, bound_by, design_floor_ms)}: the least time of
    each kernel's function (:func:`bound`) and its design bytes over the
    card's memory rate."""
    return {name: (*bound(nbytes, ops), design / HBM_BYTES_PER_S * 1e3)
            for name, (nbytes, ops, design)
            in kernel_work(h, w, d, k, r, tiles).items()}


def profile_path(torch, fn, frames: int = 10):
    """Device time over ``frames`` calls of ``fn`` under ``torch.profiler``
    (after one warm-up call).  Returns (wall ms per frame, kernel ms per
    frame by name, stage ms per frame by span, device operations per
    frame): the pipeline's ``stm/*``
    spans appear on the device timeline too, and are kept apart from the
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / frames
    kernels, spans, count = {}, {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
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
    before it in scan order: contributions and carries bit-equal.
    Returns the max abs error (0)."""
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import sgm_cuda
    max_err, n_chunks = 0.0, 0
    for step in agg_ops.TRAVERSALS[2:]:
        carry = (None, None)
        for rank, (a, b) in enumerate(chunk_spans(vol.shape[0],
                                                  CHUNK_CUTS[tag], step)):
            kw = dict(penalty1=p1, penalty2=p2, seed=rank == 0)
            ref, ref_carry = agg_ops.sweep_chunk_with_carry(
                vol[a:b], image[a:b], step, *carry, **kw)
            out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vol[a:b], image[a:b], step, *carry, **kw)
            name = f"sgm_chunk {tag} step {step} rows {a}:{b}"
            max_err = max(max_err, compare(name, ref, out, 0, 0, exact=True,
                                           quiet=True))
            for i in range(2):
                compare(f"{name} carry", ref_carry[i], out_carry[i], 0, 0,
                        exact=True, quiet=True)
            n_chunks += 1
            carry = ref_carry
    log(f"  sgm_chunk {tag}, chunks {CHUNK_CUTS[tag]}: {n_chunks} chunk "
        f"launches, contributions and carries bit-equal")
    return max_err


def chunked_rows(vol, image, out, p1, p2, cuts, kernel):
    """The six row traversals of ``vol`` over the row chunks cut at
    ``cuts`` with carry hand-off, through the chunk kernel (``kernel``)
    or its plain version, each added onto ``out``: the sharded exact
    path's SGM rows, which add onto the horizontal family's volume."""
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import sgm_cuda
    for step in agg_ops.TRAVERSALS[2:]:
        carry = (None, None)
        for rank, (a, b) in enumerate(chunk_spans(vol.shape[0], cuts,
                                                  step)):
            kw = dict(penalty1=p1, penalty2=p2, seed=rank == 0)
            if kernel:
                _, carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                    vol[a:b], image[a:b], step, *carry, out=out[a:b],
                    accumulate=True, **kw)
            else:
                part, carry = agg_ops.sweep_chunk_with_carry(
                    vol[a:b], image[a:b], step, *carry, **kw)
                out[a:b] += part


def main() -> int:
    started = time.perf_counter()
    import torch

    # Phase 1: device.
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "stereomatch_tpu_torch").is_dir() and GOLDEN.is_file()
            and GOLDEN_CVF.is_file(),
            f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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

    # Phase 4: the paths, through the entry points a user calls; the
    # launch counts are set to 0 just before each and read just after.
    counters = {"ssd": (ssd_cuda, "LAUNCHES"),
                "sgm_rows": (sgm_cuda, "ROW_LAUNCHES"),
                "sgm_chunk": (sgm_cuda, "CHUNK_LAUNCHES"),
                "sgm_horizontal": (sgm_cuda, "HORIZONTAL_LAUNCHES"),
                "dp_forward": (dp_cuda, "FORWARD_LAUNCHES"),
                "dp_backward": (dp_cuda, "BACKWARD_LAUNCHES"),
                "cvf": (cvf_cuda, "STATS_LAUNCHES"),
                "cvf_filter": (cvf_cuda, "FILTER_LAUNCHES")}

    def run_path(label, run, kernels, shape=(375, 450), d=128):
        torch.cuda.synchronize()
        for module, attr in counters.values():
            setattr(module, attr, 0)
        disp = run()
        torch.cuda.synchronize()
        counts = {name: getattr(module, attr)
                  for name, (module, attr) in counters.items()}
        log(f"  launches: {counts}")
        for name in kernels:
            require(counts[name] > 0, f"{label} launched {name} no time")
        require(disp.is_cuda and disp.dtype == torch.int32
                and tuple(disp.shape) == shape,
                f"disparity {disp.device} {disp.dtype} {tuple(disp.shape)}")
        disp_np = disp.cpu().numpy()
        require(disp_np.min() >= 0 and disp_np.max() < d,
                "disparity out of range")
        return disp_np, counts

    def check_golden(label, disp_np, want, gt, d, max_diff, golden_bad,
                     bad_slack):
        n_diff = int((disp_np != want).sum())
        bad = float(np.mean((np.abs(disp_np - gt) > 1)[:, d:]))
        log(f"  pixels differing from golden {label}: {n_diff} of "
            f"{disp_np.size}")
        log(f"  bad-pixel vs ground truth: {bad!r} (golden {golden_bad!r})")
        require(n_diff <= max_diff, f"{n_diff} pixels differ from golden "
                f"{label}")
        require(bad <= golden_bad + bad_slack,
                f"bad-pixel {bad} above the golden's")

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
    require(cvf_counts["cvf"] == cvf_counts["cvf_filter"],
            "the two CVF kernels launched a different number of times")

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

    def paths(tag):
        """(label, pipeline factory) of each timed path at one geometry:
        the three single-card paths and the sharded exact paths over
        sharded_tiles[tag] row tiles on cuda:0."""
        _, _, _, d, k = shapes[tag]
        found = []
        for label, (cost, reducer, aggr) in (
                ("ssd+sgm+wta", ("ssd", "wta", "sgm")),
                ("ssd+sgm+dyn", ("ssd", "dyn", "sgm")),
                ("census+cvf+wta", ("census", "wta", "cvf"))):
            def make(cost=cost, reducer=reducer, aggr=aggr):
                pipe_tag = cli_common.create_pipeline(
                    cost, reducer, aggr, max_disparity=d, penalty1=p1,
                    penalty2=p2)
                if cost == "ssd":
                    pipe_tag.cost.kernel_size = k
                return pipe_tag
            found.append((label, make))
        mesh = parallel.make_mesh([dev] * sharded_tiles[tag], n_batch=1)
        for label, reducer in (("sharded ssd+sgm+wta", "wta"),
                               ("sharded ssd+sgm+dyn", "dynamic_programming")):
            found.append((label, lambda reducer=reducer:
                          parallel.ShardedPipeline(
                              mesh, d, kernel_size=k, reducer=reducer,
                              penalty1=p1, penalty2=p2)))
        return found

    # Phase 5: timings (CUDA events, median of REPS after WARMUP; plain
    # versions median of PLAIN_REPS after PLAIN_WARMUP).
    log(f"[timings] kernels and paths median of {REPS} after {WARMUP} "
        f"warm-ups, plain versions median of {PLAIN_REPS} after "
        f"{PLAIN_WARMUP}; card: {card}")
    times, bounds = {}, {}
    sharded_tiles = {"teddy": 5, "hd": 4}
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        h, w = left.shape
        bounds[tag] = kernel_bounds(h, w, d, k, 8, sharded_tiles[tag])
        kw = dict(max_disparity=d, kernel_size=k)
        vol = cost_ops.ssd_cost_volume(left, right, **kw)
        image = left.contiguous()
        out = torch.zeros_like(vol)
        ptr, final = dp_cuda.dp_forward_cuda(vol)
        census = cost_ops.census_hamming_cost_volume(left, right,
                                                     max_disparity=d)
        cvf_kw = dict(radius=8, eps=1e-4, wedge_offset=0)

        def ssd_kernel():
            ssd_cuda.diff_cost_volume_cuda(left, right,
                                           cost_dtype=torch.float32,
                                           absolute=False, **kw)

        def family_kernel(steps):
            """One family's traversals as the main path launches them:
            the horizontal family writes out first, the row family adds
            onto it."""
            onto = steps[0][0] != 0

            def run():
                for i, step in enumerate(steps):
                    sgm_cuda.traverse_cuda(vol, image, out, step, p1, p2,
                                           accumulate=onto or i > 0)
            return run

        def family_plain(steps):
            def run():
                acc = None
                for step in steps:
                    c = agg_ops.sweep(vol, image, p1, p2, step)
                    acc = c if acc is None else acc + c
            return run

        rows, horiz = agg_ops.TRAVERSALS[2:], agg_ops.TRAVERSALS[:2]
        pairs = {
            "ssd": (ssd_kernel,
                    lambda: cost_ops.ssd_cost_volume(left, right, **kw)),
            "sgm_rows": (family_kernel(rows), family_plain(rows)),
            "sgm_horizontal": (family_kernel(horiz), family_plain(horiz)),
            "sgm_chunk": (
                lambda: chunked_rows(vol, image, out, p1, p2,
                                     CHUNK_CUTS[tag], kernel=True),
                lambda: chunked_rows(vol, image, out, p1, p2,
                                     CHUNK_CUTS[tag], kernel=False)),
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

        t_wta = time_ms(torch, lambda: pipe.disparity_reduce(vol))
        log(f"  wta (torch.argmin) {tag}: {t_wta!r} ms [{card}]")
        t_census = time_ms(torch, lambda: cost_ops.census_hamming_cost_volume(
            left, right, max_disparity=d))
        log(f"  census plain {tag}: {t_census!r} ms [{card}]")
        # The whole CVF call (pairs["cvf"]) is the guide planes in PyTorch
        # plus the two launches; each timed alone here.
        planes = cvf_ops.guide_planes(image, 8, 0, d)
        t_cvf = [time_ms(torch, lambda: cvf_cuda._launch_kernels(
            census, planes, 8, 1e-4, 0)) for _ in range(2)]
        times[("cvf_kernels", tag)] = min(t_cvf)
        t_planes = time_ms(torch, lambda: cvf_ops.guide_planes(image, 8, 0, d))
        log(f"  cvf {tag}: stats + filter launches alone {t_cvf} ms, guide "
            f"planes {t_planes!r} ms, whole call {times[('cvf', tag)][0]!r} "
            f"ms [{card}]")
        del planes
        del vol, out, ptr, final, census
        torch.cuda.empty_cache()

        for label, make in paths(tag):
            pipe_tag = make()
            e2e = time_ms(torch, lambda: pipe_tag.estimate(left, right))
            times[(label, tag)] = e2e
            log(f"  end-to-end {label} {tag} {tuple(left.shape)} D={d}: "
                f"{e2e!r} ms/frame = {1000.0 / e2e!r} frames/s "
                f"(device-resident images) [{card}]")
            del pipe_tag
            torch.cuda.empty_cache()

    # Phase 6: where the time goes, per path and geometry, from a
    # torch.profiler capture (device kernel time against host wall time).
    # The first capture in a process pays the profiler's own start-up
    # (it read a 0.56 idle share where later ones read 0.11): one
    # throw-away capture takes it.
    log("[profile] torch.profiler, 10 frames after one warm-up, "
        "device-resident images")
    profile_path(torch, lambda: torch.ones(1, device=dev) + 1, frames=1)
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
            if label == "sharded ssd+sgm+wta":
                # The chunk kernel's device time against its CUDA-event
                # time (phase 5), which also holds the host's time to
                # enqueue its launches.
                chunk_device[tag] = sum(ms for name, ms in by_name.items()
                                        if "sgm_chunk_kernel" in name)
                require(chunk_device[tag] > 0,
                        f"the profiler saw no sgm_chunk_kernel in {label}")
                log(f"    sgm_chunk {tag}: device {chunk_device[tag]!r} "
                    f"ms/frame (profiler), CUDA events "
                    f"{times[('sgm_chunk', tag)][0]!r} ms (its launches "
                    f"alone, host enqueueing included) [{card}]")
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
        if name == "cvf":
            # K10, the W-chunked form of the same TPU kernel, at HD.
            entry["also_replaces"] = "stereomatch_tpu/ops/cvf_pallas.py:679"
            entry["launches_filter_kernel"] = cvf_counts["cvf_filter"]
            # The two launches alone, on precomputed guide planes.
            entry["kernel_ms"] = times[("cvf_kernels", "teddy")]
            entry["hd_kernel_ms"] = times[("cvf_kernels", "hd")]
        if name == "sgm_chunk":
            # K6, the W-on-grid form of the same TPU kernel, at HD; the
            # launches are those of the sharded exact path (teddy, 5
            # tiles; HD, 4 tiles).
            entry["also_replaces"] = "stereomatch_tpu/ops/sgm_pallas.py:627"
            entry["hd_launches"] = hd_chunk_launches
            # Device time a frame in the sharded path (profiler).
            entry["device_ms"] = chunk_device["teddy"]
            entry["hd_device_ms"] = chunk_device["hd"]
        kernels.append(entry)
    e2e = {label: {tag: times[(label, tag)] for tag in ("teddy", "hd")}
           for label, _ in paths("teddy")}
    # Computed from the shapes, as bound_ms is; kept off the kernels line,
    # whose other numbers are measured.
    log(json.dumps({"design_floor_ms": {
        name: {tag: bounds[tag][name][2] for tag in ("teddy", "hd")}
        for name in sources}, "card": card}))
    log(json.dumps({"kernels": kernels, "e2e_ms": e2e, "card": card}))
    log(f"[done] in {time.perf_counter() - started:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
