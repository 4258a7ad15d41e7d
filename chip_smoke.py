#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (stereomatch_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``stereomatch_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
main path (SSD -> 8-path SGM -> WTA at the golden teddy scene, 375x450,
D=128) through ``cli_common.create_pipeline``, checks it against the
committed golden disparities, and times kernels and pipeline with CUDA
events.  Any failure raises and exits non-zero.  The last line of
standard output is one JSON object with ``"ok": true`` and the device;
the line before it lists the kernels with their launch counts, errors
and times.  It imports nothing of JAX.
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

SSD_RTOL = 2e-6     # tests/test_ssd_pallas.py's bound: last-ulp scale of
SSD_ATOL = 2e-6     # the value or of the running-sum magnitude
SGM_RTOL = 2e-6     # the JAX package's Pallas-vs-XLA SGM bound
SGM_ATOL = 1e-5
GOLDEN_MAX_DIFF = 16        # pixels of 168,750 (0.01%); 0 expected
WARMUP, REPS = 3, 20


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


def time_ms(torch, fn) -> float:
    """Median device time of ``fn`` over REPS calls after WARMUP calls,
    each call bracketed by its own CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, ref, out, rtol, atol, exact=False) -> float:
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
    log(f"  {name}: max_abs_err={max_err!r} bit_equal={bit_equal}")
    return max_err


def main() -> int:
    import torch

    # Phase 1: device.
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    require((ROOT / "stereomatch_tpu_torch").is_dir() and GOLDEN.is_file(),
            f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from stereomatch_tpu_torch import cli_common
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.ops import _build, sgm_cuda, ssd_cuda
    from stereomatch_tpu_torch.ops import aggregation as agg_ops
    from stereomatch_tpu_torch.ops import cost as cost_ops

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
        ref = cost_ops.ssd_cost_volume(left, right, **kw)
        out = ssd_cuda.diff_cost_volume_cuda(
            left, right, cost_dtype=torch.float32, absolute=False, **kw)
        errors[f"ssd_{tag}"] = compare(f"ssd f32 {tag}", ref, out,
                                       SSD_RTOL, SSD_ATOL)
        left8 = (left * 255).to(torch.uint8)
        right8 = (right * 255).to(torch.uint8)
        compare(f"ssd int32 (uint8 images) {tag}",
                cost_ops.ssd_cost_volume(left8, right8, cost_dtype=torch.int32,
                                         **kw),
                ssd_cuda.diff_cost_volume_cuda(
                    left8, right8, cost_dtype=torch.int32, absolute=False,
                    **kw), 0, 0, exact=True)
        if tag == "ragged":
            compare(f"sad f32 {tag}",
                    cost_ops.sad_cost_volume(left, right, **kw),
                    ssd_cuda.diff_cost_volume_cuda(
                        left, right, cost_dtype=torch.float32,
                        absolute=True, **kw), SSD_RTOL, SSD_ATOL)
        del out
        # Each SGM kernel on its own family, then the whole aggregation.
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
                                             kern, SGM_RTOL, SGM_ATOL)
            del plain, kern
        compare(f"semiglobal_aggregate {tag}",
                agg_ops.semiglobal_aggregate(ref, left, penalty1=p1,
                                             penalty2=p2),
                sgm_cuda.semiglobal_aggregate_cuda(ref, left, penalty1=p1,
                                                   penalty2=p2),
                SGM_RTOL, SGM_ATOL)
        del ref
        torch.cuda.empty_cache()

    # Phase 4: the main path, through the entry points a user calls.
    log("[main path] ssd -> sgm -> wta, teddy 375x450 D=128")
    left, right, gt, d, k = shapes["teddy"]
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      penalty1=p1, penalty2=p2)
    pipe.cost.kernel_size = k
    left_np, right_np = left.cpu().numpy(), right.cpu().numpy()
    torch.cuda.synchronize()
    ssd_cuda.LAUNCHES = 0
    sgm_cuda.ROW_LAUNCHES = 0
    sgm_cuda.HORIZONTAL_LAUNCHES = 0
    disp = pipe.estimate(left_np, right_np, device="cuda")
    torch.cuda.synchronize()
    launches = {"ssd": ssd_cuda.LAUNCHES, "sgm_rows": sgm_cuda.ROW_LAUNCHES,
                "sgm_horizontal": sgm_cuda.HORIZONTAL_LAUNCHES}
    log(f"  launches: {launches}")
    for name, n in launches.items():
        require(n > 0, f"the main path launched {name} no time")
    require(disp.is_cuda and disp.dtype == torch.int32
            and tuple(disp.shape) == (375, 450),
            f"disparity {disp.device} {disp.dtype} {tuple(disp.shape)}")
    disp_np = disp.cpu().numpy()
    require(disp_np.min() >= 0 and disp_np.max() < d, "disparity out of range")
    n_diff = int((disp_np != golden["wta"]).sum())
    bad = float(np.mean((np.abs(disp_np - gt) > 1)[:, d:]))
    log(f"  pixels differing from golden wta: {n_diff} of {disp_np.size}")
    log(f"  bad-pixel vs ground truth: {bad!r} (golden "
        f"{float(golden['bad_pixel_vs_gt'])!r})")
    require(n_diff <= GOLDEN_MAX_DIFF, f"{n_diff} pixels differ from golden")
    require(bad <= float(golden["bad_pixel_vs_gt"]) + 1e-4,
            f"bad-pixel {bad} above the golden's")

    # WTA ties go to the lower disparity on the card, as on the CPU.
    tied = torch.from_numpy(
        rng.integers(0, 3, (64, 96, 40)).astype(np.float32)).to(dev)
    want = np.argmin(tied.cpu().numpy(), axis=2)
    got = pipe.disparity_reduce(tied).cpu().numpy()
    require(np.array_equal(got, want), "argmin tie order differs on CUDA")
    log("  wta tie check: ties go to the lower disparity")

    # Phase 5: timings (CUDA events, median of REPS after WARMUP).
    log(f"[timings] median of {REPS} after {WARMUP} warm-ups; card: {card}")
    times = {}
    for tag in ("teddy", "hd"):
        left, right, _, d, k = shapes[tag]
        kw = dict(max_disparity=d, kernel_size=k)
        vol = cost_ops.ssd_cost_volume(left, right, **kw)
        image = left.contiguous()
        out = torch.empty_like(vol)

        def ssd_kernel():
            ssd_cuda.diff_cost_volume_cuda(left, right,
                                           cost_dtype=torch.float32,
                                           absolute=False, **kw)

        def family_kernel(steps):
            def run():
                for i, step in enumerate(steps):
                    sgm_cuda.traverse_cuda(vol, image, out, step, p1, p2,
                                           accumulate=i > 0)
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
        }
        for name, (kern, plain) in pairs.items():
            # Plain, kernel, kernel, plain: the two orders cancel drift.
            t_plain = [time_ms(torch, plain)]
            t_kern = [time_ms(torch, kern), time_ms(torch, kern)]
            t_plain.append(time_ms(torch, plain))
            times[(name, tag)] = (min(t_kern), min(t_plain))
            log(f"  {name} {tag}: kernel {t_kern} ms, plain {t_plain} ms "
                f"[{card}]")
        t_wta = time_ms(torch, lambda: pipe.disparity_reduce(vol))
        log(f"  wta (torch.argmin) {tag}: {t_wta!r} ms [{card}]")
        del vol, out
        torch.cuda.empty_cache()

        pipe_tag = cli_common.create_pipeline("ssd", "wta", "sgm",
                                              max_disparity=d, penalty1=p1,
                                              penalty2=p2)
        pipe_tag.cost.kernel_size = k
        e2e = time_ms(torch, lambda: pipe_tag.estimate(left, right))
        times[("e2e", tag)] = e2e
        log(f"  end-to-end ssd+sgm+wta {tag} {tuple(left.shape)} D={d}: "
            f"{e2e!r} ms/frame = {1000.0 / e2e!r} frames/s "
            f"(device-resident images) [{card}]")

    require("jax" not in sys.modules, "jax was imported")

    sources = {"ssd": ("stereomatch_tpu_torch/csrc/ssd.cu",
                       "stereomatch_tpu/ops/ssd_pallas.py:121"),
               "sgm_rows": ("stereomatch_tpu_torch/csrc/sgm.cu",
                            "stereomatch_tpu/ops/sgm_pallas.py:323"),
               "sgm_horizontal": ("stereomatch_tpu_torch/csrc/sgm.cu",
                                  "stereomatch_tpu/ops/sgm_pallas.py:150")}
    kernels = []
    for name, (source, replaces) in sources.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[f"{name}_teddy"],
            "ms": times[(name, "teddy")][0],
            "plain_ms": times[(name, "teddy")][1],
            "hd_ms": times[(name, "hd")][0],
            "hd_plain_ms": times[(name, "hd")][1],
        })
    log(json.dumps({"kernels": kernels,
                    "e2e_ms": {"teddy": times[("e2e", "teddy")],
                               "hd": times[("e2e", "hd")]},
                    "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
