"""Run one cell of the benchmark on the card and print its result line.

    python portbench/run.py --workload teddy-ssd-sgm.stream8 --seed 7 \
        --seconds 20 --trace 0

The cell's configuration and traffic mix come from ``BENCHMARK.json``
and the files it names.  Set-up makes a pool of uint8 stereo frames from
the seed, builds the configuration's
``stereomatch_tpu_torch.stream.StreamingEstimator`` and warms it up;
the window then streams the pool through ``run`` for ``--seconds``.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiler slice of the window, then each stage
timed eagerly).  After the window the kept answers are judged against
the plain reference (``portbench/check.py``).  The last line of standard
output is one JSON object; the numbers compared, each with its limit,
are the last lines of standard error.  Without a CUDA device the run
fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Top-level module names the run must not have loaded.
BANNED = ("jax", "jaxlib", "flax", "stereomatch_tpu")
# Where the window's profiler slice starts, as a share of the window.
PROFILE_AT = 0.4


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def banned_modules():
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable ({err})"


def estimator_options(config: dict, traffic: dict) -> dict:
    """``StreamingEstimator`` keywords: the configuration's ``estimator``
    object as it stands, with the mix's batch and depth."""
    return dict(config["estimator"], batch=int(traffic["batch"]),
                depth=int(traffic["depth"]))


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, frames=None, overrides=None,
            estimator_cls=None):
    """Set up, warm up, run the window and judge it.  Returns (record,
    checks, result fields).  ``frames`` ends the window after that many
    frames instead of ``seconds``; ``overrides`` replaces keys of the
    configuration's ``estimator`` object (the control, faults planted by
    option); ``estimator_cls`` replaces the program's estimator (faults
    planted in code)."""
    import torch

    from portbench import check, scenes, stages, window
    from portbench import trace as trace_mod
    from stereomatch_tpu_torch.stream import StreamingEstimator

    phases = {"imports": time.perf_counter() - t_start}
    config, traffic = dict(cell.config), cell.traffic
    if overrides:
        config["estimator"] = dict(config["estimator"], **overrides)
    on_card = torch.device(device).type == "cuda"
    geometry = (int(config["height"]), int(config["width"]),
                int(config["max_disparity"]))
    mark = time.perf_counter()
    pool = scenes.pool(seed, int(traffic["pool"]), *geometry)
    phases["pool"] = time.perf_counter() - mark
    mark = time.perf_counter()
    options = estimator_options(config, traffic)
    est = (estimator_cls or StreamingEstimator)(
        geometry[2], device=device, **options)
    phases["estimator"] = time.perf_counter() - mark
    mark = time.perf_counter()

    # Warm-up: the graph capture, the staging ring and the fetch pool,
    # over the shapes the window uses (whole batches of one frame size).
    batch, depth = options["batch"], options["depth"]
    warm = max(batch * (depth + 2), 2 * len(pool))
    warm -= warm % batch
    for _ in est.run(window.PoolCapture(pool, batch, frames=warm)):
        pass
    slicer = None
    if trace:
        if not on_card:
            raise RuntimeError("--trace 1 reads the card's profiler")
        # Load the profiler's device tracing before the window.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in est.run(window.PoolCapture(pool, batch, frames=batch)):
                pass
        slicer = window.ProfilerSlice(PROFILE_AT * seconds)
    if on_card:
        torch.cuda.synchronize(device)
    gc.collect()
    phases["warm_up"] = time.perf_counter() - mark

    capture = window.PoolCapture(pool, batch, seconds=seconds, frames=frames)
    win = window.drive(est, capture, seed,
                       None if slicer is None else slicer.tick)
    stats = est.stats
    record = {
        "cell": cell.name, "config": config, "traffic": traffic,
        "setup_s": capture.read_t[0] - t_start, "setup_phases_s": phases,
        "read_t": win.read_t, "yield_t": win.yield_t,
        "stream": {"frames": stats.frames, "batches": stats.batches,
                   "seconds": stats.seconds, "decode_s": stats.decode_s,
                   "dispatch_s": stats.dispatch_s, "fetch_s": stats.fetch_s},
    }
    result = {"device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": (
                             int(torch.cuda.max_memory_allocated(device))
                             if on_card else 0)}}
    if slicer is not None:
        slicer.close()
        reduced = (trace_mod.reduce_slice(trace_mod.from_profiler(
            slicer.prof.events())) if slicer.state == 3 else None)
        if reduced is not None:
            record["trace"] = dict(reduced._asdict(), frames=slicer.frames)
            result["device"].update(busy_s=reduced.busy_s,
                                    window_s=reduced.window_s)
            result["breakdown"] = {"device_ops": reduced.ops_by_name,
                                   "idle_gaps": reduced.idle_gaps}
        # The stages of the pipeline the stream replays (none where the
        # estimator runs another path, such as a mesh or a pyramid).
        pipeline = getattr(est, "_pipeline", None)
        if pipeline is not None:
            record["stages_ms"] = stages.time_stages(torch, pipeline, pool,
                                                     device)
        del pipeline

    # The program's state goes before the reference runs.
    del est
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    # Judged against the configuration as it stands, whatever options
    # the program ran with.
    verdict = check.judge(torch, cell.reference, cell.config, pool,
                          win.kept,
                          handed=len(win.read_t), yielded=len(win.yield_t),
                          misplaced=win.misplaced, device=device)
    result.update(attempted=len(win.read_t), failed=verdict.failed)
    record["mismatch_shares"] = verdict.shares
    return record, verdict.checks, result


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import registry

    cell = registry.find_cell(args.workload)
    chips = int(next(w for w in registry.load_benchmark()["workloads"]
                     if w["name"] == args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    device = torch.device("cuda", 0)
    record, checks, result = measure(cell, args.seed, args.seconds,
                                     bool(args.trace), device, T_START)
    banned = banned_modules()
    if banned:
        log(f"portbench: the run loaded {banned}: no result")
        return 3
    metrics = cell.per_layer if args.trace else cell.end_to_end
    out = {"correct": all(c.ok for c in checks),
           "attempted": result["attempted"], "failed": result["failed"],
           "metrics": registry.read_metrics(metrics, record),
           "device": result["device"]}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    log(f"card: {card_line()}")
    log(f"set-up phases (s): {record['setup_phases_s']}")
    log(f"frames {len(record['yield_t'])}, kept {len(record['mismatch_shares'])}"
        f", mismatch shares {record['mismatch_shares']}")
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
