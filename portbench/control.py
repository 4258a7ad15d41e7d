"""Readings that the correctness limits are set from, on the card.

    python portbench/control.py --workload teddy-ssd-sgm.stream8 \
        --seeds 11,12,13 --seconds 3 --faults p1_ignored,path_left_out

For each seed, in one process, short windows of the cell at its own
size and load, each judged as a benchmark run judges its window: the
program as the configuration states it (the lower reading), the
control, which is the program with the configuration's ``control``
options (its own path of the next lower precision; the upper reading),
and each fault of ``--faults`` (``portbench/faults.py``), whose windows
end after ``--fault-frames`` frames.  Prints one line per window and a
JSON summary last.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-frames", type=int, default=32)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import faults, registry, run
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = registry.find_cell(args.workload)
    device = torch.device("cuda", 0)
    sides = [("program", None, None, None),
             ("control", cell.config["control"], None, None)]
    for name in filter(None, args.faults.split(",")):
        sides.append((name, *faults.planted(name, cell.config),
                      args.fault_frames))
    readings = {side[0]: {} for side in sides}
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, overrides, estimator_cls, frames in sides:
            start = time.perf_counter()
            record, checks, result = run.measure(
                cell, seed, args.seconds, False, device, start,
                frames=frames, overrides=overrides,
                estimator_cls=estimator_cls)
            values = {c.name: c.value for c in checks}
            readings[side][seed] = values
            print(f"{args.workload} {side} seed {seed}: {values} over "
                  f"{len(record['mismatch_shares'])} kept of "
                  f"{len(record['yield_t'])} frames, shares "
                  f"{record['mismatch_shares']} "
                  f"({time.perf_counter() - start:.1f} s)", flush=True)
            del record
            torch.cuda.empty_cache()
    summary = {side: {"max": {k: max(v[k] for v in r.values())
                              for k in next(iter(r.values()))},
                      "min": {k: min(v[k] for v in r.values())
                              for k in next(iter(r.values()))}}
               for side, r in readings.items()}
    print(json.dumps({"workload": args.workload, "card":
                      run.card_line(), "summary": summary,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
