"""One rank of the port's two-process run with the tile axes and the
disparity blocks across processes, on the CPU.

    python tests/torch_distributed_tiles_worker.py run RANK HOST:PORT OUT
    python tests/torch_distributed_tiles_worker.py die RANK HOST:PORT OUT

``run``: the rank joins a gloo world of two (``initialize_distributed``)
bringing two CPU devices, builds the same seeded global [2, 32, 48]
stacks as its partner, and runs every partitioner over the world's
meshes, whose tile axes span both ranks: ``make_mesh()`` (1, 4),
``make_mesh_2d(None, 1, 2, 2)`` and ``(1, 1, 4)``, ``make_disp_mesh()``
(4 blocks).  It writes its shards (``OUT/rank{RANK}.npz``: each case's
arrays and their indices) and one ``TORCH_TILES_OK {json}`` line: the
meshes it saw, what each rank computed (counted), the bytes of the
blocks the transport carried and the refusals that stay.
``die``: rank 1 leaves the world without a word and rank 0 waits on a
block from it, which must raise; it reports how long that took.
``tests/test_torch_distributed_tiles.py`` holds them against the JAX
package.  Imports the standard library, numpy, torch and the port only.
"""

import json
import os
import sys
import time
from pathlib import Path

FRAMES, HEIGHT, WIDTH, D, K = 2, 32, 48, 16, 3
OVERLAP = 24             # covers every predecessor: (4 - 1) * 32 / 4 rows
TIMEOUT_S = 60           # the group's: every send and receive
SHARDED_CASES = {
    "exact": dict(sgm_mode="exact"),
    "overlap": dict(sgm_mode="overlap", overlap=OVERLAP),
    "overlap_bf16": dict(sgm_mode="overlap", overlap=OVERLAP,
                         cost_dtype="bfloat16"),
    "dp": dict(reducer="dynamic_programming"),
    "refine": dict(lr_check=True, weighted_median=True, wmf_sigma=0.1,
                   median=True, speckle=True),
    "fgs": dict(fgs_lambda=16.0, fgs_sigma=0.08),
    "ncc": dict(cost="ncc"),
    "census_cvf": dict(cost="census", kernel_size=1, aggregation="cvf",
                       cvf_radius=2),
    "auto": dict(sgm_mode="auto"),
}
TILED_CASES = {
    "tiled_wta": ((1, 2, 2), {}),
    "tiled_dp": ((1, 2, 2), dict(reducer="dynamic_programming")),
    "tiled_lr": ((1, 2, 2), dict(lr_check=True)),
    "tiled_subpixel": ((1, 2, 2), dict(median=True, subpixel=True,
                                       speckle=True)),
    "tiled_refine": ((1, 2, 2), dict(lr_check=True, weighted_median=True,
                                     wmf_sigma=0.1, median=True,
                                     min_confidence=0.05, speckle=True,
                                     speckle_fill="background")),
    "tiled_w4_wta": ((1, 1, 4), {}),
    "tiled_w4_dp": ((1, 1, 4), dict(reducer="dynamic_programming")),
    "tiled_w4_lr": ((1, 1, 4), dict(lr_check=True)),
}
DISP_CASES = {
    "disp_ssd": dict(kernel_size=K),
    "disp_census_cvf": dict(cost="census", aggregation="cvf"),
}


def stacks():
    """The global [FRAMES, HEIGHT, WIDTH] left and right stacks and the
    tracker's previous disparity (the scenes' ground truth), the same on
    every process."""
    import numpy as np

    from stereomatch_tpu_torch.io.synthetic import stereo_pair

    pairs = [stereo_pair(HEIGHT, WIDTH, D, seed=s) for s in range(FRAMES)]
    prev = np.stack([np.clip(p[2], 0, D - 1) for p in pairs])
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            prev.astype(np.int32))


def payloads(rank: int) -> dict:
    """The blocks rank ``rank`` sends its partner: float32 with infinities,
    NaNs, signed zeros and subnormals, int32 over its whole range, and
    bf16 bit patterns (as int16) that include NaN payloads."""
    import numpy as np

    rng = np.random.default_rng(100 + rank)
    f32 = rng.standard_normal((5, 7, 3)).astype(np.float32)
    f32.flat[:6] = [np.inf, -np.inf, np.nan, -0.0, 1e-45, -3e-39]
    i32 = rng.integers(-2 ** 31, 2 ** 31, (9, 4), dtype=np.int64)
    i32 = i32.astype(np.int32)
    bf16 = rng.integers(-2 ** 15, 2 ** 15, (6, 11), dtype=np.int64)
    bf16 = bf16.astype(np.int16)
    bf16.flat[:3] = [0x7F81, -0x7F, 0x7F80]          # NaN, NaN, +inf
    return {"float32": f32, "int32": i32, "bfloat16": bf16}


def _join(rank: int, address: str, devices) -> None:
    from stereomatch_tpu_torch.parallel import initialize_distributed

    initialize_distributed(coordinator_address=address, num_processes=2,
                           process_id=rank, local_devices=devices,
                           initialization_timeout=TIMEOUT_S)


def _layout(mesh) -> list:
    return [mesh.shape, mesh.processes]


def _index(index) -> list:
    return [None if s.start is None else [s.start, s.stop] for s in index]


class Counts:
    """Calls of a few functions of the partitioners, by name, and the
    image rows they saw: what this rank computed."""

    def __init__(self):
        self.calls, self.rows = {}, {}

    def wrap(self, module, name):
        """Count ``module.name``'s calls and its first argument's rows."""
        inner = getattr(module, name)

        def counted(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            self.rows[name] = self.rows.get(name, 0) + args[0].shape[0]
            return inner(*args, **kwargs)

        setattr(module, name, counted)

    def take(self) -> dict:
        out = {"calls": self.calls, "rows": self.rows}
        self.calls, self.rows = {}, {}
        return out


def run(rank: int, address: str, out_dir: Path) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from stereomatch_tpu_torch.parallel import (
        ShardedPipeline, make_disp_mesh, make_disp_sharded_wta,
        make_hybrid_mesh, make_mesh, make_mesh_2d,
        make_pyramid_sharded_estimate, make_temporal_track_sharded,
        make_tiled2d_estimate)
    from stereomatch_tpu_torch.parallel import (disp_sharded, sharded,
                                                tiled2d, transport)
    from stereomatch_tpu_torch.stream import StreamingEstimator
    from stereomatch_tpu_torch.temporal import TemporalPipeline

    cpu = torch.device("cpu")
    _join(rank, address, [cpu] * 2)
    counts = Counts()
    counts.wrap(sharded, "sweep_chunk_with_carry")
    counts.wrap(sharded, "winner_takes_all")
    counts.wrap(tiled2d, "winner_takes_all")
    counts.wrap(disp_sharded, "diff_cost_dispatch")

    left, right, prev = stacks()
    mesh = make_mesh()
    info = {"rank": rank, "meshes": {
        "make_mesh": _layout(mesh),
        "hybrid_n_tile_4": _layout(make_hybrid_mesh(n_tile=4)),
        "mesh_2d_122": _layout(make_mesh_2d(None, 1, 2, 2)),
        "mesh_2d_114": _layout(make_mesh_2d(None, 1, 1, 4)),
        "disp": _layout(make_disp_mesh()),
        "splits_frames": mesh.splits_frames,
        "owned_positions": mesh.owned_positions(),
        "frame_indices": mesh.frame_indices(FRAMES)}}
    arrays, shards, computed = {}, {}, {}

    def keep(case, out):
        shards[case] = []
        for i, (index, data) in enumerate(out):
            arrays[f"{case}/{i}"] = data.numpy()
            shards[case].append({"index": _index(index),
                                 "device": str(data.device)})

    for case, kw in SHARDED_CASES.items():
        keep(case, ShardedPipeline(mesh, D, **{"kernel_size": K, **kw})
             .estimate(left, right))
        computed[case] = counts.take()
    keep("pyramid", make_pyramid_sharded_estimate(
        mesh, max_disparity=D, levels=1)(left, right))
    computed["pyramid"] = counts.take()
    disp, frac = make_temporal_track_sharded(mesh, max_disparity=D)(
        left, right, prev)
    keep("track", disp)
    keep("track_poor_fraction", frac)
    for case, (grid, kw) in TILED_CASES.items():
        keep(case, make_tiled2d_estimate(
            make_mesh_2d(None, *grid), max_disparity=D, kernel_size=K,
            **kw)(left, right))
        computed[case] = counts.take()
    for case, kw in DISP_CASES.items():
        keep(case, make_disp_sharded_wta(make_disp_mesh(), max_disparity=D,
                                         **kw)(left[0], right[0]))
        computed[case] = counts.take()
    info.update(shards=shards, computed=computed)

    # Blocks through the transport, both ways in one exchange.
    other = 1 - rank
    mine = payloads(rank)
    blocks = {"float32": torch.from_numpy(mine["float32"]),
              "int32": torch.from_numpy(mine["int32"]),
              "bfloat16": torch.from_numpy(mine["bfloat16"]).view(
                  torch.bfloat16)}
    moves = []
    for name in blocks:
        for sender in (0, 1):
            block = (blocks[name] if sender == rank
                     else transport.Remote(sender, cpu))
            moves.append((block, transport.Remote(1 - sender, cpu)))
    landed = transport.exchange(moves, "bytes")
    info["received"] = {}
    for (name, sender), got in zip([(n, s) for n in blocks for s in (0, 1)],
                                   landed):
        if sender == other:
            info["received"][name] = str(got.dtype)
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
            arrays[f"received/{name}"] = got.numpy()

    def refused(fn) -> str:
        try:
            fn()
        except NotImplementedError as err:
            return str(err)
        return ""

    info["refusals"] = {
        "stream": refused(lambda: StreamingEstimator(D, mesh=mesh,
                                                     device="cpu")),
        "temporal_pipeline": refused(lambda: TemporalPipeline(D, mesh=mesh)),
    }
    np.savez(out_dir / f"rank{rank}.npz", **arrays)
    dist.barrier()
    dist.destroy_process_group()
    info["jax_imported"] = "jax" in sys.modules
    return info


def die(rank: int, address: str) -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from stereomatch_tpu_torch.parallel import transport

    cpu = torch.device("cpu")
    _join(rank, address, [cpu])
    dist.barrier()
    if rank == 1:
        os._exit(17)                  # gone, with nothing sent
    start = time.monotonic()
    try:
        transport.exchange([(transport.Remote(1, cpu),
                             transport.Remote(0, cpu))], "carry")
    except RuntimeError as err:
        return {"raised": type(err).__name__, "message": str(err)[:300],
                "seconds": time.monotonic() - start}
    return {"raised": None, "seconds": time.monotonic() - start}


if __name__ == "__main__":
    mode, rank, address, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        Path(sys.argv[4])
    result = (run(rank, address, out) if mode == "run"
              else die(rank, address))
    print("TORCH_TILES_OK " + json.dumps(result), flush=True)
