"""One rank of the port's two-process mesh run on the CPU.

    python tests/torch_distributed_worker.py RANK HOST:PORT OUT_DIR

Rank 0 joins the gloo world through ``initialize_distributed``'s JAX
keywords (``coordinator_address``, ``num_processes``, ``process_id``),
rank 1 through torch's ``env://`` variables; each brings four CPU
devices.  Every rank builds the same global [4, 32, 48] stacks from the
seeded synthetic scene, runs the partitioners over a (batch=2, tile=4)
hybrid mesh (and a (2, 2, 2) 2-D tile mesh), and writes its own frames
(``OUT_DIR/rank{RANK}.npz``) and what it saw of the world, of the
meshes whose tile axes span both ranks and of the refusal that stays
(one ``TORCH_DISTRIBUTED_OK {json}`` line on stdout) for
``tests/test_torch_distributed.py``, which holds them against the JAX
package.  Imports torch, numpy and the port only.
"""

import json
import logging
import os
import sys
from pathlib import Path

FRAMES, HEIGHT, WIDTH, D, K = 4, 32, 48, 16, 3
OVERLAP = 24           # covers every predecessor: (4 - 1) * 32 / 4 rows
CASES = {
    "exact": dict(sgm_mode="exact"),
    "overlap": dict(sgm_mode="overlap", overlap=OVERLAP),
    "dp": dict(reducer="dynamic_programming"),
    "refine": dict(lr_check=True, median=True, speckle=True),
    "auto": dict(sgm_mode="auto"),
}


def _refused(fn) -> str:
    """The message of the NotImplementedError ``fn`` raises ("" if it
    raises none)."""
    try:
        fn()
    except NotImplementedError as err:
        return str(err)
    return ""


def _layout(mesh) -> list:
    """A mesh's shape and the rank owning each of its devices."""
    return [mesh.shape, mesh.processes]


def main(rank: int, address: str, out_dir: Path) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    from stereomatch_tpu_torch.parallel import (
        ShardedPipeline, initialize_distributed, make_disp_mesh,
        make_hybrid_mesh, make_mesh, make_mesh_2d,
        make_pyramid_sharded_estimate, make_temporal_track_sharded,
        make_tiled2d_estimate)
    from stereomatch_tpu_torch.parallel import mesh as mesh_mod
    from stereomatch_tpu_torch.stream import StreamingEstimator

    cpu4 = [torch.device("cpu")] * 4
    if rank == 0:
        initialize_distributed(coordinator_address=address, num_processes=2,
                               process_id=0, local_devices=cpu4,
                               initialization_timeout=60)
    else:
        host, port = address.rsplit(":", 1)
        os.environ.update(RANK="1", WORLD_SIZE="2", MASTER_ADDR=host,
                          MASTER_PORT=port)
        initialize_distributed(local_devices=cpu4, initialization_timeout=60)
    world = mesh_mod.world_devices()
    # A second call in an initialised world returns, the world unchanged.
    initialize_distributed(coordinator_address=address, num_processes=2,
                           process_id=rank)
    info = {"rank": rank, "process_count": mesh_mod.process_count(),
            "process_index": mesh_mod.process_index(),
            "world": [[str(d) for d in local] for local in world],
            "world_after_second_call": [
                [str(d) for d in local] for local in mesh_mod.world_devices()]}

    mesh = make_hybrid_mesh(devices=cpu4)
    default = make_hybrid_mesh()
    flat = make_mesh()
    info.update(
        mesh_shape=mesh.shape, processes=mesh.processes,
        spans_processes=mesh.spans_processes, owned_rows=mesh.owned_rows(),
        frame_indices=mesh.frame_indices(FRAMES),
        local_device=str(mesh.local_device),
        default_mesh=[default.shape, default.processes],
        make_mesh=[flat.shape, flat.processes])

    pairs = [stereo_pair(HEIGHT, WIDTH, D, seed=s) for s in range(FRAMES)]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])

    picks = []

    class Picks(logging.Handler):
        def emit(self, record):
            picks.append(record.getMessage())

    logger = logging.getLogger("stereomatch_tpu_torch.parallel.sharded")
    logger.setLevel(logging.INFO)
    logger.addHandler(Picks())

    outputs = {}
    for name, kw in CASES.items():
        pipe = ShardedPipeline(mesh, D, kernel_size=K, **kw)
        outputs[name] = pipe.estimate(left, right).numpy()
    info["auto_log"] = picks
    outputs["pyramid"] = make_pyramid_sharded_estimate(
        mesh, max_disparity=D, levels=1)(left, right).numpy()
    mesh_2d = make_mesh_2d(None, 2, 2, 2)
    info["mesh_2d_processes"] = mesh_2d.processes
    outputs["tiled2d"] = make_tiled2d_estimate(
        mesh_2d, max_disparity=D, kernel_size=K)(left, right).numpy()
    np.savez(out_dir / f"rank{rank}.npz", **outputs)

    # What a mesh over processes lays out, and what it still refuses
    # (every rank makes the same collective calls in the same order:
    # make_hybrid_mesh gathers).
    track = make_temporal_track_sharded(mesh, max_disparity=D)
    info["accepted"] = {
        "tile_axis": _layout(make_hybrid_mesh(n_tile=8, devices=cpu4)),
        "tile_w_axis": _layout(make_mesh_2d(None, 1, 1, 8)),
        "disp_mesh": _layout(make_disp_mesh()),
        "temporal": _layout(mesh) if callable(track) else None,
    }
    info["refusals"] = {
        "stream": _refused(lambda: StreamingEstimator(D, mesh=mesh,
                                                      device="cpu")),
    }
    dist.barrier()
    dist.destroy_process_group()
    return info


if __name__ == "__main__":
    result = main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
    print("TORCH_DISTRIBUTED_OK " + json.dumps(result), flush=True)
