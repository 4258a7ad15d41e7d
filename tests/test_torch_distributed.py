"""The port's meshes over processes against the JAX package, on the CPU.

The counterpart of ``tests/test_distributed.py``: two OS processes
(``tests/torch_distributed_worker.py``, which imports torch and the port
only) join a gloo ``torch.distributed`` world of four CPU devices each,
rank 0 through ``initialize_distributed``'s JAX keywords and rank 1
through torch's ``env://`` variables, and run the partitioners over a
(batch=2, tile=4) hybrid mesh on the same global [4, 32, 48] stacks.
Each rank's frames (its batch row's two) must equal, bit for bit, the
same frames of JAX's ``ShardedPipeline`` (and pyramid and 2-D tile
partitioners) on one process over the 8-device CPU mesh, and of JAX's
single-device pipeline where the mode is exact.  The refusals of a mesh
over processes (an axis other than batch across them, the tracker, the
stream) are held too.  Every wait on a worker has a timeout, after which
both are killed.
"""

import ast
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu.aggregation import Semiglobal
from stereomatch_tpu.cost import SSD
from stereomatch_tpu.disparity_reduce import (DynamicProgramming,
                                              WinnerTakesAll)
from stereomatch_tpu.io.synthetic import stereo_pair
from stereomatch_tpu_torch.parallel.ici_model import select_sgm_mode

from . import torch_distributed_worker as worker

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
RANKS = (0, 1)
SHARDED_CASES = ("exact", "overlap", "dp", "refine", "auto", "pyramid",
                 "tiled2d")
SINGLE_DEVICE_CASES = ("exact", "overlap", "dp")


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _stacks():
    pairs = [stereo_pair(worker.HEIGHT, worker.WIDTH, worker.D, seed=s)
             for s in range(worker.FRAMES)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _auto_mode() -> str:
    """The mode the port's ``sgm_mode="auto"`` picks for the stacks: two
    frames a batch row over 4 tiles, the default overlap."""
    return select_sgm_mode(height=worker.HEIGHT, width=worker.WIDTH,
                           disp=worker.D, tiles=4,
                           batch=worker.FRAMES // 2, overlap=64)[0]


def _jax_references(left, right) -> dict:
    """JAX's partitioners on one process over the 8-device CPU mesh, and
    its single-device pipeline, on the same stacks."""
    mesh = jax_parallel.make_mesh(jax.devices()[:8], n_batch=2)
    kw = dict(kernel_size=worker.K, backend="xla")
    cases = dict(worker.CASES, auto=dict(sgm_mode=_auto_mode()))
    sharded = {name: np.asarray(jax_parallel.ShardedPipeline(
                   mesh, worker.D, **kw, **case).estimate(left, right))
               for name, case in cases.items()}
    sharded["pyramid"] = np.asarray(jax_parallel.make_pyramid_sharded_estimate(
        mesh, max_disparity=worker.D, levels=1, backend="xla")(left, right))
    sharded["tiled2d"] = np.asarray(jax_parallel.make_tiled2d_estimate(
        jax_parallel.make_mesh_2d(jax.devices()[:8], 2, 2, 2),
        max_disparity=worker.D, **kw)(left, right))
    single = {"exact": [], "dp": []}
    for b in range(worker.FRAMES):
        vol = Semiglobal(backend="xla")(
            SSD(worker.D, kernel_size=worker.K)(left[b], right[b]), left[b])
        single["exact"].append(np.asarray(WinnerTakesAll()(vol)))
        single["dp"].append(np.asarray(DynamicProgramming(backend="xla")(vol)))
    single = {name: np.stack(frames) for name, frames in single.items()}
    single["overlap"] = single["exact"]     # the overlap covers the tiles
    return {"sharded": sharded, "single": single}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' reports and frames, and JAX's references (computed
    while the ranks run)."""
    out = tmp_path_factory.mktemp("ranks")
    address = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_distributed_worker.py"),
         str(rank), address, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for rank in RANKS]
    try:
        refs = _jax_references(*_stacks())
        reports = []
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, f"{stdout}\n{stderr}"
            lines = [line for line in stdout.splitlines()
                     if line.startswith("TORCH_DISTRIBUTED_OK ")]
            assert lines, f"no result line:\n{stdout}\n{stderr}"
            reports.append(json.loads(lines[-1].split(" ", 1)[1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    frames = [dict(np.load(out / f"rank{rank}.npz")) for rank in RANKS]
    return reports, frames, refs


@pytest.mark.parametrize("rank", RANKS)
def test_world_mesh_and_owned_rows(run, rank):
    """Two processes, each its four devices recorded in rank order; the
    hybrid mesh (and the world's default meshes) lay batch row r on rank
    r's devices; a second ``initialize_distributed`` changes nothing."""
    report = run[0][rank]
    cpu4 = ["cpu"] * 4
    assert report["rank"] == report["process_index"] == rank
    assert report["process_count"] == 2
    assert report["world"] == report["world_after_second_call"] == [cpu4] * 2
    mesh_layout = [{"batch": 2, "tile": 4}, [[0] * 4, [1] * 4]]
    assert [report["mesh_shape"], report["processes"]] == mesh_layout
    assert report["default_mesh"] == report["make_mesh"] == mesh_layout
    assert report["spans_processes"] is True
    assert report["owned_rows"] == [rank]
    assert report["frame_indices"] == [2 * rank, 2 * rank + 1]
    assert report["local_device"] == "cpu"
    assert report["mesh_2d_processes"] == [[[0, 0], [0, 0]],
                                           [[1, 1], [1, 1]]]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", SHARDED_CASES)
def test_rank_frames_equal_jax_sharded(run, case, rank):
    """A rank's frames are those frames of JAX's partitioner on one
    process over 8 CPU devices, bit for bit (float32 after the LR
    fill)."""
    _, frames, refs = run
    want = refs["sharded"][case][2 * rank:2 * rank + 2]
    got = frames[rank][case]
    assert got.shape == want.shape == (2, worker.HEIGHT, worker.WIDTH)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", SINGLE_DEVICE_CASES)
def test_rank_frames_equal_single_device(run, case, rank):
    """Exact hand-off, the covering overlap and DP equal JAX's
    single-device pipeline on the rank's frames."""
    _, frames, refs = run
    np.testing.assert_array_equal(
        frames[rank][case], refs["single"][case][2 * rank:2 * rank + 2])


def test_auto_resolves_per_batch_row_and_logs_it(run):
    """``sgm_mode="auto"`` resolves once per geometry from the frames a
    batch row holds, and logs the pick as the JAX package does."""
    for report in run[0]:
        assert len(report["auto_log"]) == 1
        assert report["auto_log"][0].startswith(
            f"sgm_mode=auto resolved to {_auto_mode()!r} (")
        assert "'batch': 2, 'tiles': 4" in report["auto_log"][0]


REFUSALS = {
    "tile_axis": ("'tile' axis spans processes", "ROADMAP A.14"),
    "tile_w_axis": ("'tile_w' axis spans processes", "ROADMAP A.14"),
    "disp_mesh": ("'disp' axis spans processes", "ROADMAP A.14"),
    "temporal": ("drift fraction", "ROADMAP A.14"),
    "stream": ("fetched whole", "np.asarray"),
}


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_over_processes(run, name):
    """An axis other than batch across processes (a tile axis longer
    than a process's devices, 2-D tiles across them, disparity blocks of
    the world), the tracker and the stream over processes raise
    NotImplementedError on both ranks, saying why."""
    for report in run[0]:
        message = report["refusals"][name]
        for part in REFUSALS[name]:
            assert part in message, message


def test_worker_imports_only_torch_and_the_port():
    """The ranks run without JAX: the worker imports the standard
    library, numpy, torch and the port."""
    tree = ast.parse((ROOT / "tests" / "torch_distributed_worker.py")
                     .read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module.split(".")[0])
    assert modules == {"json", "logging", "os", "sys", "pathlib", "numpy",
                       "torch", "stereomatch_tpu_torch"}
