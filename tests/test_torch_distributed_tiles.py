"""The port's tile axes and disparity blocks across processes against the
JAX package, on the CPU.

Two OS processes (``tests/torch_distributed_tiles_worker.py``, which
imports torch and the port only) join a gloo ``torch.distributed`` world
of two CPU devices each and run every partitioner over the world's
meshes, whose tile axes span both ranks: the row tiles of ``make_mesh()``
(1, 4) (exact, overlap in float32 and bf16, DP, the refined flags, the
smoother, ZNCC, census + CVF, ``auto``, the pyramid, the tracker), the
2-D tiles of ``make_mesh_2d`` (1, 2, 2) and (1, 1, 4) (WTA, DP and the
LR fill across tile_w, the sub-pixel flags, the weighted median, PKRN
gate and background speckle fill) and the disparity blocks of
``make_disp_mesh()`` (4 blocks).  Each rank returns its shards, one
``(index, tensor)`` pair per device it owns; each must equal, at its
index, the JAX package's result on one process over a 4-device CPU mesh
of the same shape: 0 differing elements, and the tracker's poor fraction
exactly.  One tolerance is stated: JAX's own tiled sub-pixel step is a
last place off its single-device step (ROADMAP C), so that case is held
within its 1e-4.  The smoother is held to JAX's single-device pipeline
at 0 differing elements (JAX's sharded smoother departs from it within
its documented 4e-4).  Exact modes also equal JAX's single device.

The transport is held too: each rank computed only its own tiles
(counted calls and rows), a block crosses bit for bit in float32, int32
and bf16, and a partner that dies makes the survivor raise within the
timeout.  Every wait on a worker has a timeout, after which all are
killed.
"""

import ast
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatch_tpu import cli_common as jax_cli_common
from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu.aggregation import Semiglobal
from stereomatch_tpu.cost import SSD
from stereomatch_tpu.disparity_reduce import (DynamicProgramming,
                                              WinnerTakesAll)
from stereomatch_tpu_torch.parallel.ici_model import select_sgm_mode

from . import torch_distributed_tiles_worker as worker

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
RANKS = (0, 1)
D, K = worker.D, worker.K
SUBPIXEL_TOLERANCE = 1e-4            # JAX's tiled sub-pixel step's own
CASES = (list(worker.SHARDED_CASES) + ["pyramid", "track"]
         + list(worker.TILED_CASES) + list(worker.DISP_CASES))


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _launch(mode: str, out: Path) -> list:
    address = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    return [subprocess.Popen(
        [sys.executable,
         str(ROOT / "tests" / "torch_distributed_tiles_worker.py"), mode,
         str(rank), address, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for rank in RANKS]


def _report(proc) -> tuple:
    stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    lines = [line for line in stdout.splitlines()
             if line.startswith("TORCH_TILES_OK ")]
    report = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    return proc.returncode, report, f"{stdout}\n{stderr}"


def _auto_mode() -> str:
    return select_sgm_mode(height=worker.HEIGHT, width=worker.WIDTH,
                           disp=D, tiles=4, batch=worker.FRAMES,
                           overlap=64)[0]


def _jax_case(case: dict) -> dict:
    kw = {"kernel_size": K, **case}
    if kw.get("cost_dtype") == "bfloat16":
        kw["cost_dtype"] = jnp.bfloat16
    if kw.get("sgm_mode") == "auto":
        kw["sgm_mode"] = _auto_mode()
    return kw


def _jax_references(left, right, prev) -> dict:
    """JAX's partitioners on one process over 4 CPU devices in the
    meshes' shapes, and its single-device pipeline."""
    devices = jax.devices()[:4]
    mesh = jax_parallel.make_mesh(devices, n_batch=1)
    refs = {}
    for name, case in worker.SHARDED_CASES.items():
        if name == "fgs":
            continue
        refs[name] = np.asarray(jax_parallel.ShardedPipeline(
            mesh, D, backend="xla", **_jax_case(case)).estimate(left, right))
    refs["pyramid"] = np.asarray(jax_parallel.make_pyramid_sharded_estimate(
        mesh, max_disparity=D, levels=1, backend="xla")(left, right))
    disp, frac = jax_parallel.make_temporal_track_sharded(
        mesh, max_disparity=D)(left, right, prev)
    refs["track"], refs["track_poor_fraction"] = (np.asarray(disp),
                                                  np.asarray(frac))
    for name, (grid, kw) in worker.TILED_CASES.items():
        refs[name] = np.asarray(jax_parallel.make_tiled2d_estimate(
            jax_parallel.make_mesh_2d(devices, *grid), max_disparity=D,
            kernel_size=K, backend="xla", **kw)(left, right))
    for name, kw in worker.DISP_CASES.items():
        refs[name] = np.asarray(jax_parallel.make_disp_sharded_wta(
            jax_parallel.make_disp_mesh(devices), max_disparity=D,
            **kw)(left[0], right[0]))
    single = {"exact": [], "dp": [], "fgs": []}
    pipe = jax_cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=D)
    pipe.cost.kernel_size = K
    for b in range(worker.FRAMES):
        vol = Semiglobal(backend="xla")(
            SSD(D, kernel_size=K)(left[b], right[b]), left[b])
        single["exact"].append(np.asarray(WinnerTakesAll()(vol)))
        single["dp"].append(np.asarray(
            DynamicProgramming(backend="xla")(vol)))
        single["fgs"].append(np.asarray(pipe.estimate_refined(
            left[b], right[b], median=False, subpixel=False,
            **worker.SHARDED_CASES["fgs"])))
    single = {name: np.stack(frames) for name, frames in single.items()}
    single["overlap"] = single["exact"]      # the overlap covers the tiles
    refs["single"] = single
    refs["fgs"] = single["fgs"]
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' reports and shards, the dead-partner run's, and JAX's
    references (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("tiles")
    procs = _launch("run", out) + _launch("die", out)
    try:
        refs = _jax_references(*worker.stacks())
        results = [_report(proc) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    for rc, report, text in results[:2]:
        assert rc == 0 and report is not None, text
    arrays = [dict(np.load(out / f"rank{rank}.npz")) for rank in RANKS]
    return {"reports": [r[1] for r in results[:2]], "arrays": arrays,
            "die": results[2:], "refs": refs}


def _shards(run, rank, case):
    report, arrays = run["reports"][rank], run["arrays"][rank]
    for i, shard in enumerate(report["shards"][case]):
        index = tuple(slice(None) if s is None else slice(*s)
                      for s in shard["index"])
        yield index, arrays[f"{case}/{i}"], shard["device"]


@pytest.mark.parametrize("rank", RANKS)
def test_world_meshes_span_both_ranks(run, rank):
    """``make_mesh()``, ``make_hybrid_mesh(n_tile=4)``, ``make_mesh_2d``
    and ``make_disp_mesh()`` over a world of two processes of two
    devices each lay their tile axes across both ranks, in (rank, local
    index) order, without refusing; each rank holds two devices."""
    meshes = run["reports"][rank]["meshes"]
    tiles = [{"batch": 1, "tile": 4}, [[0, 0, 1, 1]]]
    assert meshes["make_mesh"] == meshes["hybrid_n_tile_4"] == tiles
    assert meshes["mesh_2d_122"] == [{"batch": 1, "tile": 2, "tile_w": 2},
                                     [[[0, 0], [1, 1]]]]
    assert meshes["mesh_2d_114"] == [{"batch": 1, "tile": 1, "tile_w": 4},
                                     [[[0, 0, 1, 1]]]]
    assert meshes["disp"] == [{"disp": 4}, [0, 0, 1, 1]]
    assert meshes["splits_frames"] is True
    assert meshes["owned_positions"] == [[0, 2 * rank], [0, 2 * rank + 1]]
    assert meshes["frame_indices"] == [0, 1]


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_rank_shards_equal_jax(run, case, rank):
    """Each shard equals JAX's 4-device result at its index: 0 differing
    elements (the sub-pixel flags of JAX's tiled program within its own
    1e-4; the smoother against JAX's single device)."""
    ref = run["refs"][case]
    shards = list(_shards(run, rank, case))
    assert len(shards) == 2                   # one per device it owns
    for index, got, device in shards:
        assert device == "cpu"
        want = ref[index]
        assert got.shape == want.shape and got.dtype == want.dtype
        if case == "tiled_subpixel":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=SUBPIXEL_TOLERANCE)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", RANKS)
def test_tracker_poor_fraction_equals_jax(run, rank):
    """The tracker's [B] poor fraction (the tiles' counts moved to each
    rank and summed in tile order: JAX's psum over tile) equals JAX's
    exactly, on each device's shard."""
    want = run["refs"]["track_poor_fraction"]
    shards = list(_shards(run, rank, "track_poor_fraction"))
    assert len(shards) == 2
    for index, got, _ in shards:
        assert index == (slice(0, 2),)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want[index])


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", ("exact", "overlap", "dp", "fgs"))
def test_rank_shards_equal_single_device(run, case, rank):
    """The exact hand-off across the rank boundary, the covering overlap,
    DP and the smoother (its Thomas chain across ranks) equal JAX's
    single-device pipeline."""
    want = run["refs"]["single"][case]
    for index, got, _ in _shards(run, rank, case):
        np.testing.assert_array_equal(got, want[index])


# What each rank computes a run (two frames, two of four tiles or blocks
# each): calls and image rows.
COMPUTED = {
    # 6 row traversals x 2 tiles x 2 frames of 8-row chunks.
    "exact": {"sweep_chunk_with_carry": (24, 192),
              "winner_takes_all": (4, 32)},
    "overlap": {"winner_takes_all": (4, 32)},
    # The LR check's mirrored run doubles WTA.
    "refine": {"sweep_chunk_with_carry": (48, 384),
               "winner_takes_all": (8, 64)},
    "pyramid": {"sweep_chunk_with_carry": (24, 96)},
    "tiled_wta": {"winner_takes_all": (4, 64)},
    "tiled_w4_wta": {"winner_takes_all": (4, 128)},
    "disp_ssd": {"_diff_cost_dispatch": (2, 64)},
}


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("case", COMPUTED)
def test_each_rank_computes_only_its_own_tiles(run, case, rank):
    """The partitioners ran their stages on this rank's tiles (or
    blocks) only: the calls and rows counted are those of its two."""
    computed = run["reports"][rank]["computed"][case]
    for name, (calls, rows) in COMPUTED[case].items():
        assert computed["calls"].get(name, 0) == calls, (name, computed)
        assert computed["rows"].get(name, 0) == rows, (name, computed)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("dtype", ("float32", "int32", "bfloat16"))
def test_blocks_cross_bit_for_bit(run, rank, dtype):
    """A block sent by the partner lands with its shape, dtype and bytes
    (infinities, NaN payloads, signed zeros, subnormals, bf16 patterns)."""
    report, arrays = run["reports"][rank], run["arrays"][rank]
    assert report["received"][dtype] == f"torch.{dtype}"
    got = arrays[f"received/{dtype}"]
    want = worker.payloads(1 - rank)[dtype]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_dead_partner_raises_within_the_timeout(run):
    """A partner that leaves the world makes the rank waiting on its
    block raise (nothing is caught), well inside the timeout."""
    (rc0, report, text), (rc1, _, _) = run["die"]
    assert rc1 == 17
    assert rc0 == 0 and report is not None, text
    assert report["raised"] == "RuntimeError", report
    assert report["seconds"] < worker.TIMEOUT_S + 5


@pytest.mark.parametrize("rank", RANKS)
def test_refusals_that_stay(run, rank):
    """The stream and ``TemporalPipeline`` read whole batches on one host,
    so over processes they still raise, saying why; the ranks never
    imported JAX."""
    report = run["reports"][rank]
    assert "fetched whole" in report["refusals"]["stream"]
    assert "np.asarray" in report["refusals"]["stream"]
    assert "np.asarray" in report["refusals"]["temporal_pipeline"]
    assert report["jax_imported"] is False


def test_worker_imports_only_torch_and_the_port():
    tree = ast.parse((ROOT / "tests" / "torch_distributed_tiles_worker.py")
                     .read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module.split(".")[0])
    assert modules == {"json", "os", "sys", "time", "pathlib", "numpy",
                       "torch", "stereomatch_tpu_torch"}
