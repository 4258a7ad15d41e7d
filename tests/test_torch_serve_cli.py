"""The port's ``stm-serve`` (``python -m stereomatch_tpu_torch.cli.serve``)
end to end on the CPU: in-process servers on an ephemeral port, a stdlib
client, synthetic side-by-side frames (32x48 halves, D=16).

Each test of ``tests/test_serve_cli.py`` has its counterpart here (the
``--mesh`` ones over the 8 CPU devices of ``--device cpu``, as JAX's
over its 8-device CPU mesh, whatever ``WORLD_SIZE`` a launcher sets),
its responses held against the port's local
pipeline and, for the integer disparities, against the JAX package's
pipeline and mesh batcher; the port's ``npy`` responses equal
the JAX server's ``_encode`` bytes and its ``png16``/``png`` responses
decode to the JAX server's pixels.  Every server and batcher is closed
after its test, and closing one leaves no thread of it behind.
"""

import io
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatch_tpu.cli import serve as jax_serve
from stereomatch_tpu.cli_common import create_pipeline as jax_create_pipeline
from stereomatch_tpu_torch.cli import serve
from stereomatch_tpu_torch.cli.serve import _Batcher, build_parser, \
    make_server
from stereomatch_tpu_torch.cli_common import create_pipeline
from stereomatch_tpu_torch.io import png
from stereomatch_tpu_torch.ops.refine import filter_speckles

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
ROOT = Path(__file__).resolve().parent.parent
_LIVE = []


def _args(*argv):
    return build_parser().parse_args([str(D), "--device", "cpu", *argv])


def _make_batcher(args):
    """A _Batcher on its own engine, closed after the test."""
    b = _Batcher(args, serve._Engine(args))
    _LIVE.append(b)
    return b


@pytest.fixture(autouse=True)
def _close_batchers():
    yield
    while _LIVE:
        _LIVE.pop().close()


class _Running:
    """A server on a thread; ``close`` stops it and joins every thread."""

    def __init__(self, args):
        self.server = make_server(args)
        self.thread = threading.Thread(target=self.server.serve_forever)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(60)
        assert not self.thread.is_alive()


@pytest.fixture()
def running():
    started = []

    def start(*argv):
        started.append(_Running(_args("--port", "0", *argv)))
        return started[-1]
    yield start
    for srv in started:
        srv.close()


@pytest.fixture(scope="module")
def server():
    srv = _Running(_args("--port", "0"))
    yield srv.url
    srv.close()


@pytest.fixture(scope="module")
def batch_server():
    srv = _Running(_args("--port", "0", "--batch", "4", "--linger-ms",
                         "500"))
    yield srv.url
    srv.close()


@pytest.fixture(scope="module")
def scene():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    l8, r8 = (left * 255).astype(np.uint8), (right * 255).astype(np.uint8)
    sbs = np.concatenate([l8, r8], axis=1)
    return png.encode(sbs), sbs, l8.astype(np.float32), r8.astype(np.float32)


@pytest.fixture(scope="module")
def local():
    return create_pipeline("census", "wta", "sgm", max_disparity=D,
                           device="cpu")


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read(), resp.headers["Content-Type"]


def _post_npy(url, body):
    return np.load(io.BytesIO(_post(url, body)[0]))


def _healthz(url):
    with urllib.request.urlopen(f"{url}/healthz") as resp:
        return json.loads(resp.read())


def _http_error(url, body=None):
    with pytest.raises(urllib.error.HTTPError) as err:
        if body is None:
            urllib.request.urlopen(url)
        else:
            urllib.request.urlopen(urllib.request.Request(url, data=body))
    return err.value


def test_healthz(server):
    info = _healthz(server)
    assert info["status"] == "ok"
    assert info["max_disparity"] == D
    assert info["config"] == "census-wta-sgm"
    assert "batching" not in info


def test_healthz_latency_window(server, scene):
    _post(f"{server}/estimate?format=npy", scene[0])
    info = _healthz(server)
    assert info["latency"]["window"] >= 1
    assert info["latency"]["p50_ms"] > 0
    assert info["latency"]["p95_ms"] >= info["latency"]["p50_ms"]
    assert set(info["stages"]) == {"decode", "compute", "encode"}


def test_estimate_npy_matches_local_and_jax(server, scene, local):
    body, _, l8, r8 = scene
    raw, ctype = _post(f"{server}/estimate?format=npy", body)
    assert ctype == "application/octet-stream"
    disp = np.load(io.BytesIO(raw))
    assert disp.dtype == np.uint8            # narrowed: D <= 256
    np.testing.assert_array_equal(disp, local.estimate(l8, r8).numpy())
    jax_disp = np.asarray(jax_serve._narrow_for_fetch(
        jax_create_pipeline("census", "wta", "sgm", max_disparity=D,
                            backend="xla").estimate(l8, r8), D))
    np.testing.assert_array_equal(disp, jax_disp)
    # The JAX server's encoder gives the same response bytes.
    assert raw == jax_serve._encode(jax_disp, "npy", D)[0]


@pytest.mark.parametrize("fmt", ["png16", "png", "pfm"])
def test_encoded_formats_equal_jax(server, scene, fmt):
    from PIL import Image
    raw, ctype = _post(f"{server}/estimate?format={fmt}", scene[0])
    disp = _post_npy(f"{server}/estimate?format=npy", scene[0])
    want, want_type = jax_serve._encode(disp, fmt, D)
    assert ctype == want_type
    if fmt == "pfm":
        assert raw == want
    else:
        np.testing.assert_array_equal(
            png.decode(raw).array, np.asarray(Image.open(io.BytesIO(want))))


def test_estimate_png16_and_refine(server, scene, local):
    body, _, l8, r8 = scene
    raw, ctype = _post(f"{server}/estimate?format=png16&refine=1", body)
    assert ctype == "image/png"
    img = png.decode(raw)
    assert img.mode == "I;16" and img.array.shape == (32, 48)
    assert img.array.max() < D
    refined = _post_npy(f"{server}/estimate?format=npy&refine=1", body)
    assert refined.dtype == np.float32
    np.testing.assert_array_equal(refined,
                                  local.estimate_refined(l8, r8).numpy())


@pytest.mark.parametrize("kind", ["npy", "pgm", "ppm"])
def test_estimate_other_bodies_equal_png_body(server, scene, kind):
    """Raw .npy [H, 2W] and PGM/PPM bodies give the PNG body's answer for
    the same 8-bit values, without PIL."""
    png_body, sbs = scene[:2]
    buf = io.BytesIO()
    if kind == "npy":
        np.save(buf, sbs)
    elif kind == "pgm":
        buf.write(f"P5\n{sbs.shape[1]} {sbs.shape[0]}\n255\n".encode()
                  + sbs.tobytes())
    else:
        rgb = np.repeat(sbs[:, :, None], 3, axis=2)
        buf.write(f"P6\n{sbs.shape[1]} {sbs.shape[0]}\n255\n".encode()
                  + rgb.tobytes())
    via = _post_npy(f"{server}/estimate?format=npy", buf.getvalue())
    np.testing.assert_array_equal(
        via, _post_npy(f"{server}/estimate?format=npy", png_body))


def test_estimate_rejects_bad_npy_shape(server):
    buf = io.BytesIO()
    np.save(buf, np.zeros((2, 3, 4), np.uint8))
    assert _http_error(f"{server}/estimate", buf.getvalue()).code == 400


def test_estimate_speckle_matches_local_filter(server, scene, local):
    body, _, l8, r8 = scene
    disp = _post_npy(f"{server}/estimate?format=npy&speckle=1", body)
    raw = local.estimate(l8, r8).to(torch.float32)
    np.testing.assert_array_equal(
        disp, filter_speckles(raw, fill="background").numpy())


def test_estimate_rejects_garbage(server):
    err = _http_error(f"{server}/estimate", b"not a png")
    assert err.code == 400
    assert "error" in json.loads(err.read())


def test_other_formats_without_pil_answer_400(server, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    err = _http_error(f"{server}/estimate", b"GIF89a....")
    assert err.code == 400
    assert "PIL" in json.loads(err.read())["error"]


def test_unknown_path_404(server):
    assert _http_error(f"{server}/nope").code == 404


def test_sigterm_clean_exit():
    """SIGTERM right after the listening banner exits 0 after closing the
    socket: the handler is installed before the banner is printed."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from stereomatch_tpu_torch.cli.serve import main;"
         f"raise SystemExit(main(['{D}', '--port', '0', "
         "'--device', 'cpu', '--batch', '2']))"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "listening" in line, line
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_batched_concurrent_requests_match_unbatched(batch_server, scene,
                                                     local):
    """Concurrent clients, more than the cores, with a short switch
    interval: every response equals the unbatched pipeline, and the
    coalescer formed at least one multi-frame batch."""
    body, _, l8, r8 = scene
    expected = local.estimate(l8, r8).numpy()
    n = 12
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = _post_npy(f"{batch_server}/estimate?format=npy", body)

    before = _healthz(batch_server)["batching"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i in range(n):
        assert results[i] is not None, f"client {i} got no response"
        np.testing.assert_array_equal(results[i], expected)
    info = _healthz(batch_server)
    assert info["frames_served"] >= n
    stats = info["batching"]
    assert stats["max_batch"] == 4
    assert set(stats) == {"max_batch", "linger_ms", "mesh", "batches",
                          "batched_frames", "padded_frames",
                          "effective_batch", "dispatch_workers",
                          "in_flight_dispatches", "device_ms_per_frame",
                          "queue_ms_per_frame"}
    frames = stats["batched_frames"] - before["batched_frames"]
    batches = stats["batches"] - before["batches"]
    assert frames == n
    assert batches < frames, "expected a coalesced multi-frame batch"


def test_batched_speckle_matches_host_filter(batch_server, scene, local):
    body, _, l8, r8 = scene
    disp = _post_npy(f"{batch_server}/estimate?format=npy&speckle=1", body)
    raw = local.estimate(l8, r8).to(torch.float32)
    np.testing.assert_array_equal(
        disp, filter_speckles(raw, fill="background").numpy())


def test_batched_refine_matches_estimate_refined(batch_server, scene,
                                                 local):
    body, _, l8, r8 = scene
    disp = _post_npy(f"{batch_server}/estimate?format=npy&refine=1", body)
    np.testing.assert_array_equal(disp,
                                  local.estimate_refined(l8, r8).numpy())


def test_batcher_warmup_runs_every_bucket():
    batcher = _make_batcher(_args("--batch", "4", "--linger-ms", "0"))
    z = np.zeros((16, 32), np.float32)
    batcher.warmup(z, z)
    assert batcher.batches == 0 and batcher.batched_frames == 0
    assert set(batcher._fns) == {(False, False)}
    # One staging set a chunk size would exist on the card; here the
    # estimator runs the frames eagerly, so no graph is captured.
    assert batcher._fns[False, False]._compiled.graphs == {}
    out = batcher.estimate(z, z, refine=False)
    assert np.asarray(out).shape == z.shape
    assert batcher.batched_frames == 1


def test_chunk_sizes_are_powers_of_two_without_padding():
    sizes = _Batcher._chunk_sizes
    assert sizes(5, 8) == [4, 1]
    assert sizes(7, 4) == [4, 2, 1]
    assert sizes(8, 8) == [8]
    assert sizes(6, 6) == [4, 2]
    for n in range(1, 20):
        assert sum(sizes(n, 8)) == n
        assert all(s & (s - 1) == 0 for s in sizes(n, 8))
    # The JAX batcher decomposes single-chip groups the same way.
    for n in range(1, 20):
        assert sizes(n, 8) == jax_serve._Batcher._chunk_sizes(n, 1, 8)


def test_batcher_request_timeout():
    batcher = _make_batcher(_args("--batch", "2", "--request-timeout-s",
                                  "0.2", "--linger-ms", "0"))
    blocker = threading.Event()

    def hang(job):
        blocker.wait(10)
        raise RuntimeError("unblocked")

    batcher._fn = hang
    left = np.zeros((8, 12), np.float32)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not complete"):
        batcher.estimate(left, left, refine=False)
    assert time.monotonic() - t0 < 5
    blocker.set()


def test_batcher_pyramid_mode_matches_pyramid_pipeline():
    from stereomatch_tpu.pyramid import PyramidPipeline as JaxPyramid
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    batcher = _make_batcher(_args("--batch", "2", "--pyramid", "2",
                                  "--linger-ms", "0"))
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=5)
    out = batcher.estimate(left.astype(np.float32),
                           right.astype(np.float32), refine=False)
    want = PyramidPipeline(D, levels=2, device="cpu").estimate(left, right)
    np.testing.assert_array_equal(np.asarray(out, np.int32), want.numpy())
    np.testing.assert_array_equal(
        want.numpy(),
        np.asarray(JaxPyramid(D, levels=2, backend="xla").estimate(left,
                                                                   right)))


def test_batcher_mixed_keys_all_served(local):
    batcher = _make_batcher(_args("--batch", "4", "--linger-ms", "50"))
    shapes = [(24, 40), (32, 48)]
    jobs = []
    for i in range(8):
        h, w = shapes[i % 2]
        left, right, _ = synthetic_stereo_pair(h, w, D, seed=i)
        jobs.append((left.astype(np.float32), right.astype(np.float32),
                     i % 4 == 3))
    results = [None] * len(jobs)

    def client(i):
        left, right, refine = jobs[i]
        results[i] = np.asarray(batcher.estimate(left, right, refine))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (left, right, refine) in enumerate(jobs):
        assert results[i] is not None, f"job {i} unserved"
        expected = (local.estimate_refined(left, right) if refine
                    else local.estimate(left, right))
        np.testing.assert_array_equal(results[i], expected.numpy())
        assert results[i].shape == left.shape


@pytest.mark.parametrize("depth", [1, 3])
def test_batcher_pipeline_depths_match(depth, local):
    batcher = _make_batcher(_args("--batch", "4", "--linger-ms", "20",
                                  "--pipeline-depth", str(depth)))
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=5)
    left, right = left.astype(np.float32), right.astype(np.float32)
    expected = local.estimate(left, right).numpy()
    n = 9   # odd: a mix of full and short batches
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = np.asarray(batcher.estimate(left, right, refine=False))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(n):
        assert results[i] is not None, f"request {i} unserved"
        np.testing.assert_array_equal(results[i], expected)
    assert batcher.batched_frames == n


def test_batcher_pipelined_dispatch_error_fans_out():
    batcher = _make_batcher(_args("--batch", "2", "--linger-ms", "10"))
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=6)
    left, right = left.astype(np.float32), right.astype(np.float32)
    real_fn = batcher._fn
    batcher._fn = lambda job: (_ for _ in ()).throw(
        RuntimeError("dispatch boom"))
    with pytest.raises(RuntimeError, match="dispatch boom"):
        batcher.estimate(left, right, refine=False)
    batcher._fn = real_fn
    out = np.asarray(batcher.estimate(left, right, refine=False))
    assert out.shape == left.shape


def test_batcher_funnel_error_fans_out():
    """Past the direct path (batch 4): a failing enqueue fails every
    request of its batch and the workers keep serving."""
    batcher = _make_batcher(_args("--batch", "4", "--linger-ms", "200"))
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=6)
    left, right = left.astype(np.float32), right.astype(np.float32)
    real_fn = batcher._fn
    batcher._fn = lambda job: (_ for _ in ()).throw(RuntimeError("boom"))
    errors = []

    def client():
        try:
            batcher.estimate(left, right, refine=False)
        except RuntimeError as err:
            errors.append(str(err))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == ["boom"] * 3
    batcher._fn = real_fn
    assert np.asarray(batcher.estimate(left, right, False)).shape == \
        left.shape


def test_batcher_coalesces_backlog_past_linger():
    batcher = _make_batcher(_args("--batch", "4", "--linger-ms", "0"))
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=8)
    left, right = left.astype(np.float32), right.astype(np.float32)
    n = 8
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = np.asarray(batcher.estimate(left, right, refine=False))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    assert batcher.batched_frames == n
    assert batcher.batches < n, \
        "zero-linger backlog was served one request per batch"


def test_warmup_builds_every_flag_combo():
    srv = make_server(_args("--port", "0", "--batch", "2", "--warmup",
                            "24x40"))
    try:
        assert set(srv.stm_state.batcher._fns) == {
            (False, False), (False, True), (True, False), (True, True)}
    finally:
        srv.server_close()


def test_mesh_exits_2_naming_the_roadmap_item(running, scene, monkeypatch):
    """A launcher's WORLD_SIZE starts no world (C.5): as the JAX server,
    ``--mesh`` (unbatched, and batched with ``--pyramid 2``) serves this
    process's devices and answers as it does without WORLD_SIZE."""
    body = scene[0]
    for flags in (["--mesh"], ["--batch", "2", "--mesh", "--pyramid", "2",
                               "--linger-ms", "0"]):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        alone = running(*flags)
        monkeypatch.setenv("WORLD_SIZE", "2")
        world = running(*flags)
        for fmt in ("npy", "png16"):
            want, _ = _post(f"{alone.url}/estimate?format={fmt}", body)
            got, _ = _post(f"{world.url}/estimate?format={fmt}", body)
            assert got == want


def test_batcher_mesh_mode_matches_jax_and_single_chip():
    """``tests/test_serve_cli.py:364``: --mesh runs requests through the
    sharded program (frames over the batch axis, rows over 4 tiles),
    padding a lone request to fill the batch axis; each answer equals
    the JAX mesh batcher's and the local pipeline's (refined ones
    ``estimate_refined``'s), concurrent mixed keys included."""
    args = _args("--batch", "4", "--mesh", "--linger-ms", "50")
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=7)
    left, right = left.astype(np.float32), right.astype(np.float32)
    out = np.asarray(batcher.estimate(left, right, refine=False))
    jax_args = jax_serve.build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "4", "--mesh",
         "--linger-ms", "50"])
    jax_batcher = jax_serve._Batcher(jax_args)
    try:
        ref = np.asarray(jax_batcher.estimate(left, right, refine=False))
    finally:
        jax_batcher.close()
    np.testing.assert_array_equal(out, ref)
    assert batcher.padded_frames == 1            # 1 frame, batch axis 2
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           device="cpu")
    np.testing.assert_array_equal(out.astype(np.int32),
                                  pipe.estimate(left, right).numpy())
    refined = pipe.estimate_refined(left, right).numpy()
    results = [None] * 5

    def client(i):
        results[i] = np.asarray(batcher.estimate(left, right,
                                                 refine=i % 2 == 1))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, got in enumerate(results):
        want = refined if i % 2 else out
        np.testing.assert_array_equal(got, want)


def test_mesh_server_answers_as_the_jax_mesh_server(running, scene):
    """An unbatched --mesh server over HTTP: png16 and npy responses
    equal the JAX --mesh server's."""
    body = scene[0]
    srv = running("--mesh")
    jax_srv = jax_serve.make_server(jax_serve.build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--mesh"]))
    thread = threading.Thread(target=jax_srv.serve_forever)
    thread.start()
    try:
        jax_url = f"http://127.0.0.1:{jax_srv.server_port}"
        for fmt in ("npy", "png16"):
            got, _ = _post(f"{srv.url}/estimate?format={fmt}", body)
            want, _ = _post(f"{jax_url}/estimate?format={fmt}", body)
            if fmt == "npy":
                np.testing.assert_array_equal(np.load(io.BytesIO(got)),
                                              np.load(io.BytesIO(want)))
            else:
                np.testing.assert_array_equal(png.decode(got).array,
                                              png.decode(want).array)
    finally:
        jax_srv.shutdown()
        jax_srv.server_close()
        thread.join(60)


def test_mesh_pyramid_rejects_indivisible_frames(running):
    """``tests/test_serve_cli.py:507``: --mesh --pyramid 2 answers a
    30x34 frame with 400 "divisible", as the JAX server does."""
    srv = running("--batch", "2", "--mesh", "--pyramid", "2",
                  "--linger-ms", "0")
    body = png.encode(np.zeros((30, 68), np.uint8))
    err = _http_error(f"{srv.url}/estimate?format=npy", body)
    assert err.code == 400
    assert "divisible" in json.loads(err.read())["error"]


def test_serve_cvf_batched_matches_local_pipeline(running, scene):
    srv = running("-cm", "census", "-am", "cvf", "--cvf-radius", "3",
                  "--batch", "2")
    body, _, l8, r8 = scene
    disp = _post_npy(f"{srv.url}/estimate?format=npy", body)
    pipe = create_pipeline("census", "wta", "cvf", max_disparity=D,
                           cvf_radius=3, device="cpu")
    np.testing.assert_array_equal(disp.astype(np.int32),
                                  pipe.estimate(l8, r8).numpy())
    jax_pipe = jax_create_pipeline("census", "wta", "cvf", max_disparity=D,
                                   cvf_radius=3, backend="xla")
    np.testing.assert_array_equal(disp.astype(np.int32),
                                  np.asarray(jax_pipe.estimate(l8, r8)))


def test_serve_wmf_matches_local_filter(running, scene, local):
    from stereomatch_tpu_torch.ops.refine import weighted_median_filter
    srv = running("--wmf", "--wmf-sigma", "25")
    body, _, l8, r8 = scene
    got = _post_npy(f"{srv.url}/estimate?format=npy", body)
    want = weighted_median_filter(local.estimate(l8, r8),
                                  torch.from_numpy(l8), sigma=25.0,
                                  n_bins=D)
    np.testing.assert_array_equal(got.astype(np.int32), want.numpy())


def test_serve_wmf_rejects_pyramid():
    assert serve.main([str(D), "--wmf", "--pyramid", "1"]) == 2


def test_serve_lr_check_matches_local_pipeline(running, scene, local):
    srv = running("--lr-check")
    body, _, l8, r8 = scene
    got = _post_npy(f"{srv.url}/estimate?format=npy", body)
    want = local.estimate_refined(l8, r8, subpixel=False, median=False,
                                  lr_check=True, lr_mode="volume")
    np.testing.assert_array_equal(got.astype(np.float32), want.numpy())


def test_serve_fgs_matches_local_pipeline(running, scene, local):
    """JAX holds this within 1e-2; the port's server runs the port's
    pipeline stages, so it is held bit for bit."""
    srv = running("--lr-check", "--fgs", "64", "--fgs-sigma", "25")
    body, _, l8, r8 = scene
    got = _post_npy(f"{srv.url}/estimate?format=npy", body)
    want = local.estimate_refined(l8, r8, subpixel=False, median=False,
                                  lr_check=True, lr_mode="volume",
                                  fgs_lambda=64.0, fgs_sigma=25.0)
    np.testing.assert_array_equal(got, want.numpy())


def _bare_batcher(batch):
    b = _Batcher.__new__(_Batcher)        # no worker threads
    b.args = _args("--batch", str(batch))
    b.max_batch = batch
    b.eff_batch = batch
    b.adaptive = True
    b._q_ema = None
    b._d_ema = None
    b._adapt_n = 0
    b._stats_lock = threading.Lock()
    return b


def test_adaptive_batch_degrades_and_restores():
    b = _bare_batcher(8)
    for _ in range(16):
        b._adapt(4, batch_queue_s=4.0, batch_device_s=0.4)
    assert b.eff_batch == 2
    for _ in range(32):
        b._adapt(4, batch_queue_s=0.01, batch_device_s=0.4)
    assert b.eff_batch == 8
    b.adaptive = False
    b._adapt_n = 0
    for _ in range(16):
        b._adapt(4, batch_queue_s=9.0, batch_device_s=0.1)
    assert b.eff_batch == 8


def test_adaptive_batch_restore_clamps_non_pow2_cap():
    b = _bare_batcher(6)
    for _ in range(24):
        b._adapt(4, batch_queue_s=4.0, batch_device_s=0.4)
    assert b.eff_batch == 1
    seen = [b.eff_batch]
    for _ in range(40):
        b._adapt(4, batch_queue_s=0.01, batch_device_s=0.4)
        seen.append(b.eff_batch)
    assert b.eff_batch == 6
    assert max(seen) == 6, f"cap overshot the configured batch: {seen}"


def test_dtype_auto_resolves_from_warmup_geometry():
    """The port's recommended_dtype rules by H x W x D and says float32
    for CVF (measured on the H100), where the JAX one says bf16."""
    cases = [(("16", "-am", "sgm", "--warmup", "16x24"), "float32"),
             (("16", "-am", "cvf", "--warmup", "16x24"), "float32")]
    for argv, want in cases:
        args = build_parser().parse_args(
            [*argv, "--port", "0", "--device", "cpu", "--dtype", "auto"])
        srv = make_server(args)
        try:
            assert srv.stm_state.args.dtype == want
        finally:
            srv.server_close()
    # bf16 from 1280x720x64 cells up (warming that geometry on the CPU
    # would take long; the rule is what make_server calls).
    from stereomatch_tpu_torch.cli_common import recommended_dtype
    assert recommended_dtype(720, 1280, "sgm", max_disparity=256) == \
        "bfloat16"
    with pytest.raises(ValueError, match="warmup"):
        make_server(build_parser().parse_args(
            ["16", "--port", "0", "--device", "cpu", "--dtype", "auto"]))


def test_server_close_leaves_no_thread(scene):
    """A batched server that answered concurrent requests (direct and
    funnel paths) leaves no thread once closed."""
    before = {t.ident for t in threading.enumerate()}
    srv = _Running(_args("--port", "0", "--batch", "4", "--linger-ms",
                         "50", "--dispatch-workers", "3"))
    try:
        threads = [threading.Thread(target=_post, args=(
            f"{srv.url}/estimate?format=npy", scene[0])) for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        srv.server.stm_state.batcher.eff_batch = 2     # the direct path
        _post(f"{srv.url}/estimate?format=png16", scene[0])
    finally:
        srv.close()
    left = [t.name for t in threading.enumerate() if t.ident not in before]
    assert left == []
