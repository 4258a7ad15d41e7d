"""The port's ``stm-video`` (``python -m stereomatch_tpu_torch.cli.video``)
against the JAX package's, offline, on the CPU.

Headless runs over a directory of side-by-side PNG frames (32x48 halves,
D=16): per frame, batched (``--batch``), ``--temporal``, ``--pyramid``
and each post-processing flag.  Every output PNG of the port decodes to
the pixels of the JAX CLI's on the same frames and flags (``--backend
xla`` there, ``--device cpu`` here).  The JAX CLI's ``y4m`` mode needs
its native library, built in place (a race under several test workers),
so the port's ``y4m`` mode is held against its own ``imgdir`` mode on
the same frames instead.  ``--mesh`` (its batched, pyramid, refine,
speckle and ``--temporal`` forms: ``tests/test_video_cli.py:77,149,194,
211,247``) runs over the 8 CPU devices of ``--device cpu``, as the JAX
CLI over its 8-device CPU mesh, and gives the JAX CLI's PNGs, whatever
``WORLD_SIZE`` a launcher sets (the CLI starts no process group).  The
refused combinations exit 2 as in JAX.  The q/h/i/w/e/r key contract is
driven through a stand-in for OpenCV.
"""

import shutil
import sys
import types

import numpy as np
import pytest

from stereomatch_tpu.cli.video import main as jax_video_main
from stereomatch_tpu_torch.cli import video
from stereomatch_tpu_torch.io import png

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
N_FRAMES = 4


@pytest.fixture(scope="module")
def frames():
    out = []
    for i in range(N_FRAMES):
        left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3 + i)
        out.append(np.concatenate([(left * 255).astype(np.uint8),
                                   (right * 255).astype(np.uint8)], axis=1))
    return out


@pytest.fixture(scope="module")
def frame_dir(frames, tmp_path_factory):
    directory = tmp_path_factory.mktemp("frames")
    for i, frame in enumerate(frames):
        png.write(directory / f"frame_{i:03d}.png", frame)
    return directory


def _port(argv, out_dir):
    return video.main(argv + ["--headless", "--output-dir", str(out_dir),
                              "--device", "cpu"])


def _decoded(out_dir):
    return [png.read(p).array for p in sorted(out_dir.glob("depth_*.png"))]


# Flags run through both CLIs in imgdir mode.
CASES = {
    "per-frame": ["-am", "sgm"],
    "batched": ["-am", "sgm", "--batch", "2"],
    "batched-dyn": ["-am", "sgm", "-dm", "dyn", "--batch", "3",
                    "--depth", "1"],
    "census-cvf-batched": ["-cm", "census", "-am", "cvf", "--cvf-radius",
                           "3", "--batch", "2"],
    "temporal": ["--temporal", "--keyframe-interval", "3"],
    "pyramid": ["--pyramid", "1"],
    "pyramid-refine-batched": ["--pyramid", "1", "--refine", "--batch",
                               "2"],
    "refine": ["-am", "sgm", "--refine"],
    "lr-check-batched": ["-am", "sgm", "--lr-check", "--batch", "2"],
    "lr-check-mirror": ["-am", "sgm", "--lr-check", "--lr-mode", "mirror",
                        "--max-frames", "2"],
    "wmf-refine-batched": ["-am", "sgm", "--wmf", "--refine", "--batch",
                           "2"],
    "fgs": ["-am", "sgm", "--lr-check", "--fgs", "64", "--max-frames", "2"],
    "speckle": ["-am", "sgm", "--speckle"],
    "speckle-background-batched": ["-am", "sgm", "--speckle",
                                   "--speckle-fill", "background",
                                   "--batch", "2"],
    "bf16-batched": ["-am", "sgm", "--dtype", "bfloat16", "--batch", "4"],
    "mesh": ["-am", "sgm", "--mesh"],
    "mesh-pyramid": ["--mesh", "--pyramid", "1"],
    "mesh-refine": ["--mesh", "-am", "sgm", "--refine"],
    "mesh-speckle": ["--mesh", "--speckle"],
    "temporal-mesh": ["--temporal", "--mesh", "--keyframe-interval", "3"],
    "temporal-mesh-pyramid": ["--temporal", "--mesh", "--pyramid", "1",
                              "--keyframe-interval", "3"],
}


@pytest.mark.parametrize("case", CASES)
def test_outputs_equal_jax_cli(frame_dir, tmp_path, case):
    flags = CASES[case]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_video_main(["imgdir", str(frame_dir), str(D), *flags,
                           "--backend", "xla", "--headless",
                           "--output-dir", str(jax_dir)]) == 0
    assert _port(["imgdir", str(frame_dir), str(D), *flags], port_dir) == 0
    ref, out = _decoded(jax_dir), _decoded(port_dir)
    n = 2 if "--max-frames" in flags else N_FRAMES
    assert len(ref) == len(out) == n
    for a, b in zip(ref, out):
        assert a.shape == b.shape == (32, 48, 3)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def y4m_path(frames, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the native Y4M decoder cannot be built")
    from stereomatch_tpu_torch import native
    path = tmp_path_factory.mktemp("y4m") / "v.y4m"
    native.write_y4m(path, np.stack(frames))
    return path


@pytest.mark.parametrize("case", ["per-frame", "batched", "temporal"])
def test_y4m_mode_equals_imgdir_mode(frame_dir, y4m_path, tmp_path, case):
    flags = CASES[case]
    assert _port(["imgdir", str(frame_dir), str(D), *flags],
                 tmp_path / "a") == 0
    assert _port(["y4m", str(y4m_path), str(D), *flags],
                 tmp_path / "b") == 0
    a, b = _decoded(tmp_path / "a"), _decoded(tmp_path / "b")
    assert len(a) == len(b) == N_FRAMES
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


REFUSED = [["--pyramid", "1", "--wmf"], ["--pyramid", "1", "--lr-check"],
           ["--pyramid", "1", "--fgs", "8"], ["--temporal", "--fgs", "8"],
           ["--temporal", "--lr-check"], ["--temporal", "--wmf"],
           ["--temporal", "--batch", "2"], ["--temporal", "--refine"]]


@pytest.mark.parametrize("flags", REFUSED, ids=" ".join)
def test_refused_combinations_exit_2_as_in_jax(flags, tmp_path, capsys):
    argv = ["y4m", str(tmp_path / "missing.y4m"), str(D), *flags,
            "--headless", "--output-dir", str(tmp_path)]
    assert jax_video_main(argv) == 2
    capsys.readouterr()
    assert video.main(argv) == 2
    assert "incompatible" in capsys.readouterr().err


def test_mesh_exits_2_naming_the_roadmap_item(frame_dir, tmp_path,
                                              monkeypatch):
    """A launcher's WORLD_SIZE starts no world (C.5): as the JAX CLI,
    ``--mesh`` lays out this process's devices and writes the PNGs it
    writes without WORLD_SIZE (batched, ``--temporal``, ``--batch 4``)."""
    for extra in ([], ["--temporal"], ["--batch", "4"]):
        argv = ["imgdir", str(frame_dir), str(D), "--mesh", *extra]
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert _port(argv, tmp_path / "alone") == 0
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert _port(argv, tmp_path / "world") == 0
        alone, world = _decoded(tmp_path / "alone"), _decoded(
            tmp_path / "world")
        assert len(alone) == len(world) == N_FRAMES
        for a, b in zip(alone, world):
            np.testing.assert_array_equal(a, b)
        shutil.rmtree(tmp_path / "alone")
        shutil.rmtree(tmp_path / "world")


def test_mesh_pyramid_refuses_indivisible_frames(tmp_path, capsys):
    """``--mesh --pyramid 2`` on 30x34 halves exits 2 as the JAX CLI."""
    frames = tmp_path / "odd"
    frames.mkdir()
    png.write(frames / "f.png", np.zeros((30, 68), np.uint8))
    for flags in (["--mesh"], ["--mesh", "--temporal"]):
        argv = ["imgdir", str(frames), str(D), "--pyramid", "2", *flags,
                "--headless", "--output-dir", str(tmp_path / "out")]
        assert jax_video_main(argv + ["--backend", "xla"]) == 2
        capsys.readouterr()
        assert video.main(argv + ["--device", "cpu"]) == 2
        assert "divisible by 4" in capsys.readouterr().err


class _FakeCv2(types.ModuleType):
    """Records what the display loop shows; ``waitKey`` replays keys."""

    def __init__(self, keys):
        super().__init__("cv2")
        self.keys = list(keys)
        self.shown = []
        self.destroyed = []

    def imshow(self, name, image):
        self.shown.append((name, np.array(image)))

    def waitKey(self, delay):
        return ord(self.keys.pop(0)) if self.keys else 255

    def destroyWindow(self, name):
        self.destroyed.append(name)

    def destroyAllWindows(self):
        self.destroyed.append("*")


def test_key_contract_drives_the_display_loop(frame_dir, monkeypatch,
                                              capsys):
    """w/e toggle the RGB and rectified windows (a second press tears
    down exactly that window), r pauses (the same pair is served again)
    and resumes, h prints the keys, q quits."""
    fake = _FakeCv2(["w", "e", "r", "w", "h", "r", "q"])
    monkeypatch.setitem(sys.modules, "cv2", fake)
    assert video.main(["imgdir", str(frame_dir), str(D), "--device",
                       "cpu"]) == 0
    names = [name for name, _ in fake.shown]
    assert names.count("depthmap") == 7            # q after the 7th frame
    assert names.count("rgb") == 3                 # frames 2-4
    assert names.count("rectified") == 5           # frames 3-7
    assert fake.destroyed == ["rgb", "*"]
    # Paused after frame 3: frames 4-6 show its pair again, frame 7 the
    # 4th pair of the directory.
    depth = [img for name, img in fake.shown if name == "depthmap"]
    for i in (3, 4, 5):
        np.testing.assert_array_equal(depth[i], depth[2])
    assert not np.array_equal(depth[6], depth[2])
    assert capsys.readouterr().out.count("q/Q: Quit") == 2


def test_without_opencv_runs_headless(frame_dir, tmp_path, monkeypatch,
                                      capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.chdir(tmp_path)
    assert video.main(["imgdir", str(frame_dir), str(D), "--device", "cpu",
                       "--max-frames", "1"]) == 0
    assert "falling back to --headless" in capsys.readouterr().out
    assert len(list((tmp_path / "depthmaps").glob("depth_*.png"))) == 1


def test_calibration_rectifies_both_paths(frame_dir, tmp_path):
    """``--calib`` rectifies each pair on the per-frame and the batched
    paths (the JAX CLI's per-frame path raises NameError there: ROADMAP
    C).  Identity homographies leave the frames as they are."""
    import pickle
    calib = tmp_path / "calib.pkl"
    eye = np.eye(3, dtype=np.float32)
    calib.write_bytes(pickle.dumps({"homography0": eye,
                                    "homography1": eye}))
    runs = {"plain": [], "per-frame": ["-cal", str(calib)],
            "batched": ["-cal", str(calib), "--batch", "3"]}
    for name, flags in runs.items():
        assert _port(["imgdir", str(frame_dir), str(D), "-am", "sgm",
                      *flags], tmp_path / name) == 0
    want = _decoded(tmp_path / "plain")
    for name in ("per-frame", "batched"):
        got = _decoded(tmp_path / name)
        assert len(got) == N_FRAMES
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
