"""The port's libstmio binding (``stereomatch_tpu_torch.native``) and the
host I/O on it: codecs, Y4M capture and the atomic build.

The binding compiles the repository's ``native/stmio.cpp`` into
``stereomatch_tpu_torch/_build/`` with ``g++``.  Where ``g++`` exists
these tests build it and fail if anything is wrong; only where there is
no ``g++`` do they skip.  Its reads are held against the port's
pure-Python parsers (``io/data.py``) and against the JAX package's
binding code (``stereomatch_tpu.native``) over the same compiled source:
the JAX module's own library is built in place by whichever process
first asks for it, which races under several test workers, so its
ctypes layer is pointed at the port's build instead of building.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import stereomatch_tpu.native as jax_native
from stereomatch_tpu.io import data as jax_data
from stereomatch_tpu_torch import native
from stereomatch_tpu_torch.io import capture, data

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the native library cannot be built")
    return native.build()


@pytest.fixture()
def jax_binding(built, monkeypatch):
    """The JAX package's binding functions over the port's library (same
    source and flags), without its in-place build."""
    monkeypatch.setattr(jax_native, "_LIB", native._load())
    return jax_native


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


def test_build_lands_in_the_build_dir_keyed_by_source(built):
    assert built.parent == ROOT / "stereomatch_tpu_torch" / "_build"
    assert built.name.startswith("libstmio-") and built.suffix == ".so"
    assert built == native.library_path()
    assert native.available()
    # Never next to the source, and nothing half-written beside it.
    assert not list((ROOT / "native").glob("libstmio-*"))
    assert not list(built.parent.glob(".libstmio-*"))


@pytest.mark.parametrize("shape", [(37, 53), (11, 7, 3)])
def test_pfm_roundtrip_and_parity(built, jax_binding, tmp_path, rng, shape):
    img = rng.random(shape).astype(np.float32)
    path = tmp_path / "a.pfm"
    native.write_pfm(path, img)
    np.testing.assert_array_equal(native.read_pfm(path), img)
    np.testing.assert_array_equal(jax_binding.read_pfm(path), img)
    # The port's writer and the JAX module's write the same bytes.
    jax_data.write_pfm(tmp_path / "j.pfm", img)
    assert path.read_bytes() == (tmp_path / "j.pfm").read_bytes()


def test_data_read_pfm_native_and_python_paths_agree(built, tmp_path, rng,
                                                     monkeypatch):
    img = rng.random((9, 13)).astype(np.float32)
    big = rng.random((3, 4)).astype(np.float32)
    native.write_pfm(tmp_path / "a.pfm", img)
    (tmp_path / "be.pfm").write_bytes(
        b"Pf\n# by hand\n4 3\n1.0\n" + big[::-1].astype(">f4").tobytes())
    via_native = [data.read_pfm(tmp_path / n) for n in ("a.pfm", "be.pfm")]
    monkeypatch.setattr(native, "available", lambda: False)
    via_python = [data.read_pfm(tmp_path / n) for n in ("a.pfm", "be.pfm")]
    for a, b, want in zip(via_native, via_python, (img, big)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)


def test_pnm_roundtrip_and_parity(built, jax_binding, tmp_path, rng):
    gray = (rng.random((21, 33)) * 255).astype(np.uint8)
    color = (rng.random((9, 13, 3)) * 255).astype(np.uint8)
    for name, img in (("g.pgm", gray), ("c.ppm", color)):
        native.write_pnm(tmp_path / name, img)
        for read in (native.read_pnm, data.read_pnm, jax_binding.read_pnm):
            got = read(tmp_path / name)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, img)


def test_load_image_native_and_python_paths_agree(built, tmp_path, rng,
                                                  monkeypatch):
    from PIL import Image
    color = (rng.random((23, 31, 3)) * 255).astype(np.uint8)
    native.write_pnm(tmp_path / "c.ppm", color)
    modes = (None, "L", "RGB")
    via_native = [data.load_image(tmp_path / "c.ppm", mode=m) for m in modes]
    monkeypatch.setattr(native, "available", lambda: False)
    via_python = [data.load_image(tmp_path / "c.ppm", mode=m) for m in modes]
    for a, b in zip(via_native, via_python):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        via_native[1], np.array(Image.fromarray(color).convert("L")))


def test_malformed_files_raise(built, tmp_path):
    (tmp_path / "bad.pgm").write_bytes(b"P9\n1 1\n255\nx")
    with pytest.raises(native.NativeIOError, match="P9"):
        native.read_pnm(tmp_path / "bad.pgm")
    with pytest.raises(native.NativeIOError, match="cannot open"):
        native.read_pfm(tmp_path / "missing.pfm")
    # io/data keeps its ValueError for a malformed file on either path.
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="PFM"):
        data.read_pfm(tmp_path / "bad.pfm")
    with pytest.raises(ValueError):
        data.load_image(tmp_path / "bad.pgm")


@pytest.mark.parametrize("prefetch", [0, 3])
def test_y4m_roundtrip(built, tmp_path, rng, prefetch):
    frames = (rng.random((7, 24, 64)) * 255).astype(np.uint8)
    native.write_y4m(tmp_path / "v.y4m", frames, fps=(25, 1))
    with native.Y4MReader(tmp_path / "v.y4m", prefetch=prefetch) as r:
        assert (r.width, r.height) == (64, 24)
        assert r.fps == (25, 1)
        got = list(r)
    assert len(got) == 7
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)


def test_y4m_capture_side_by_side_split(built, tmp_path, rng):
    frames = (rng.random((3, 16, 40)) * 255).astype(np.uint8)
    native.write_y4m(tmp_path / "sbs.y4m", frames)
    cap = capture.Y4MCapture(tmp_path / "sbs.y4m")
    for i in range(3):
        ok, img = cap.read_next()
        assert ok
        np.testing.assert_array_equal(img.left, frames[i][:, :20])
        np.testing.assert_array_equal(img.right, frames[i][:, 20:])
        np.testing.assert_array_equal(img.joined, frames[i])
    ok, _ = cap.read_next()
    assert not ok
    cap.close()


def test_image_sequence_capture_matches_jax(tmp_path, rng):
    """Directory frames load as the JAX capture loads them (BGR colour,
    gray as is) and split at width / 2."""
    from PIL import Image
    from stereomatch_tpu.io import capture as jax_capture
    rgb = (rng.random((8, 20, 3)) * 255).astype(np.uint8)
    gray = (rng.random((8, 20)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "f0.png")
    Image.fromarray(gray).save(tmp_path / "f1.png")
    port = capture.ImageSequenceCapture.from_directory(tmp_path)
    ref = jax_capture.ImageSequenceCapture.from_directory(tmp_path)
    for _ in range(2):
        (ok_p, a), (ok_r, b) = port.read_next(), ref.read_next()
        assert ok_p and ok_r
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.to_grayscale(), b.to_grayscale()):
            np.testing.assert_array_equal(x, y)
    assert not port.read_next()[0]
    with pytest.raises(RuntimeError, match="No frames"):
        capture.ImageSequenceCapture.from_directory(tmp_path / "none")


def test_stereo_capture_without_opencv_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        capture.StereoCapture.from_file("missing.mp4")


_BUILD_ONE = """
import sys
from pathlib import Path
from stereomatch_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native._load()
frames = native.read_pnm(sys.argv[2])
print(native.library_path().name, frames.shape)
"""


def test_concurrent_builds_into_one_build_dir(built, tmp_path, rng):
    """Four processes build into one empty directory at once: each loads
    a complete library, one file results, no temporary is left."""
    gray = (rng.random((5, 6)) * 255).astype(np.uint8)
    native.write_pnm(tmp_path / "g.pgm", gray)
    build_dir = tmp_path / "_build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_ONE, str(build_dir),
         str(tmp_path / "g.pgm")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.strip() == f"{built.name} (5, 6)"
    assert sorted(p.name for p in build_dir.iterdir()) == [
        built.name, "libstmio.lock"]


def test_failed_build_raises_with_compiler_output_each_time(
        built, tmp_path, monkeypatch):
    """A source that does not compile raises NativeIOError carrying g++'s
    message, at every call (nothing sticky), and leaves no partial file;
    the good source then builds and loads in the same process."""
    broken = tmp_path / "stmio.cpp"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    for _ in range(2):
        with pytest.raises(native.NativeIOError, match="error"):
            native.build()
        assert not native.available()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        "libstmio.lock"]
    monkeypatch.setattr(native, "SOURCE", ROOT / "native" / "stmio.cpp")
    assert native.available()
