"""The port's ``stm-fetch`` (``python -m stereomatch_tpu_torch.cli.fetch``)
offline: a ``file://`` mirror built in a temporary directory stands in
for vision.middlebury.edu, as in ``tests/test_fetch_cli.py``, and the
port's dataset readers open what it fetched.  No test opens the
network."""

import zipfile

import numpy as np
import pytest

from stereomatch_tpu.cli import fetch as jax_fetch
from stereomatch_tpu_torch.cli import fetch
from stereomatch_tpu_torch.io import data, png


def test_same_datasets_and_files_as_jax():
    assert fetch.DATASETS == jax_fetch.DATASETS
    assert fetch._2003_FILES == jax_fetch._2003_FILES
    assert (fetch.MIDDLEBURY_2021, fetch.MIDDLEBURY_2003) == (
        jax_fetch.MIDDLEBURY_2021, jax_fetch.MIDDLEBURY_2003)


@pytest.fixture()
def mirror2021(tmp_path):
    """A file:// mirror holding all.zip with one 2021-layout scene."""
    scene = tmp_path / "src" / "chess1"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ("im0.png", "im1.png"):
        png.write(scene / name,
                  rng.integers(0, 255, (8, 10, 3), dtype=np.uint8))
    for name in ("disp0.pfm", "disp1.pfm"):
        data.write_pfm(scene / name, rng.random((8, 10), np.float32) * 16)
    (scene / "calib.txt").write_text("width=10\nheight=8\nndisp=16\n")
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    with zipfile.ZipFile(mirror / "all.zip", "w") as zf:
        for f in sorted(scene.rglob("*")):
            zf.write(f, f"chess1/{f.name}")
    return mirror.as_uri()


def test_fetch_middlebury2021(mirror2021, tmp_path):
    dest = tmp_path / "dl"
    rc = fetch.main(["middlebury2021", "--dest", str(dest),
                     "--base-url", mirror2021])
    assert rc == 0
    assert not (dest / "all.zip").exists()        # archive cleaned up
    ds = data.MiddleburyDataset(dest)
    assert len(ds) == 1
    item = ds[0]
    assert item["stereo_name"] == "chess1"
    assert item["left"].shape[:2] == (8, 10)
    assert item["max_disparity"] == 16
    assert item["gt_disparity"].shape == (8, 10)


def test_fetch_teddy2003(tmp_path):
    mirror = tmp_path / "mirror" / "teddy"
    mirror.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for name in fetch._2003_FILES:
        color = name.endswith(".ppm")
        arr = rng.integers(0, 255, (8, 10, 3) if color else (8, 10),
                           dtype=np.uint8)
        (mirror / name).write_bytes(
            (b"P6" if color else b"P5") + b"\n10 8\n255\n" + arr.tobytes())
    dest = tmp_path / "dl"
    rc = fetch.main(["teddy2003", "--dest", str(dest),
                     "--base-url", (tmp_path / "mirror").as_uri()])
    assert rc == 0
    for name in fetch._2003_FILES:
        assert (dest / "teddy" / name).read_bytes() == \
            (mirror / name).read_bytes()
    assert data.load_image(dest / "teddy" / "im2.ppm", mode="L").shape == (8, 10)
    assert len(data.MiddleburyDataset(dest)) == 1
