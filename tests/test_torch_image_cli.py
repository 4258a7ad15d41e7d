"""The port's ``stm-image`` (``python -m stereomatch_tpu_torch.cli.image``)
against the JAX package's, offline, on the CPU.

The cases of ``tests/test_image_cli.py`` run on the port with
``--device cpu``, on synthetic PNGs; for every cost method and the
post-processing flags, the port's output PNGs decode to the same pixels
as the JAX CLI's on the same inputs and flags (``--backend xla`` there,
``torch`` here), exactly.  ``--pyramid`` (ROADMAP A.12) and
``-am cvf --cvf-subsample 2`` (A.9) exit with status 2, naming their
items.  An output other than PNG is written through PIL, as the JAX CLI
writes it, and refused with status 2 where PIL is missing.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from stereomatch_tpu.cli import image as jax_image
from stereomatch_tpu_torch.cli import image
from stereomatch_tpu_torch.io import png

from .conftest import synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("imgcli")
    left, right, _ = synthetic_stereo_pair(24, 40, 8, seed=11)
    lp, rp = tmp / "left.png", tmp / "right.png"
    png.write(lp, (left * 255).astype(np.uint8))
    png.write(rp, (right * 255).astype(np.uint8))
    return str(lp), str(rp), (24, 40)


def _port(args):
    return image.main(args + ["--device", "cpu"])


def test_image_cli_depthmap_only(png_pair, tmp_path):
    lp, rp, (h, w) = png_pair
    out = tmp_path / "depth.png"
    assert _port([lp, rp, "8", str(out)]) == 0
    assert png.read(out).array.shape == (h, w, 3)


def test_image_cli_figure_mode(png_pair, tmp_path):
    lp, rp, (h, w) = png_pair
    out = tmp_path / "fig.png"
    assert _port([lp, rp, "8", str(out), "-fig", "-am", "sgm", "--p1", "0.2",
                  "--p2", "0.5", "--backend", "torch", "-dm", "dyn"]) == 0
    img = png.read(out).array
    assert img.shape[0] == h
    assert img.shape[1] == 3 * w + 2 * 8


def test_image_cli_confidence_output(png_pair, tmp_path):
    lp, rp, (h, w) = png_pair
    out, conf_out = tmp_path / "d.png", tmp_path / "conf.png"
    assert _port([lp, rp, "8", str(out), "-am", "sgm",
                  "--confidence", str(conf_out)]) == 0
    conf = png.read(conf_out).array
    assert conf.shape == (h, w) and conf.dtype == np.uint8


def test_render_panels_equals_jax():
    disp = np.arange(12, dtype=np.int32).reshape(3, 4)
    canvas = image.render_panels(disp)
    assert canvas.shape == (3, 4, 3) and canvas.dtype == np.uint8
    np.testing.assert_array_equal(canvas, jax_image.render_panels(disp))
    rgb = np.random.default_rng(1).integers(0, 256, (5, 4, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        image.render_panels(disp, inputs=(rgb, rgb)),
        jax_image.render_panels(disp, inputs=(Image.fromarray(rgb),
                                              Image.fromarray(rgb))))


def test_image_cli_speckle(png_pair, tmp_path):
    lp, rp, (h, w) = png_pair
    out = tmp_path / "speckle.png"
    assert _port([lp, rp, "8", str(out), "--speckle", "--speckle-fill",
                  "background", "--backend", "torch"]) == 0
    assert png.read(out).array.shape == (h, w, 3)


@pytest.mark.parametrize("flags", [
    ["-cm", "ssd"],
    ["-cm", "sad", "-am", "sgm"],
    ["-cm", "census", "-am", "cvf", "--cvf-radius", "3", "-dm", "dyn"],
    ["-cm", "birchfield", "-am", "sgm", "-dm", "dyn", "-fig"],
    ["-cm", "ncc", "-am", "sgm", "--refine", "--confidence", "CONF"],
    ["-cm", "ssd-texture", "-am", "sgm", "--speckle"],
    ["-cm", "ncc", "-am", "cvf", "--cvf-radius", "3", "--lr-check",
     "--lr-mode", "volume", "--min-confidence", "0.1"],
    ["-cm", "birchfield", "-am", "sgm", "--wmf", "--wmf-sigma", "20",
     "--fgs", "8", "--fgs-sigma", "20"]],
    ids=["ssd", "sad-sgm", "census-cvf-dyn", "birchfield-sgm-dyn-fig",
         "ncc-sgm-refine-conf", "ssd-texture-sgm-speckle",
         "ncc-cvf-lr-gate", "birchfield-wmf-fgs"])
def test_outputs_decode_to_the_jax_clis_pixels(png_pair, tmp_path, flags):
    lp, rp, _ = png_pair
    outs = {}
    for name, main, backend in (("jax", jax_image.main, "xla"),
                                ("port", _port, "torch")):
        run = [str(tmp_path / f"{name}_conf.png") if f == "CONF" else f
               for f in flags]
        out = tmp_path / f"{name}.png"
        assert main([lp, rp, "8", str(out), "--backend", backend]
                    + run) == 0
        outs[name] = out
    np.testing.assert_array_equal(png.read(outs["port"]).array,
                                  np.array(Image.open(outs["jax"])))
    if "CONF" in flags:
        np.testing.assert_array_equal(
            png.read(tmp_path / "port_conf.png").array,
            np.array(Image.open(tmp_path / "jax_conf.png")))


def test_depth_and_point_cloud_equal_jax(png_pair, tmp_path):
    from stereomatch_tpu.io.data import read_pfm
    from stereomatch_tpu_torch.reconstruction import read_ply
    lp, rp, _ = png_pair
    calib = tmp_path / "calib.txt"
    calib.write_text("cam0=[100 0 20; 0 100 12; 0 0 1]\n"
                     "cam1=[100 0 22; 0 100 12; 0 0 1]\ndoffs=2\n"
                     "baseline=50\nwidth=40\nheight=24\nndisp=8\n")
    for name, main, backend in (("jax", jax_image.main, "xla"),
                                ("port", _port, "torch")):
        assert main([lp, rp, "8", str(tmp_path / f"{name}.png"),
                     "--backend", backend, "-am", "sgm", "--calib",
                     str(calib), "--depth", str(tmp_path / f"{name}.pfm"),
                     "--point-cloud", str(tmp_path / f"{name}.ply")]) == 0
    np.testing.assert_array_equal(read_pfm(tmp_path / "port.pfm"),
                                  read_pfm(tmp_path / "jax.pfm"))
    for a, b in zip(read_ply(tmp_path / "port.ply"),
                    read_ply(tmp_path / "jax.ply")):
        np.testing.assert_array_equal(a, b)
    assert _port([lp, rp, "8", str(tmp_path / "x.png"), "--depth",
                  str(tmp_path / "x.pfm")]) == 2


@pytest.mark.parametrize("flags,item", [
    (["--pyramid", "1", "--band-radius", "3"], "A.12"),
    (["-am", "cvf", "--cvf-subsample", "2", "--cvf-radius", "4"], None)],
    ids=["pyramid", "cvf-subsample"])
def test_unported_flags_exit_2_naming_their_item(png_pair, tmp_path, flags,
                                                 item, capsys):
    """``--pyramid`` (A.12) exits 2 naming its item; the fast guided
    filter (A.9), refused until it was ported, writes the JAX CLI's PNG
    pixel for pixel."""
    lp, rp, _ = png_pair
    if item is None:
        for name, main, backend in (("jax", jax_image.main, "xla"),
                                    ("port", _port, "torch")):
            assert main([lp, rp, "8", str(tmp_path / f"{name}.png"),
                         "--backend", backend] + flags) == 0
        np.testing.assert_array_equal(
            np.array(Image.open(tmp_path / "port.png")),
            np.array(Image.open(tmp_path / "jax.png")))
        return
    out = tmp_path / "refused.png"
    assert _port([lp, rp, "8", str(out)] + flags) == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err
    assert not out.exists()


def test_non_png_output_goes_through_pil(png_pair, tmp_path, monkeypatch,
                                         capsys):
    lp, rp, _ = png_pair
    for name, main, backend in (("jax", jax_image.main, "xla"),
                                ("port", _port, "torch")):
        assert main([lp, rp, "8", str(tmp_path / f"{name}.bmp"),
                     "--backend", backend]) == 0
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "port.bmp")),
                                  np.array(Image.open(tmp_path / "jax.bmp")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert _port([lp, rp, "8", str(tmp_path / "d.jpg")]) == 2
    assert "PIL" in capsys.readouterr().err
    assert not (tmp_path / "d.jpg").exists()


def test_module_runs_as_a_script(png_pair, tmp_path):
    lp, rp, (h, w) = png_pair
    out = tmp_path / "script.png"
    run = subprocess.run(
        [sys.executable, "-m", "stereomatch_tpu_torch.cli.image", lp, rp,
         "8", str(out), "-cm", "birchfield", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert png.read(out).array.shape == (h, w, 3)
