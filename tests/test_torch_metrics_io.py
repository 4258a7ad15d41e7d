"""The port's metrics, reconstruction, rectification and dataset I/O
against the JAX package's, on the CPU.

``metrics`` sums in another order than XLA: held within 1e-6 relative,
with the same ``gt == 0`` (and non-finite) valid mask.  Depth and
reprojection are float32 maps held within 1e-6 relative; the PLY bytes
are held exactly.  The perspective warp inverts the homography and
multiplies it out in float32 through another library than XLA's, so a
sample position may move by a last-place rounding: held within 1e-5 on
[0, 1] images (bilinear sampling with the zero border is continuous)
and within 1 grey level on uint8 images.  The PFM and PNM readers,
calibration parser and datasets read the bytes the JAX module writes,
with no native library and no PIL for the PNM files.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu import metrics as jax_metrics
from stereomatch_tpu import reconstruction as jax_recon
from stereomatch_tpu.io import calibration as jax_calibration
from stereomatch_tpu.io import data as jax_data
from stereomatch_tpu_torch import metrics, reconstruction
from stereomatch_tpu_torch.io import calibration, data

from .torch_threads import one_torch_thread  # noqa: F401


def _maps(seed, shape=(37, 53), integer=False):
    rng = np.random.default_rng(seed)
    gt = (rng.random(shape) * 30).astype(np.float32)
    gt[rng.random(shape) < 0.15] = 0
    gt[0, :3] = np.inf
    pred = gt + rng.standard_normal(shape).astype(np.float32) * 2
    pred[np.isinf(pred)] = 7
    if integer:
        pred = np.round(pred).astype(np.int32)
    conf = rng.random(shape).astype(np.float32)
    return pred, gt, conf


@pytest.mark.parametrize("seed,integer", [(0, False), (1, True),
                                          (2, False)])
@pytest.mark.parametrize("threshold", [1.0, 2.0])
def test_metrics_equal_jax(seed, integer, threshold):
    pred, gt, conf = _maps(seed, integer=integer)
    for name in ("rmse", "avg_abs_error"):
        ref = float(getattr(jax_metrics, name)(pred, gt))
        out = getattr(metrics, name)(pred, gt)
        assert isinstance(out, torch.Tensor)
        assert float(out) == pytest.approx(ref, rel=1e-6)
    ref = jax_metrics.evaluate(pred, gt, threshold=threshold)
    out = metrics.evaluate(torch.from_numpy(pred), gt, threshold=threshold)
    assert out.keys() == ref.keys()
    for key in ref:
        assert out[key] == pytest.approx(ref[key], rel=1e-6)
    fr, curve, oracle = jax_metrics.sparsification_curve(
        pred, gt, conf, threshold=threshold, steps=10)
    out = metrics.sparsification_curve(torch.from_numpy(pred),
                                       torch.from_numpy(gt),
                                       torch.from_numpy(conf),
                                       threshold=threshold, steps=10)
    for a, b in zip((fr, curve, oracle), out):
        np.testing.assert_array_equal(b, a)
    assert metrics.sparsification_ause(pred, gt, conf, threshold=threshold) \
        == jax_metrics.sparsification_ause(pred, gt, conf,
                                           threshold=threshold)


def test_metrics_without_valid_pixels_and_the_table():
    pred, gt, conf = _maps(3)
    empty = np.zeros_like(gt)
    assert metrics.evaluate(pred, empty) == pytest.approx(
        jax_metrics.evaluate(pred, empty))
    _, flat, _ = metrics.sparsification_curve(pred, empty, conf)
    assert not flat.any()
    rows = [dict(name="a", rmse=1.5, avg_abs_error=0.25,
                 bad_pixel_ratio=0.125, ause=0.01),
            dict(name="b", rmse=2.0, avg_abs_error=1.0, bad_pixel_ratio=0.5)]
    assert metrics.metrics_markdown_table(rows) == \
        jax_metrics.metrics_markdown_table(rows)
    assert metrics.metrics_markdown_table(rows[1:]) == \
        jax_metrics.metrics_markdown_table(rows[1:])


CALIB = ("cam0=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]\n"
         "cam1=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]\n"
         "doffs=0\nbaseline=97.99\nwidth=1920\nheight=1080\nndisp=290\n")


@pytest.mark.parametrize("doffs", [0.0, 12.5, -3.0])
def test_depth_and_reprojection_equal_jax(tmp_path, doffs):
    path = tmp_path / "calib.txt"
    path.write_text(CALIB.replace("doffs=0", f"doffs={doffs}"))
    intr = reconstruction.CameraIntrinsics.from_middlebury_calib(path)
    ref_intr = jax_recon.CameraIntrinsics.from_middlebury_calib(path)
    assert repr(intr) == repr(ref_intr)
    pred, _, _ = _maps(4)
    pred[3, :5] = [0, -1, np.nan, np.inf, 3]
    rounded = np.round(np.nan_to_num(pred, posinf=0.0)).astype(np.int32)
    for disp in (pred, rounded):
        ref = np.asarray(jax_recon.depth_from_disparity(disp, ref_intr))
        out = reconstruction.depth_from_disparity(torch.from_numpy(disp),
                                                  intr).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
        ref = np.asarray(jax_recon.reproject_disparity(disp, ref_intr))
        out = reconstruction.reproject_disparity(disp, intr).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_calib_without_cam0_raises(tmp_path):
    path = tmp_path / "calib.txt"
    path.write_text("baseline=1\n")
    with pytest.raises(ValueError, match="cam0"):
        reconstruction.CameraIntrinsics.from_middlebury_calib(path)
    path.write_text("cam0=[1 0 2; 0 1 3]\n")
    with pytest.raises(ValueError, match="3x3"):
        reconstruction.CameraIntrinsics.from_middlebury_calib(path)


@pytest.mark.parametrize("colors", ["none", "gray", "rgb", "float"])
def test_write_ply_bytes_equal_jax(tmp_path, colors):
    intr = reconstruction.CameraIntrinsics(500.0, 26.0, 18.0, 0.1, 2.0)
    pred, _, _ = _maps(5)
    points = reconstruction.reproject_disparity(pred, intr)
    rng = np.random.default_rng(5)
    col = {"none": None,
           "gray": rng.integers(0, 256, pred.shape).astype(np.uint8),
           "rgb": rng.integers(0, 256, pred.shape + (3,)).astype(np.uint8),
           "float": rng.random(pred.shape).astype(np.float32)}[colors]
    mask = rng.random(pred.shape) < 0.9
    kw = dict(colors=col, mask=mask, max_depth=30.0)
    n = reconstruction.write_ply(tmp_path / "port.ply", points, **kw)
    n_ref = jax_recon.write_ply(tmp_path / "jax.ply", points.numpy(), **kw)
    assert n == n_ref > 0
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    pts, rgb = reconstruction.read_ply(tmp_path / "jax.ply")
    ref_pts, ref_rgb = jax_recon.read_ply(tmp_path / "jax.ply")
    np.testing.assert_array_equal(pts, ref_pts)
    assert (rgb is None) == (ref_rgb is None)
    if rgb is not None:
        np.testing.assert_array_equal(rgb, ref_rgb)


def test_write_ply_refuses_mismatched_colors(tmp_path):
    points = np.ones((4, 5, 3), np.float32)
    with pytest.raises(ValueError, match="colors shape"):
        reconstruction.write_ply(tmp_path / "x.ply", points,
                                 colors=np.zeros((4, 4), np.uint8))


HOMOGRAPHIES = {
    "shift": np.array([[1, 0, 1.25], [0, 1, -0.5], [0, 0, 1]], np.float32),
    "rotate": np.array([[0.99, -0.05, 1.0], [0.05, 0.99, -2.0], [0, 0, 1]],
                       np.float32),
    "perspective": np.array([[1.02, 0.01, -1.5], [0.0, 0.98, 0.75],
                             [1e-4, -2e-4, 1.0]], np.float32),
}


@pytest.mark.parametrize("name", HOMOGRAPHIES)
@pytest.mark.parametrize("inverse", [False, True])
def test_warp_perspective_equals_jax(name, inverse):
    rng = np.random.default_rng(7)
    hmat = HOMOGRAPHIES[name]
    for image, atol in ((rng.random((30, 44)).astype(np.float32), 1e-5),
                        (rng.random((30, 44, 3)).astype(np.float32), 1e-5),
                        ((rng.random((30, 44)) * 255).astype(np.uint8), 1)):
        ref = np.asarray(jax_calibration.warp_perspective(image, hmat,
                                                          inverse=inverse))
        out = calibration.warp_perspective(torch.from_numpy(image), hmat,
                                           inverse=inverse).numpy()
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_allclose(out.astype(np.float64), ref, rtol=0,
                                   atol=atol)


def test_stereo_rectifier_round_trip_and_state():
    h0, h1 = HOMOGRAPHIES["shift"], HOMOGRAPHIES["rotate"]
    rect = calibration.StereoRectifier(h0, h1)
    ref = jax_calibration.StereoRectifier(h0, h1)
    rng = np.random.default_rng(8)
    a, b = (rng.random((20, 30)).astype(np.float32) for _ in range(2))
    for out, want in zip(rect(a, b), ref(a, b)):
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        rect.invert(a, 1).numpy(), np.asarray(ref.invert(a, 1)), atol=1e-5)
    again = calibration.StereoRectifier.from_state_dict(rect.get_state_dict())
    np.testing.assert_array_equal(again.homography1, h1)
    with pytest.raises(ValueError):
        rect.invert(a, 2)


def test_pfm_round_trip_with_the_jax_module(tmp_path):
    rng = np.random.default_rng(9)
    for image in (rng.random((7, 11)).astype(np.float32),
                  rng.random((5, 6, 3)).astype(np.float32)):
        data.write_pfm(tmp_path / "port.pfm", image)
        jax_data.write_pfm(tmp_path / "jax.pfm", image)
        assert (tmp_path / "port.pfm").read_bytes() == \
            (tmp_path / "jax.pfm").read_bytes()
        np.testing.assert_array_equal(data.read_pfm(tmp_path / "jax.pfm"),
                                      image)
    # Big-endian files (positive scale) and comment lines.
    big = rng.random((3, 4)).astype(np.float32)
    (tmp_path / "be.pfm").write_bytes(
        b"Pf\n# made by hand\n4 3\n1.0\n" + big[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(data.read_pfm(tmp_path / "be.pfm"), big)
    with pytest.raises(ValueError, match="PFM"):
        (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n255\n\0\0\0")
        data.read_pfm(tmp_path / "bad.pfm")


def _write_pnm(path, image):
    magic = b"P6" if image.ndim == 3 else b"P5"
    h, w = image.shape[:2]
    path.write_bytes(magic + b"\n# comment\n" + f"{w} {h}\n255\n".encode()
                     + image.tobytes())


def test_pnm_reader_and_grayscale_match_pil(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    _write_pnm(tmp_path / "c.ppm", rgb)
    _write_pnm(tmp_path / "g.pgm", gray)
    np.testing.assert_array_equal(data.load_image(tmp_path / "c.ppm"), rgb)
    np.testing.assert_array_equal(data.load_image(tmp_path / "g.pgm"), gray)
    np.testing.assert_array_equal(
        data.load_image(tmp_path / "c.ppm", mode="L"),
        np.array(Image.open(tmp_path / "c.ppm").convert("L")))
    np.testing.assert_array_equal(data.rgb_to_grayscale_u8(rgb),
                                  jax_data.rgb_to_grayscale_u8(rgb))
    (tmp_path / "wide.pgm").write_bytes(b"P5\n1 1\n65535\n\0\0")
    with pytest.raises(ValueError, match="16-bit"):
        data.read_pnm(tmp_path / "wide.pgm")


def test_middlebury_datasets_both_layouts(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(11)
    # 2003 layout: PPM/PGM only (what the card's machine can read).
    teddy = tmp_path / "sets" / "teddy"
    teddy.mkdir(parents=True)
    left = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    gt4 = (rng.integers(0, 40, (12, 16)) * 4).astype(np.uint8)
    _write_pnm(teddy / "im2.ppm", left)
    _write_pnm(teddy / "im6.ppm", left[:, ::-1].copy())
    _write_pnm(teddy / "disp2.pgm", gt4)
    _write_pnm(teddy / "disp6.pgm", gt4)
    # 2014 layout: PNG images (PIL), PFM ground truth, calib.txt.
    scene = tmp_path / "sets" / "scene10"
    scene.mkdir()
    Image.fromarray(left).save(scene / "im0.png")
    Image.fromarray(left).save(scene / "im1.png")
    gt = rng.random((12, 16)).astype(np.float32) * 9
    data.write_pfm(scene / "disp0.pfm", gt)
    data.write_pfm(scene / "disp1.pfm", gt)
    (scene / "calib.txt").write_text("width=16\nheight=12\nndisp=70\n")
    ds = data.MiddleburyDataset(tmp_path / "sets")
    assert len(ds) == 2
    items = [ds[i] for i in range(len(ds))]
    assert [i["stereo_name"] for i in items] == ["scene10", "teddy"]
    by_name = {i["stereo_name"]: i for i in items}
    np.testing.assert_array_equal(by_name["teddy"]["left"], left)
    np.testing.assert_array_equal(by_name["teddy"]["gt_disparity"],
                                  gt4.astype(np.float32) / 4)
    assert by_name["teddy"]["max_disparity"] == 64
    np.testing.assert_array_equal(by_name["scene10"]["gt_disparity"], gt)
    assert by_name["scene10"]["max_disparity"] == 70
    assert data.parse_middlebury_calib(scene / "calib.txt") == \
        jax_data.parse_middlebury_calib(scene / "calib.txt")
    assert len(data.MiddleburyDataset(tmp_path / "sets", max_size=1)) == 1
    with pytest.raises(RuntimeError, match="directory"):
        data.MiddleburyDataset(tmp_path / "missing")


def test_kitti_dataset(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(12)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (tmp_path / sub).mkdir()
    img = rng.integers(0, 256, (10, 14, 3)).astype(np.uint8)
    disp = rng.integers(0, 256 * 40, (10, 14)).astype(np.uint16)
    for name in ("000000_10.png", "000001_10.png"):
        Image.fromarray(img).save(tmp_path / "image_2" / name)
        Image.fromarray(img).save(tmp_path / "image_3" / name)
        Image.fromarray(disp).save(tmp_path / "disp_occ_0" / name)
    ds = data.KittiDataset(tmp_path, max_size=1)
    ref = jax_data.KittiDataset(tmp_path, max_size=1)
    assert len(ds) == len(ref) == 1
    item, want = ds[0], ref[0]
    assert item["stereo_name"] == want["stereo_name"] == "000000_10"
    np.testing.assert_array_equal(item["gt_disparity"], want["gt_disparity"])
    np.testing.assert_array_equal(item["left"], want["left"])
    assert item["max_disparity"] == 192
