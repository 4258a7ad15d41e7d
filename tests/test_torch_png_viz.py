"""The port's PNG codec (``io/png.py``) and colormap (``utils/viz.py``)
against PIL and matplotlib, which the port itself never imports.

The decoder must give PIL's pixels for every mode it reads
(``np.array(Image.open(p))`` and ``convert("L")`` / ``convert("RGB")``),
for PNGs that PIL wrote and for PNGs written here with each row filter
chosen by hand; PIL must read the encoder's output back to the source
array.  ``load_image`` reads PNG with PIL hidden (the card's machine has
none) and other formats through PIL, and the colormap equals
matplotlib's "rainbow" bit for bit.  All comparisons are exact.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from stereomatch_tpu.utils import viz as jax_viz
from stereomatch_tpu_torch.io import data, png
from stereomatch_tpu_torch.utils import viz

RNG = np.random.default_rng(2026)


def _pil_images():
    """name -> PIL image of each mode the decoder reads."""
    gray = RNG.integers(0, 256, (13, 17)).astype(np.uint8)
    rgb = RNG.integers(0, 256, (13, 17, 3)).astype(np.uint8)
    rgba = RNG.integers(0, 256, (13, 17, 4)).astype(np.uint8)
    la = RNG.integers(0, 256, (13, 17, 2)).astype(np.uint8)
    g16 = RNG.integers(0, 65536, (13, 17)).astype(np.uint16)
    g16[0, :5] = [0, 1, 254, 255, 256]
    # 20 palette entries: PIL writes 8-bit indices above 16 colours.
    pal = Image.fromarray(RNG.integers(0, 20, (13, 17)).astype(np.uint8),
                          mode="P")
    pal.putpalette(list(RNG.integers(0, 256, 60)))
    # A smooth image, so that PIL's encoder picks several row filters.
    yy, xx = np.mgrid[0:40, 0:50]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    return {"L": Image.fromarray(gray), "RGB": Image.fromarray(rgb),
            "RGBA": Image.fromarray(rgba), "LA": Image.fromarray(la, "LA"),
            "I;16": Image.fromarray(g16), "P": pal,
            "L smooth": Image.fromarray(smooth),
            "RGB smooth": Image.fromarray(np.stack([smooth, smooth[::-1],
                                                    smooth], axis=2))}


PIL_IMAGES = _pil_images()


@pytest.mark.parametrize("name", list(PIL_IMAGES))
def test_decoder_equals_pil_on_pil_written_png(name, tmp_path):
    path = tmp_path / "x.png"
    PIL_IMAGES[name].save(path)
    pil = Image.open(path)
    image = png.read(path)
    assert image.mode == pil.mode
    want = np.array(pil)
    assert image.array.dtype == want.dtype
    np.testing.assert_array_equal(image.array, want)
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(png.convert(image, mode),
                                      np.array(pil.convert(mode)))


def _filter_row(line: np.ndarray, prev: np.ndarray, kind: int, bpp: int):
    """PNG filter ``kind`` applied to one scanline (uint8)."""
    x = line.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def _handmade_png(samples: np.ndarray, ctype: int, depth: int, filters):
    """PNG bytes of ``samples`` ([H, W, C], big-endian 16-bit for depth
    16) with row y filtered by filters[y % len(filters)]."""
    height, width = samples.shape[:2]
    raw = samples.astype(">u2" if depth == 16 else np.uint8)
    lines = np.ascontiguousarray(raw).reshape(height, -1).view(np.uint8)
    bpp = samples.shape[2] * depth // 8
    prev = np.zeros(lines.shape[1], np.uint8)
    body = b""
    for y in range(height):
        kind = filters[y % len(filters)]
        body += bytes([kind]) + _filter_row(lines[y], prev, kind,
                                            bpp).tobytes()
        prev = lines[y]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("ctype,depth,channels", [
    (0, 8, 1), (2, 8, 3), (4, 8, 2), (6, 8, 4), (0, 16, 1), (2, 16, 3)],
    ids=["L8", "RGB8", "LA8", "RGBA8", "L16", "RGB16"])
def test_each_row_filter_decodes_to_pils_pixels(filters, ctype, depth,
                                                channels, tmp_path):
    top = 65536 if depth == 16 else 256
    samples = RNG.integers(0, top, (9, 11, channels))
    path = tmp_path / "f.png"
    path.write_bytes(_handmade_png(samples, ctype, depth, filters))
    pil = Image.open(path)
    image = png.read(path)
    np.testing.assert_array_equal(image.array, np.array(pil))
    assert image.array.dtype == np.array(pil).dtype
    np.testing.assert_array_equal(png.convert(image, "L"),
                                  np.array(pil.convert("L")))


@pytest.mark.parametrize("array", [
    RNG.integers(0, 256, (31, 45)).astype(np.uint8),
    RNG.integers(0, 256, (31, 45, 3)).astype(np.uint8),
    RNG.integers(0, 65536, (31, 45)).astype(np.uint16),
    np.zeros((1, 1), np.uint8)], ids=["L8", "RGB8", "L16", "1x1"])
def test_pil_reads_the_encoders_output(array, tmp_path):
    path = png.write(tmp_path / "e.png", array)
    np.testing.assert_array_equal(np.array(Image.open(path)), array)
    np.testing.assert_array_equal(png.read(path).array, array)


def test_unsupported_pngs_raise_naming_what_is_missing(tmp_path):
    samples = RNG.integers(0, 2, (4, 8, 1))
    bits = _handmade_png(samples, 0, 8, (0,))
    ihdr = struct.pack(">IIBBBBB", 8, 4, 1, 0, 0, 0, 0)
    one_bit = bits[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr + \
        struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + bits[33:]
    with pytest.raises(ValueError, match="bit depth 1"):
        png.decode(one_bit)
    ihdr = struct.pack(">IIBBBBB", 8, 4, 8, 0, 0, 0, 1)
    interlaced = bits[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr + \
        struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + bits[33:]
    with pytest.raises(ValueError, match="Adam7"):
        png.decode(interlaced)
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bits[:40] + bytes([bits[40] ^ 1]) + bits[41:])
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + bits[6:])
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 4), np.uint8))


def _hide_pil(monkeypatch):
    """Make PIL unimportable for the rest of the test, as on the card's
    machine."""
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401


@pytest.mark.parametrize("name", ["L", "RGB", "RGBA", "P", "I;16"])
def test_load_image_reads_png_without_pil(name, tmp_path, monkeypatch):
    """Fault C.3: the port's load_image raised without PIL on any PNG."""
    path = tmp_path / "p.png"
    PIL_IMAGES[name].save(path)
    want = np.array(Image.open(path))
    want_gray = np.array(Image.open(path).convert("L"))
    _hide_pil(monkeypatch)
    np.testing.assert_array_equal(data.load_image(path), want)
    np.testing.assert_array_equal(data.load_image(path, "L"), want_gray)


def test_load_image_equals_pil_in_every_mode(tmp_path):
    for name in ("L", "RGB", "RGBA", "P", "LA", "I;16"):
        path = tmp_path / f"{name.replace(';', '')}.png"
        PIL_IMAGES[name].save(path)
        np.testing.assert_array_equal(data.load_image(path),
                                      np.array(Image.open(path)))
        for mode in ("L", "RGB"):
            np.testing.assert_array_equal(
                data.load_image(path, mode),
                np.array(Image.open(path).convert(mode)))
    with pytest.raises(ValueError, match="mode"):
        data.load_image(path, "RGBA")


@pytest.mark.parametrize("suffix", [".ppm", ".pgm", ".bmp", ".tiff"])
def test_load_and_save_image_in_other_formats(suffix, tmp_path):
    """PGM/PPM through the port's reader, other formats through PIL, in
    each mode; saving a suffix other than .png goes through PIL too."""
    src = PIL_IMAGES["L" if suffix == ".pgm" else "RGB"]
    path = tmp_path / f"x{suffix}"
    src.save(path)
    for mode in (None, "L", "RGB"):
        want = Image.open(path)
        np.testing.assert_array_equal(
            data.load_image(path, mode),
            np.array(want if mode is None else want.convert(mode)))
    out = tmp_path / f"y{suffix}"
    data.save_image(out, np.array(src))
    np.testing.assert_array_equal(np.array(Image.open(out)), np.array(src))


def test_other_formats_need_pil(tmp_path, monkeypatch):
    rgb = np.array(PIL_IMAGES["RGB"])
    PIL_IMAGES["RGB"].save(tmp_path / "x.bmp")
    _hide_pil(monkeypatch)
    with pytest.raises(RuntimeError, match="PIL"):
        data.load_image(tmp_path / "x.bmp")
    with pytest.raises(RuntimeError, match="PIL"):
        data.save_image(tmp_path / "y.bmp", rgb)
    data.save_image(tmp_path / "y.png", rgb)
    np.testing.assert_array_equal(data.load_image(tmp_path / "y.png"), rgb)


def test_kitti_reads_uint16_disparities_without_pil(tmp_path, monkeypatch):
    _hide_pil(monkeypatch)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (tmp_path / sub).mkdir()
    img = RNG.integers(0, 256, (10, 14, 3)).astype(np.uint8)
    disp = RNG.integers(0, 256 * 40, (10, 14)).astype(np.uint16)
    png.write(tmp_path / "image_2" / "000000_10.png", img)
    png.write(tmp_path / "image_3" / "000000_10.png", img)
    png.write(tmp_path / "disp_occ_0" / "000000_10.png", disp)
    item = data.KittiDataset(tmp_path)[0]
    np.testing.assert_array_equal(item["gt_disparity"],
                                  disp.astype(np.float32) / 256.0)
    np.testing.assert_array_equal(item["left"], img)


@pytest.mark.parametrize("disparity,max_disparity", [
    (np.arange(256, dtype=np.float32)[None] / 255.0, None),
    (np.concatenate([np.arange(256) / 255.0,
                     np.linspace(0, 1, 4099)]).astype(np.float32)[None] * 97,
     None),
    (np.array([[0.0, 1.0, 0.5, 1.0]], np.float32), 1),
    (np.full((3, 4), 5.0, np.float32), None),
    (np.arange(12, dtype=np.int32).reshape(3, 4), 8),
    (np.array([[0.0, np.nan, 2.0]], np.float32), 2)],
    ids=["lut-ramp", "fine-ramp", "0-and-1", "constant", "int-clipped",
         "nan"])
def test_colorize_equals_matplotlib(disparity, max_disparity):
    want = jax_viz.colorize_disparity(disparity, max_disparity)
    got = viz.colorize_disparity(disparity, max_disparity)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_save_depthmap_and_lut_entries(tmp_path):
    import matplotlib
    cmap = matplotlib.colormaps["rainbow"]
    cmap._init()
    np.testing.assert_array_equal(viz._rainbow_lut(), cmap._lut[:256, :3])
    disp = RNG.random((6, 9)).astype(np.float32) * 20
    path = viz.save_depthmap(disp, tmp_path / "d" / "depth.jpg", 20)
    assert path.suffix == ".png"
    np.testing.assert_array_equal(np.array(Image.open(path)),
                                  jax_viz.colorize_disparity(disp, 20))
    with pytest.raises(ValueError, match="colormap"):
        viz.colorize_disparity(disp, cmap="viridis")
