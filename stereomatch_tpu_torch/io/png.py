"""PNG decoder and encoder with numpy and the standard library only.

The machine with the card has no PIL, so the port reads and writes PNG
itself.  What it covers:

* decoding non-interlaced PNGs of bit depth 8 in colour types 0 (gray),
  2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), and of bit depth
  16 in types 0 and 2, with any of the five row filters.  Adam7
  interlacing and the other bit depths raise ``ValueError`` naming what
  is missing;
* :func:`decode` returns what ``np.array(PIL.Image.open(path))`` returns:
  uint8 [H, W] (mode "L"), uint16 [H, W] for 16-bit gray ("I;16"),
  uint8 [H, W, 3] for RGB (a 16-bit sample keeps its high byte, as PIL
  loads it), palette indices [H, W] ("P"), [H, W, 2] ("LA"),
  [H, W, 4] ("RGBA");
* :func:`convert` gives what PIL's ``convert("L")`` and
  ``convert("RGB")`` give: luma by PIL's 16-bit fixed-point formula
  (``data.rgb_to_grayscale_u8``) from RGB, RGBA and the palette, the
  gray channel of LA, and a 16-bit gray value clipped to 255;
* encoding 8-bit gray, 8-bit RGB and 16-bit gray, one IDAT chunk, row
  filter 0, compressed with ``zlib``.  The bytes differ from PIL's; the
  decoded pixels do not.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ZLIB_LEVEL = 6  # zlib's own default: the encoder's one compression level

# (colour type, bit depth) -> (channels, PIL mode) that this codec reads.
_FORMATS = {(0, 8): (1, "L"), (0, 16): (1, "I;16"), (2, 8): (3, "RGB"),
            (2, 16): (3, "RGB"), (3, 8): (1, "P"), (4, 8): (2, "LA"),
            (6, 8): (4, "RGBA")}


class PngImage(NamedTuple):
    """A decoded PNG: ``array`` as ``np.array(Image.open(...))`` gives
    it, PIL's ``mode`` name, and the [256, 3] uint8 palette of a "P"
    image (None otherwise)."""
    array: np.ndarray
    mode: str
    palette: Optional[np.ndarray]


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + payload) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter_average(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        if i >= bpp:
            a, c = cur[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The [height, stride] uint8 scanlines of a filtered image stream.

    None, Sub and Up are vectorised over the row; Average and Paeth
    depend on the reconstructed byte to their left and loop over it."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.add.accumulate(line.reshape(-1, bpp), axis=0,
                                    dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_unfilter_average if kind == 3 else _unfilter_paeth)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes) -> PngImage:
    """Decode PNG bytes (see the module docstring for what is read)."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported (only "
                         "non-interlaced images)")
    if (ctype, depth) not in _FORMATS:
        raise ValueError(
            f"PNG colour type {ctype} at bit depth {depth} is not supported "
            f"(supported: bit depth 8 for colour types 0, 2, 3, 4, 6; bit "
            f"depth 16 for colour types 0 and 2)")
    channels, mode = _FORMATS[(ctype, depth)]
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG has no PLTE chunk")
    sample = depth // 8
    bpp = channels * sample
    lines = _unfilter(zlib.decompress(b"".join(idat)), height,
                      width * bpp, bpp)
    if sample == 2:
        lines = lines.view(">u2")
        # PIL loads 16-bit RGB as 8-bit RGB, keeping each high byte.
        lines = (lines >> 8).astype(np.uint8) if channels == 3 \
            else lines.astype(np.uint16)
    array = lines.reshape(height, width, channels)
    if channels == 1:
        array = array[:, :, 0]
    full = None
    if palette is not None and ctype == 3:
        # Entries past the PLTE chunk: PIL's default palette, a gray ramp.
        full = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        full[:len(palette)] = palette[:256]
    return PngImage(np.ascontiguousarray(array), mode, full)


def read(path) -> PngImage:
    """Decode the PNG file at ``path``."""
    return decode(Path(path).read_bytes())


def _luma(rgb: np.ndarray) -> np.ndarray:
    from .data import rgb_to_grayscale_u8
    return rgb_to_grayscale_u8(rgb)


def convert(image: PngImage, mode: str) -> np.ndarray:
    """The pixels of PIL's ``image.convert(mode)`` for mode "L" (uint8
    [H, W]) or "RGB" (uint8 [H, W, 3])."""
    if mode not in ("L", "RGB"):
        raise ValueError(f"convert to {mode!r}: only 'L' and 'RGB'")
    a = image.array
    if image.mode == "P":
        rgb = image.palette[a]
        return _luma(rgb) if mode == "L" else rgb
    if image.mode in ("RGB", "RGBA"):
        rgb = a[:, :, :3]
        return _luma(rgb) if mode == "L" else np.ascontiguousarray(rgb)
    if image.mode == "LA":
        gray = a[:, :, 0]
    elif image.mode == "I;16":
        gray = np.minimum(a, 255).astype(np.uint8)
    else:
        gray = a
    gray = np.ascontiguousarray(gray)
    return gray if mode == "L" else np.repeat(gray[:, :, None], 3, axis=2)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(array: np.ndarray) -> bytes:
    """PNG bytes of uint8 [H, W] (8-bit gray), uint8 [H, W, 3] (8-bit
    RGB) or uint16 [H, W] (16-bit gray): one IDAT chunk, filter 0."""
    a = np.asarray(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        ctype, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        ctype, depth = 2, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        ctype, depth = 0, 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"encode: uint8 [H, W], uint8 [H, W, 3] or uint16 "
                         f"[H, W], got {a.dtype} {a.shape}")
    height, width = a.shape[:2]
    if height == 0 or width == 0:
        raise ValueError("encode: an image needs at least one pixel")
    rows = np.ascontiguousarray(a).reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write(path, array: np.ndarray) -> Path:
    """Write ``array`` (see :func:`encode`) as a PNG file at ``path``."""
    path = Path(path)
    path.write_bytes(encode(array))
    return path
