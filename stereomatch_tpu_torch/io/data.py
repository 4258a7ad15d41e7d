"""Dataset loaders (Middlebury and KITTI layouts) and PFM/PNM parsing, a
numpy-only copy of ``stereomatch_tpu/io/data.py`` for the port, which
imports nothing of the JAX package.

The JAX module reads PFM and PGM/PPM through the native codec
(``native/libstmio.so``) when it is built, and PNG through PIL; the port
takes pure-Python paths for all three, so it reads the same files on a
machine without PIL or the native library: the PFM parser, a binary PNM
reader and the PNG codec of ``io/png.py``.  Each gives the values of the
JAX module's reader.  Other image formats still need PIL.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import png


def read_pfm(path) -> np.ndarray:
    """Parse a PFM file (the Middlebury disparity format).

    Returns float32 [H, W] (grayscale) or [H, W, 3] (color), with the
    bottom-up scanline order of the format undone.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1").strip()
        while dims.startswith("#"):
            dims = f.readline().decode("latin-1").strip()
        width, height = map(int, dims.split())
        scale = float(f.readline().decode("latin-1").strip())
        big_endian = scale > 0
        data = np.frombuffer(f.read(width * height * channels * 4),
                             dtype=">f4" if big_endian else "<f4")
    img = data.reshape(height, width, channels).astype(np.float32)
    img = img[::-1]  # PFM stores rows bottom-to-top
    return img[:, :, 0] if channels == 1 else img


def write_pfm(path_or_file, image: np.ndarray) -> None:
    """Write a float32 image as (little-endian) PFM.

    ``path_or_file``: a filesystem path, or any binary file-like object
    with ``write`` (e.g. ``io.BytesIO`` — stm-serve encodes responses
    in memory).
    """
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        header, channels = b"Pf", 1
    elif image.ndim == 3 and image.shape[2] == 3:
        header, channels = b"PF", 3
    else:
        raise ValueError(f"write_pfm: bad shape {image.shape}")

    def emit(f):
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little-endian
        f.write(np.ascontiguousarray(image[::-1]).tobytes())

    if hasattr(path_or_file, "write"):
        emit(path_or_file)
        return
    with open(path_or_file, "wb") as f:
        emit(f)


def _natural_key(path: Path):
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", path.name)]


def parse_middlebury_calib(filepath) -> Dict[str, int]:
    """Parse calib.txt key=value lines (reference: data.py:14-23)."""
    props = {}
    with open(filepath, "r", encoding="ascii") as f:
        for line in f:
            if "=" not in line:
                continue
            name, value = line.split("=", 1)
            props[name.strip()] = value.strip()
    return dict(width=int(props["width"]), height=int(props["height"]),
                ndisp=int(props["ndisp"]))


def rgb_to_grayscale_u8(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma with PIL's exact integer arithmetic.

    The PNM path converts color through this function, so a PPM yields
    the gray values that PIL's ``convert("L")`` gives.  Matches
    ``Image.convert("L")`` bit-for-bit: PIL's Convert.c uses 16-bit
    fixed-point luma with round-half-up, (R*19595 + G*38470 + B*7471 +
    0x8000) >> 16 — not the /1000 formula its docs quote.
    """
    rgb = img.astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


def _pnm_token(f) -> bytes:
    """The next whitespace-separated header token, skipping comments."""
    token = b""
    while True:
        ch = f.read(1)
        if not ch:
            return token
        if ch == b"#" and not token:
            f.readline()
        elif ch.isspace():
            if token:
                return token
        else:
            token += ch


def read_pnm(path) -> np.ndarray:
    """Read a binary 8-bit PGM (P5) or PPM (P6): uint8 [H, W] or [H, W, 3],
    as the native codec reads them (it refuses 16-bit files too)."""
    with open(path, "rb") as f:
        magic = _pnm_token(f)
        if magic not in (b"P5", b"P6"):
            raise ValueError(f"{path}: not a binary PGM/PPM "
                             f"(magic {magic!r})")
        width, height, maxval = (int(_pnm_token(f)) for _ in range(3))
        if maxval > 255:
            raise ValueError(f"{path}: 16-bit PNM not supported")
        channels = 3 if magic == b"P6" else 1
        count = width * height * channels
        data = np.frombuffer(f.read(count), dtype=np.uint8, count=count)
    img = data.reshape(height, width, channels)
    return img[:, :, 0] if channels == 1 else img


_PNM_SUFFIXES = (".pgm", ".ppm", ".pnm")


def _pil_image(path):
    """PIL's ``Image`` module for a format that the port does not read or
    write itself, or a RuntimeError naming what is missing."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: {Path(path).suffix or 'this'} images need PIL, which "
            f"is not installed (PNG, PGM and PPM do not)") from None
    return Image


def load_image(path, mode: Optional[str] = None) -> np.ndarray:
    """Load an image as ``np.array(PIL.Image.open(path))`` gives it, or,
    with ``mode`` "L" or "RGB", as PIL's ``convert(mode)`` does.

    PNG goes through the port's codec (``io/png.py``) and PGM/PPM
    through :func:`read_pnm`, with or without PIL; other formats (JPEG,
    BMP, TIFF) through PIL, where it is installed.  The Middlebury 2003
    sets (teddy/cones) ship PGM/PPM, the 2014/2021 sets and KITTI PNG.
    """
    if mode not in (None, "L", "RGB"):
        raise ValueError(f"load_image: mode None, 'L' or 'RGB', got {mode!r}")
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        image = png.read(path)
        return image.array if mode is None else png.convert(image, mode)
    if suffix not in _PNM_SUFFIXES:
        with _pil_image(path).open(path) as img:
            return np.array(img if mode is None else img.convert(mode))
    img = read_pnm(path)
    if mode == "L" and img.ndim == 3:
        return rgb_to_grayscale_u8(img)
    if mode == "RGB" and img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return img


def save_image(path, array: np.ndarray) -> None:
    """Write a uint8 gray or RGB image: PNG through the port's codec, any
    other suffix through PIL, which picks the format from it."""
    if Path(path).suffix.lower() == ".png":
        png.write(path, array)
    else:
        _pil_image(path).fromarray(array).save(path)


class MiddleburyDataset:
    """Folder-per-scene Middlebury dataset parser
    (reference: stereomatch/data.py:26-93).

    Two scene layouts are recognized per directory:

    * 2014/2021: im0.png / im1.png, disp0.pfm / disp1.pfm, calib.txt
      (ndisp read from the calibration);
    * 2003 quarter-size (teddy/cones — the reference's unit-test
      fixtures, tests/conftest.py:15-31, fetched by ``stm-fetch
      teddy2003``): im2.ppm / im6.ppm with disp2.pgm ground truth.  The
      PGM stores disparity * 4 with 0 = unknown (both conventions are
      undone/kept on load); ndisp is the sets' published 64.

    Items are dicts with stereo_name / left / right / max_disparity
    (+ gt_disparity when ground truth is requested).
    """

    _NDISP_2003 = 64

    def __init__(self, dataset_dir, max_size: Optional[int] = None):
        dataset_dir = Path(dataset_dir)
        if not dataset_dir.is_dir():
            raise RuntimeError(
                f"MiddleburyDataset: {dataset_dir} must be a directory")

        self.images: List[Tuple[Path, Path]] = []
        self.disps: List[Tuple[Path, Path]] = []
        self.calibs: List[Dict[str, int]] = []

        sample_dirs = sorted(dataset_dir.iterdir(), key=_natural_key)
        if max_size is not None:
            sample_dirs = sample_dirs[:max_size]
        for sample_dir in sample_dirs:
            if not sample_dir.is_dir():
                continue
            if (sample_dir / "im2.ppm").exists():       # 2003 layout
                self.images.append((sample_dir / "im2.ppm",
                                    sample_dir / "im6.ppm"))
                self.disps.append((sample_dir / "disp2.pgm",
                                   sample_dir / "disp6.pgm"))
                self.calibs.append({"ndisp": self._NDISP_2003})
                continue
            self.images.append((sample_dir / "im0.png",
                                sample_dir / "im1.png"))
            self.disps.append((sample_dir / "disp0.pfm",
                               sample_dir / "disp1.pfm"))
            self.calibs.append(
                parse_middlebury_calib(sample_dir / "calib.txt"))

    def get_stereo_pair(self, idx: int) -> Dict:
        left_path, right_path = self.images[idx]
        return dict(
            stereo_name=left_path.parent.name,
            left=load_image(left_path),
            right=load_image(right_path),
            max_disparity=self.calibs[idx]["ndisp"])

    def get_ground_truth(self, idx: int) -> Dict:
        disp_path = self.disps[idx][0]
        if disp_path.suffix == ".pgm":                  # 2003 layout
            gt = load_image(disp_path).astype("float32") / 4.0
        else:
            gt = read_pfm(disp_path)
        return dict(
            stereo_name=disp_path.parent.name,
            gt_disparity=gt,
            max_disparity=self.calibs[idx]["ndisp"])

    def __getitem__(self, idx: int) -> Dict:
        item = self.get_stereo_pair(idx)
        item.update(self.get_ground_truth(idx))
        return item

    def __len__(self) -> int:
        return len(self.images)


class KittiDataset:
    """KITTI 2015 stereo-layout parser (flat-directory counterpart of
    :class:`MiddleburyDataset` — beyond the reference's dataset surface,
    which is Middlebury-only, stereomatch/data.py:26-93).

    Layout: ``image_2/<frame>.png`` (left), ``image_3/<frame>.png``
    (right), and optionally ``disp_occ_0/<frame>.png`` ground truth —
    uint16 PNGs storing ``disparity * 256``, with 0 marking pixels
    without ground truth (the same "0 = unknown" convention the metrics
    layer masks, metrics.py::_valid_mask).

    KITTI publishes no per-scene disparity range; ``max_disparity``
    defaults to the benchmark's conventional 192.
    """

    def __init__(self, dataset_dir, max_size: Optional[int] = None,
                 max_disparity: int = 192, disp_dir: str = "disp_occ_0"):
        dataset_dir = Path(dataset_dir)
        left_dir = dataset_dir / "image_2"
        right_dir = dataset_dir / "image_3"
        if not left_dir.is_dir() or not right_dir.is_dir():
            raise RuntimeError(
                f"KittiDataset: {dataset_dir} must contain image_2/ and "
                f"image_3/ (the KITTI stereo layout)")
        self.max_disparity = max_disparity
        self._disp_dir = dataset_dir / disp_dir

        frames = sorted(p.name for p in left_dir.glob("*.png"))
        if max_size is not None:
            frames = frames[:max_size]
        self.images: List[Tuple[Path, Path]] = []
        for name in frames:
            right = right_dir / name
            if not right.exists():
                raise RuntimeError(f"KittiDataset: image_3/{name} missing "
                                   f"for image_2/{name}")
            self.images.append((left_dir / name, right))

    def get_stereo_pair(self, idx: int) -> Dict:
        left_path, right_path = self.images[idx]
        return dict(
            stereo_name=left_path.stem,
            left=load_image(left_path),
            right=load_image(right_path),
            max_disparity=self.max_disparity)

    def get_ground_truth(self, idx: int) -> Dict:
        left_path, _ = self.images[idx]
        disp_path = self._disp_dir / left_path.name
        raw = np.asarray(load_image(disp_path))
        if raw.dtype != np.uint16:
            raise RuntimeError(
                f"KittiDataset: {disp_path} should be a uint16 PNG "
                f"(disparity * 256), got dtype {raw.dtype}")
        return dict(
            stereo_name=left_path.stem,
            gt_disparity=raw.astype(np.float32) / 256.0,
            max_disparity=self.max_disparity)

    def __getitem__(self, idx: int) -> Dict:
        item = self.get_stereo_pair(idx)
        item.update(self.get_ground_truth(idx))
        return item

    def __len__(self) -> int:
        return len(self.images)
