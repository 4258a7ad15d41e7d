"""Stereo frame capture: cameras, video files, Y4M streams and image
sequences, a copy of ``stereomatch_tpu/io/capture.py`` for the port.

Side-by-side frames are split at width/2 (the reference's
capture.py:82-91).  OpenCV is optional and imported only by
:class:`StereoCapture` (cameras and video files): the card's machine has
none, and the other captures need none.  :class:`Y4MCapture` decodes on
the port's libstmio binding (``stereomatch_tpu_torch.native``);
:class:`ImageSequenceCapture` reads frames with ``io/data.load_image``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

# ITU-R BT.601 luma weights, matching cv2.cvtColor BGR2GRAY.
_BGR_WEIGHTS = np.array([0.114, 0.587, 0.299], np.float32)


def to_grayscale_array(image: np.ndarray) -> np.ndarray:
    """BGR [H, W, 3] uint8 -> grayscale [H, W] uint8 (BT.601)."""
    if image.ndim == 2:
        return image
    gray = image.astype(np.float32) @ _BGR_WEIGHTS
    return np.round(gray).astype(np.uint8)


@dataclass
class StereoCaptureImage:
    """A captured stereo frame: left / right halves plus the joined frame.

    Arrays are BGR [H, W, 3] uint8 or gray [H, W] uint8 (reference:
    capture.py:12-33).
    """
    left: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    joined: Optional[np.ndarray] = None

    def __iter__(self):
        return iter((self.left, self.right, self.joined))

    def to_grayscale(self) -> "StereoCaptureImage":
        return StereoCaptureImage(
            to_grayscale_array(self.left),
            to_grayscale_array(self.right),
            to_grayscale_array(self.joined))


def split_side_by_side(frame: np.ndarray) -> StereoCaptureImage:
    """Split a side-by-side stereo frame at width/2 (capture.py:82-91)."""
    half_width = frame.shape[1] // 2
    return StereoCaptureImage(frame[:, :half_width],
                              frame[:, half_width:half_width * 2],
                              frame)


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"OpenCV (cv2) is required for {what}, and it "
                           f"is not installed") from None
    return cv2


class StereoCapture:
    """OpenCV-backed stereo video/camera reader
    (reference: capture.py:36-98)."""

    def __init__(self, video_capture):
        self.video_capture = video_capture

    def __del__(self):
        self.close()

    @classmethod
    def from_device(cls, dev_idx: int) -> "StereoCapture":
        cap = _cv2("camera capture").VideoCapture(dev_idx)
        if not cap.isOpened():
            raise RuntimeError(f"Unable to open camera {dev_idx}")
        return cls(cap)

    @classmethod
    def from_file(cls, filepath: Union[str, Path]) -> "StereoCapture":
        cap = _cv2("video-file capture").VideoCapture(str(filepath))
        if not cap.isOpened():
            raise RuntimeError(f"Unable to open file {filepath}")
        return cls(cap)

    def read_next(self) -> Tuple[bool, StereoCaptureImage]:
        ok, frame = self.video_capture.read()
        if not ok:
            return False, StereoCaptureImage()
        return True, split_side_by_side(frame)

    def close(self) -> None:
        if getattr(self, "video_capture", None) is not None:
            self.video_capture.release()
            self.video_capture = None


class Y4MCapture:
    """Side-by-side stereo capture over a YUV4MPEG2 stream.

    Decode runs on libstmio's prefetch thread (``native.Y4MReader``),
    overlapping file I/O with device work.  Frames are the luma plane;
    same ``read_next`` contract as :class:`StereoCapture`.  Make streams
    with ``ffmpeg -i any.mp4 -pix_fmt yuv420p out.y4m`` or
    ``native.write_y4m``.  A library that does not build raises
    ``native.NativeIOError`` with the compiler's output.
    """

    def __init__(self, path, prefetch: int = 2):
        from .. import native
        self._reader = native.Y4MReader(path, prefetch=prefetch)
        self.width = self._reader.width
        self.height = self._reader.height
        self.fps = self._reader.fps

    def read_next(self) -> Tuple[bool, StereoCaptureImage]:
        frame = self._reader.read()
        if frame is None:
            return False, StereoCaptureImage()
        return True, split_side_by_side(frame)

    def close(self) -> None:
        self._reader.close()


class ImageSequenceCapture:
    """Capture over a directory of side-by-side frames (PNG, PGM/PPM; other
    formats through PIL), or over a list of paths or in-memory arrays.
    cv2-free; useful for tests and replays."""

    def __init__(self, frames):
        self._frames = list(frames)
        self._pos = 0

    @classmethod
    def from_directory(cls, directory, pattern: str = "*.png"):
        paths = sorted(Path(directory).glob(pattern))
        if not paths:
            raise RuntimeError(f"No frames matching {pattern} in {directory}")
        return cls(paths)

    def read_next(self) -> Tuple[bool, StereoCaptureImage]:
        if self._pos >= len(self._frames):
            return False, StereoCaptureImage()
        entry = self._frames[self._pos]
        self._pos += 1
        if isinstance(entry, (str, Path)):
            from .data import load_image
            frame = load_image(entry)
            if frame.ndim == 3:  # loaded RGB; the capture contract is BGR
                frame = frame[:, :, ::-1]
        else:
            frame = np.asarray(entry)
        return True, split_side_by_side(frame)

    def close(self) -> None:
        self._pos = len(self._frames)
