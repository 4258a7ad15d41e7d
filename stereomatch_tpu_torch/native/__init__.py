"""ctypes binding of libstmio, the native I/O runtime (``native/stmio.cpp``),
the port's own copy of ``stereomatch_tpu/native/__init__.py``.

The library exposes a C interface; numpy arrays cross it as raw pointers.
It is compiled from the repository's ``native/stmio.cpp`` with ``g++`` at
first use, into ``stereomatch_tpu_torch/_build/libstmio-<hash>.so`` (the
hash is of the source and the flags, so an edited source is rebuilt and
an unchanged one loaded as it is), never next to the source.  The build
is atomic: ``g++`` writes a temporary file in the same directory, which
is then renamed into place, and an ``fcntl`` lock on
``_build/libstmio.lock`` makes concurrent processes (test workers, a
server and its clients) build it once; a process never loads a
half-written library.

A failed build or load raises :class:`NativeIOError` with the compiler's
output, at every call that needs the library: nothing is remembered as
"unavailable".  :func:`available` says whether the library builds and
loads here, which is how ``io/data.py`` chooses between this codec and
its pure-Python parsers (host I/O, not a device fallback).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "stmio.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# The JAX package's flags (stereomatch_tpu/native/__init__.py).
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
BUILD_TIMEOUT_S = 300

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeIOError(RuntimeError):
    """The library failed to build or load, or a call into it failed."""


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    if not SOURCE.is_file():
        raise NativeIOError(f"libstmio: source {SOURCE} not found")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstmio-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/stmio.cpp`` unless its library exists; returns its
    path.  Raises :class:`NativeIOError` with the compiler's output."""
    target = library_path()
    if target.is_file():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeIOError("libstmio: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libstmio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if target.is_file():                 # another process built it
            return target
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".libstmio-",
                                   suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise NativeIOError(
                    f"libstmio: g++ failed ({proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, target)
        except (OSError, subprocess.SubprocessError) as err:
            raise NativeIOError(f"libstmio: g++ could not run: {err}") \
                from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as err:
                raise NativeIOError(f"libstmio: loading {path} failed: "
                                    f"{err}") from err
            _declare(lib)
            _LIB = lib
        return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    lib.stmio_last_error.argtypes = []
    lib.stmio_last_error.restype = c.c_char_p
    signatures = {
        "stmio_pfm_probe": [c.c_char_p, i32p, i32p, i32p],
        "stmio_pfm_read": [c.c_char_p, c.POINTER(c.c_float), c.c_int64],
        "stmio_pfm_write": [c.c_char_p, c.POINTER(c.c_float), c.c_int32,
                            c.c_int32, c.c_int32],
        "stmio_pnm_probe": [c.c_char_p, i32p, i32p, i32p, i32p],
        "stmio_pnm_read": [c.c_char_p, c.POINTER(c.c_uint8), c.c_int64],
        "stmio_pnm_write": [c.c_char_p, c.POINTER(c.c_uint8), c.c_int32,
                            c.c_int32, c.c_int32],
        "stmio_y4m_open": [c.c_char_p, c.c_int32, c.POINTER(c.c_void_p),
                           i32p, i32p, i32p, i32p],
        "stmio_y4m_read": [c.c_void_p, c.POINTER(c.c_uint8)],
        "stmio_y4m_write": [c.c_char_p, c.POINTER(c.c_uint8), c.c_int32,
                            c.c_int32, c.c_int32, c.c_int32, c.c_int32],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c.c_int
    lib.stmio_y4m_close.argtypes = [c.c_void_p]
    lib.stmio_y4m_close.restype = None


def available() -> bool:
    """True when the library builds (or is built) and loads here."""
    try:
        _load()
    except NativeIOError:
        return False
    return True


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise NativeIOError(
            f"{what}: {lib.stmio_last_error().decode(errors='replace')}")


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _channels(image: np.ndarray) -> int:
    if image.ndim == 2:
        return 1
    if image.ndim == 3 and image.shape[2] in (1, 3):
        return image.shape[2]
    raise ValueError(f"expected [H, W] or [H, W, 3], got {image.shape}")


# -- PFM --------------------------------------------------------------------

def read_pfm(path) -> np.ndarray:
    """float32 [H, W] or [H, W, 3], rows top-down."""
    lib = _load()
    w, h, ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    p = str(path).encode()
    _check(lib, lib.stmio_pfm_probe(p, w, h, ch), "pfm_probe")
    out = np.empty((h.value, w.value, ch.value), np.float32)
    _check(lib, lib.stmio_pfm_read(p, _fptr(out), out.size), "pfm_read")
    return out[:, :, 0] if ch.value == 1 else out


def write_pfm(path, image: np.ndarray) -> None:
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    ch = _channels(image)
    _check(lib, lib.stmio_pfm_write(str(path).encode(), _fptr(image),
                                    image.shape[1], image.shape[0], ch),
           "pfm_write")


# -- PGM / PPM --------------------------------------------------------------

def read_pnm(path) -> np.ndarray:
    """uint8 [H, W] (P5) or [H, W, 3] (P6)."""
    lib = _load()
    w, h, ch, mv = (ctypes.c_int32() for _ in range(4))
    p = str(path).encode()
    _check(lib, lib.stmio_pnm_probe(p, w, h, ch, mv), "pnm_probe")
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    _check(lib, lib.stmio_pnm_read(p, _u8ptr(out), out.size), "pnm_read")
    return out[:, :, 0] if ch.value == 1 else out


def write_pnm(path, image: np.ndarray) -> None:
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    ch = _channels(image)
    _check(lib, lib.stmio_pnm_write(str(path).encode(), _u8ptr(image),
                                    image.shape[1], image.shape[0], ch),
           "pnm_write")


# -- Y4M --------------------------------------------------------------------

class Y4MReader:
    """Streaming luma reader over a YUV4MPEG2 file.

    ``prefetch`` > 0 decodes on a native thread into a ring of that many
    frames, overlapping file I/O with the caller's work; 0 reads on the
    calling thread.
    """

    def __init__(self, path, prefetch: int = 2):
        lib = _load()
        self._lib = lib
        self._handle = None
        handle = ctypes.c_void_p()
        w, h, fn, fd = (ctypes.c_int32() for _ in range(4))
        _check(lib, lib.stmio_y4m_open(str(path).encode(), int(prefetch),
                                       ctypes.byref(handle), w, h, fn, fd),
               "y4m_open")
        self._handle = handle
        self.width = w.value
        self.height = h.value
        self.fps = (fn.value, fd.value)

    def read(self) -> Optional[np.ndarray]:
        """Next grayscale frame [H, W] uint8, or None at the end."""
        if self._handle is None:
            return None
        out = np.empty((self.height, self.width), np.uint8)
        code = self._lib.stmio_y4m_read(self._handle, _u8ptr(out))
        if code == 1:
            return None
        _check(self._lib, code, "y4m_read")
        return out

    def close(self) -> None:
        """Stop the prefetch thread and close the file (idempotent)."""
        if self._handle is not None:
            self._lib.stmio_y4m_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()

    def __iter__(self):
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame


def write_y4m(path, frames: np.ndarray, fps: Tuple[int, int] = (30, 1)):
    """Write mono frames [N, H, W] uint8 as a Y4M stream."""
    lib = _load()
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 3:
        raise ValueError(f"write_y4m: frames [N, H, W], got {frames.shape}")
    n, h, w = frames.shape
    _check(lib, lib.stmio_y4m_write(str(path).encode(), _u8ptr(frames),
                                    n, w, h, fps[0], fps[1]), "y4m_write")
