"""Build and load the hand-written CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a
plain C interface, which is loaded with ``ctypes``.  Nothing here
includes PyTorch's headers, so a build takes seconds, not minutes.  The
library lands in ``stereomatch_tpu_torch/_build/`` (ignored by git) under
a name keyed by a hash of the sources and the flags, so an edited kernel
is rebuilt and an unchanged one is loaded as it is.

Importing this module builds nothing and needs no ``nvcc``: the build
runs only when a CUDA tensor first asks for a kernel (or when
:func:`build` is called), and a missing ``nvcc`` raises then.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` on top of the
kernels' explicit ``__fadd_rn``/``__fmul_rn``: a contracted
``acc + d * d`` rounds once where the plain PyTorch version rounds
twice, which would break bit-equality with it; a kernel fuses a
multiply-add only where its plain version does, with ``__fmaf_rn``.
``--use_fast_math`` is never used (it flushes denormals and approximates
division).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

_SSD = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_SGM = (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P)
_SIDE = (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P)
_FOLD = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P)
_FOLD_INTO = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P)
_DP_FORWARD = (_P, _P, _P, _I, _I, _I, _P)
_CVF_STATS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
              _P)
_CVF_FILTER = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_HAMMING = (_P, _P, _P, _I, _I, _I, _I, _I, _P)

# C entry points of csrc/*.cu and their argument types.  Every one
# returns the cudaError_t of its launch (0 = success).  The _bf16 entries
# take bf16 cost volumes (SSD and the CVF filter: store one).
_SIGNATURES = {
    # (left, right, out, H, W, D, k, absolute, stream)
    "stm_ssd_f32": _SSD,
    "stm_ssd_i32": _SSD,
    "stm_ssd_bf16": _SSD,
    # The SGM entries take, after p1 and p2, adaptive: 1 for the
    # adaptive P2, 0 for the constant max(P1, P2).
    # (cost, image, out, H, W, D, dy, dx, p1, p2, adaptive, accumulate,
    #  stream)
    "stm_sgm_rows_f32": _SGM,
    "stm_sgm_horizontal_f32": _SGM,
    "stm_sgm_horizontal_bf16": _SGM,
    # (cost, image, out, result, H, W, D, dy, dx, p1, p2, adaptive,
    #  accumulate, stream)
    "stm_sgm_rows_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                          _I, _P),
    # (cost, image, carry, carry_image, out, carry_out, H, W, D, dy, dx,
    #  p1, p2, adaptive, seed, accumulate, stream)
    "stm_sgm_chunk_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                          _I, _I, _I, _P),
    # (cost, image, carry, carry_image, out, result, carry_out, H, W, D,
    #  dy, dx, p1, p2, adaptive, seed, accumulate, stream)
    "stm_sgm_chunk_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _F, _F, _I, _I, _I, _P),
    # The side-by-side form: (cost, image, out, partials, steps (seven
    # (dy, dx) pairs, host ints), H, W, D, p1, p2, adaptive, stream), then
    # the fold (cost, image, out, partials, H, W, D, dy, dx, p1, p2,
    # adaptive, stream), the bf16 fold with result after partials, and
    # the winner-takes-all folds with the int32 disparity [H, W] there.
    "stm_sgm_side_by_side_f32": _SIDE,
    "stm_sgm_side_by_side_bf16": _SIDE,
    "stm_sgm_fold_f32": _FOLD,
    "stm_sgm_fold_bf16": _FOLD_INTO,
    "stm_sgm_fold_wta_f32": _FOLD_INTO,
    "stm_sgm_fold_wta_bf16": _FOLD_INTO,
    # (cost, ptr, final_costs, H, W, D, stream)
    "stm_dp_forward_f32": _DP_FORWARD,
    "stm_dp_forward_bf16": _DP_FORWARD,
    # (ptr, final_costs, disp, H, W, D, stream)
    "stm_dp_backward": (_P, _P, _P, _I, _I, _I, _P),
    # (vol, guide, hi1, lo1, hi2, lo2, pd1, pd2, a0, b0, H, W, D, r, off,
    #  eps, stream)
    "stm_cvf_stats_f32": _CVF_STATS,
    "stm_cvf_stats_bf16": _CVF_STATS,
    # (a0, b0, guide, q, H, W, D, r, off, stream)
    "stm_cvf_filter_f32": _CVF_FILTER,
    "stm_cvf_filter_bf16": _CVF_FILTER,
    # (left, right, codes_left, codes_right, H, W, window width, window
    #  height, stream)
    "stm_census_codes": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (codes_left, codes_right, out, H, W, D, words, disparity offset,
    #  stream)
    "stm_census_hamming_f32": _HAMMING,
    "stm_census_hamming_i32": _HAMMING,
    "stm_census_hamming_bf16": _HAMMING,
    # csrc/trace.cu (TRACE_ENTRIES).  (ring, state, mask, stage, stream)
    "stm_stamp": (_P, _P, _L, _I, _P),
    # (bytes, host out, device out)
    "stm_stamp_ring_alloc": (_L, _P, _P),
    # (graph, counts out [4])
    "stm_graph_nodes": (_P, _P),
}


# The entry points of csrc/trace.cu, for utils/profiling.py: tracing, not
# the pipeline's work, so LAUNCHES never counts them.
TRACE_ENTRIES = ("stm_stamp", "stm_stamp_ring_alloc", "stm_graph_nodes")


class BuildResult(NamedTuple):
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/spill report)


_LIB: Optional[ctypes.CDLL] = None

# Launches of each C entry point (keyed by its name, e.g.
# "stm_sgm_rows_bf16"), counted by check_launch: a run can show which
# kernels, and which dtype's instantiations, it went through.
LAUNCHES: collections.Counter = collections.Counter()


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if (DEFAULT_CUDA_HOME / "bin" / "nvcc").is_file():
        return str(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    raise RuntimeError(
        "the CUDA kernels of stereomatch_tpu_torch need nvcc to build; none "
        f"found under $CUDA_HOME, $CUDA_PATH, on PATH or in "
        f"{DEFAULT_CUDA_HOME}")


def _key() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with the output of the first
    that fails, else return all their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outputs)


def build() -> BuildResult:
    """Compile the kernels unless a library for these sources exists."""
    target = BUILD_DIR / f"libstm_kernels_{_key()}.so"
    if target.is_file():
        return BuildResult(target, 0.0, "")
    nvcc = _nvcc()
    cu_files = [p for p in _sources() if p.suffix == ".cu"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a private directory, then rename the library into place: a
    # concurrent process never loads a half-written one.
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    objects = [str(work / f"{p.stem}.o") for p in cu_files]
    tmp = work / "lib.so"
    start = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                         obj, str(src)]
                        for obj, src in zip(objects, cu_files)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *objects]])
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return BuildResult(target, time.perf_counter() - start, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA call failed with cudaError_t "
                           f"{status}")


def check_launch(name: str, status: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch, else
    count the launch in ``LAUNCHES[name]``."""
    check_status(name, status)
    LAUNCHES[name] += 1
