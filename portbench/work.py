"""The work of a frame's stages, counted once, and the card's peaks.

Bytes: each input byte read once and each output byte written once
(float32 images, 4 bytes a value; volumes in the configuration's
``cost_dtype``, 2 bytes a value in bfloat16 or float16 and 4 else),
whatever the kernels read again.  Operations: those of the algorithm's separable form,
counted alike whatever implements it:

* SSD, k: per cell a subtraction and a product, then 2k - 1 additions
  along each axis of the box sum: 2 + 2 (2k - 1) = 4k.
* census, window w: per pixel of each image w^2 - 1 comparisons, one
  shift and one OR a neighbour; per cell, for each 32-bit code word an
  XOR, a population count and an addition.
* SGM: per cell and path the minimum over the predecessor's disparities
  (one comparison a cell), the normalising subtraction, two additions
  of P1, three minima and the addition of the cost, then the addition
  into the sum of the paths: 9 a path.
* WTA: one comparison a cell.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3
# bytes per second, and float32 operations per second outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

FLOAT = 4
HALF_DTYPES = ("bfloat16", "float16")


def stage_work(stage: str, config: Mapping) -> Optional[Tuple[int, int]]:
    """(bytes, operations) of one frame's ``stage`` ("cost",
    "aggregation", "reduce") under ``config`` (its geometry and its
    ``estimator`` options, with the program's defaults); None where it
    is not counted here."""
    h, w, d = (int(config[k]) for k in ("height", "width", "max_disparity"))
    img, vol = h * w, h * w * d
    opts = config["estimator"]
    cell = 2 if str(opts.get("cost_dtype", "float32")) in HALF_DTYPES \
        else FLOAT
    if stage == "cost":
        if opts.get("cost", "ssd") == "ssd":
            ops = vol * 4 * int(opts.get("kernel_size") or 7)
        elif (opts.get("cost") == "census"
              and int(opts.get("kernel_size") or 1) == 1):
            bits = int(opts.get("census_window", 5)) ** 2 - 1
            words = -(-bits // 32)
            ops = 2 * img * bits * 3 + vol * words * 3
        else:
            return None
        return 2 * img * FLOAT + vol * cell, ops
    if stage == "aggregation":
        if opts.get("aggregation", "sgm") != "sgm":
            return None
        return 2 * vol * cell + img * FLOAT, vol * 8 * 9
    if stage == "reduce":
        if opts.get("reducer", "wta") != "wta":
            return None
        return vol * cell + img * FLOAT, vol
    return None


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S)


def roofline_pct(stage: str, config: Mapping,
                 ms_per_frame: Optional[float]) -> Optional[float]:
    """The stage's least time over its measured time, in percent."""
    counted = stage_work(stage, config)
    if counted is None or not ms_per_frame:
        return None
    return least_seconds(*counted) / (ms_per_frame * 1e-3) * 100.0
