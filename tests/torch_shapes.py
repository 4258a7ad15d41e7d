"""Shapes shared by the card tests of the port's kernels
(``test_torch_kernels_cuda.py``) and the CPU tests that hold the plain
versions of those kernels against the JAX package at the same shapes
(``test_torch_cost.py``, ``test_torch_sgm_chunk.py``, ``test_torch_dp.py``),
and the JAX package's soak geometries, which ``chip_smoke.py`` and
``test_torch_soak.py`` share.
"""

from typing import NamedTuple, Optional

import numpy as np

# (H, W, D, k) at the edges of csrc/ssd.cu's tile: G output rows (8 at
# k >= 4) x 32 columns x TD disparities (32, or D rounded up to 4 below
# that), G and TD shrinking with k; above k of about 40 a block streams
# its window rows through shared memory.
SSD_EDGE_SHAPES = [
    (3, 40, 37, 7),       # H < G; W and D not multiples of the tile
    (21, 70, 64, 7),      # H not a multiple of G
    (13, 20, 24, 4),      # W < 32
    (13, 45, 1, 1),       # D = 1, k = 1 (G = XB = 2)
    (17, 45, 129, 3),     # D = 129, k = 3 (G = XB = 4)
    (9, 40, 300, 2),      # D = 300
    (24, 65, 96, 7),      # several tiles along every axis
    (30, 50, 40, 15),     # G shrinks to 4
    (40, 90, 40, 24),     # G shrinks to 2
    (12, 40, 8, 48),      # streamed rows, one round of vertical items
    (6, 20, 5, 150),      # streamed rows, two rounds
]

# The int32 chain (uint8 images) over more than one tile along each axis.
SSD_INT_SHAPE = (40, 70, 48, 7)

# No tile of this k fits one block's shared memory: the launcher refuses.
SSD_REFUSED_K = 5000

# ((H, W, D, k), row cuts) for the SGM chunk kernel: chunks of 1, 3, 7 and
# 1 rows (shorter than the ring's 8 steps) at D = 1, 37 and 129.
CHUNK_SHORT_CASES = [((12, 30, 1, 2), (1, 4, 11)),
                     ((12, 25, 37, 2), (1, 4, 11)),
                     ((12, 19, 129, 3), (1, 4, 11))]

# (H, W, D, seed) of the DP cost volumes whose minima ramp by +-1 a column
# and saturate at 0 and D - 1 (:func:`ramp_cost_volume`): the disparities
# move one step a column for runs longer than the walk's 32-step batch,
# so csrc/dp.cu's windowed walk reaches its window's edge and the band's.
# W not a multiple of 32, D on both sides of 64 and one at J = 8 without
# 16-byte pieces (D = 130).
DP_RAMP_CASES = [(4, 97, 65, 1), (3, 200, 64, 2), (4, 150, 24, 3),
                 (2, 260, 130, 4)]


def ramp_cost_volume(height, width, max_disp, seed):
    """float32 [H, W, D]: |d - m(w)| plus noise below 0.25, where each
    row's minimum m starts at a random disparity, moves +1 or -1 a column,
    turns every 40-120 columns and is clipped to [0, D - 1]."""
    rng = np.random.default_rng(seed)
    minima = np.empty((height, width), np.int64)
    for h in range(height):
        m, s = int(rng.integers(0, max_disp)), int(rng.choice([-1, 1]))
        turn = int(rng.integers(40, 121))
        for w in range(width):
            if w and w % turn == 0:
                s = -s
            minima[h, w] = m
            m = min(max(m + s, 0), max_disp - 1)
    d = np.arange(max_disp)
    vol = np.abs(d[None, None, :] - minima[:, :, None]).astype(np.float32)
    return vol + 0.25 * rng.random(vol.shape, np.float32)


# The seeds of the JAX package's differential soak
# (``tests/test_differential_soak.py``); ``chip_smoke.py`` holds the
# kernels at their geometries on the card, ``test_torch_soak.py`` the
# plain chain against the oracles and JAX on the CPU.
SOAK_SEEDS = [3, 11, 17, 23, 29, 37, 43, 53, 61, 71, 79, 83, 89, 97,
              101, 107]
# The seeds of the soak's integer matrix (uint8/int16 images x
# int32/float32 cost) and of its fused-CVF layout draws (1000 + seed).
SOAK_INT_SEEDS = [5, 19, 47, 73]
SOAK_CVF_LAYOUT_SEEDS = list(range(8))


class SoakCase(NamedTuple):
    height: int
    width: int
    max_disp: int
    k: int
    p1: Optional[float]        # the chain's SGM penalties
    p2: Optional[float]
    radius: Optional[int]      # the CVF draw's radius and eps
    eps: Optional[float]
    left: np.ndarray
    right: np.ndarray


def soak_geometry(seed: int, cvf: bool = False) -> SoakCase:
    """The soak's random geometry and images at ``seed``, drawn in the
    order the JAX package's soak draws them: H, W, D, k, then the SGM
    penalties P1, P2 (``test_differential_chain``) or, with ``cvf``, the
    radius and eps (``test_cvf_differential``), then the two float32
    images."""
    rng = np.random.default_rng(seed)
    height = int(rng.integers(6, 24))
    width = int(rng.integers(10, 32))
    max_disp = int(rng.integers(2, min(width, 16)))
    k = int(rng.integers(1, 4))
    p1 = p2 = radius = eps = None
    if cvf:
        radius = int(rng.integers(1, 5))
        eps = float(rng.uniform(1e-5, 1e-2))
    else:
        p1 = float(rng.uniform(0.01, 0.5))
        p2 = float(rng.uniform(p1, 1.5))
    left = rng.random((height, width)).astype(np.float32)
    right = rng.random((height, width)).astype(np.float32)
    return SoakCase(height, width, max_disp, k, p1, p2, radius, eps, left,
                    right)


def soak_int_geometry(seed: int, image_dtype) -> tuple:
    """(left, right, D, k) of the soak's integer matrix at ``seed``
    (``test_integer_chain``): images in [0, 250) of ``image_dtype``."""
    rng = np.random.default_rng(seed)
    height = int(rng.integers(8, 20))
    width = int(rng.integers(12, 28))
    max_disp = int(rng.integers(2, 12))
    k = int(rng.integers(1, 4))
    left = rng.integers(0, 250, (height, width)).astype(image_dtype)
    right = rng.integers(0, 250, (height, width)).astype(image_dtype)
    return left, right, max_disp, k


def soak_cvf_layout(seed: int) -> tuple:
    """(volume, guide, radius, wedge_offset) of the soak's fused-CVF
    layout draw at ``seed`` (``test_fused_cvf_layouts_differential``,
    rng seed 1000 + seed): a random float32 volume, +inf where
    x < d + wedge_offset, and a float32 guide."""
    rng = np.random.default_rng(1000 + seed)
    height = int(rng.integers(10, 40))
    width = int(rng.integers(14, 48))
    max_disp = int(rng.integers(2, min(width, 20)))
    radius = int(rng.integers(1, 6))
    off = int(rng.integers(0, 3))
    vol = rng.random((height, width, max_disp)).astype(np.float32)
    x, d = np.meshgrid(np.arange(width), np.arange(max_disp), indexing="ij")
    vol[:, x < d + off] = np.inf
    guide = rng.random((height, width)).astype(np.float32)
    return vol, guide, radius, off
