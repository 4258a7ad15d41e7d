"""Shapes shared by the card tests of the port's kernels
(``test_torch_kernels_cuda.py``) and the CPU tests that hold the plain
versions of those kernels against the JAX package at the same shapes
(``test_torch_cost.py``, ``test_torch_sgm_chunk.py``).
"""

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
