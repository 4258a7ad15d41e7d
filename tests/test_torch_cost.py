"""The port's plain SSD/SAD cost volumes against the JAX package.

The same numpy images, made from a seed, go through
``stereomatch_tpu.ops.cost`` (XLA on the CPU, the semantic oracle) and
``stereomatch_tpu_torch.ops.cost``.  The port keeps XLA's association
(2k shifted adds per axis, H first, then W), so float volumes must be
equal bit for bit, the int32 chain exactly, and +inf placement
identical.  Against the streaming Pallas kernel (interpret mode), whose
vertical sum is a running ring, the bound is that of
tests/test_ssd_pallas.py: 2e-6 relative + 2e-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu.ops.ssd_pallas import diff_cost_volume_pallas
from stereomatch_tpu_torch import cost as port_cost_api
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.utils import validation

from .torch_shapes import SSD_EDGE_SHAPES, SSD_INT_SHAPE

REL_TOL = 2e-6   # Pallas ring vs reduce_window order (test_ssd_pallas.py)
ABS_TOL = 2e-6

# tests/test_ssd_pallas.py's geometry sweep: tall/wide/tiny, k from 1 to
# 7, prime heights, H < k, a single row, W < 2k.
SHAPES = [
    (16, 24, 8, 3),
    (46, 56, 16, 7),
    (9, 33, 8, 1),
    (5, 12, 16, 7),
    (1, 10, 4, 2),
    (24, 32, 32, 5),
    (13, 17, 8, 4),
    (40, 30, 8, 7),
]
IDS = [f"{h}x{w}d{d}k{k}" for h, w, d, k in SHAPES]


def _pair(shape, seed):
    h, w = shape[:2]
    rng = np.random.default_rng(seed)
    return rng.random((h, w), np.float32), rng.random((h, w), np.float32)


def _port(fn, left, right, **kw):
    return fn(torch.from_numpy(left), torch.from_numpy(right), **kw).numpy()


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_float_volume_bit_equal_to_xla(shape, absolute):
    h, w, d, k = shape
    left, right = _pair(shape, h * 100 + w)
    jfn = jax_cost.sad_cost_volume if absolute else jax_cost.ssd_cost_volume
    pfn = port_cost.sad_cost_volume if absolute else port_cost.ssd_cost_volume
    ref = np.asarray(jfn(left, right, max_disparity=d, kernel_size=k))
    out = _port(pfn, left, right, max_disparity=d, kernel_size=k)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("in_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
def test_integer_chain_exact(in_dtype, absolute):
    """uint8/int16 images -> int32 cost: the reference's integer chain."""
    rng = np.random.default_rng(3)
    h, w, d, k = 21, 33, 16, 5
    lo, hi = (0, 255) if in_dtype == np.uint8 else (-300, 300)
    left = rng.integers(lo, hi, (h, w)).astype(in_dtype)
    right = rng.integers(lo, hi, (h, w)).astype(in_dtype)
    jfn = jax_cost.sad_cost_volume if absolute else jax_cost.ssd_cost_volume
    pfn = port_cost.sad_cost_volume if absolute else port_cost.ssd_cost_volume
    ref = np.asarray(jfn(left, right, max_disparity=d, kernel_size=k,
                         cost_dtype=jnp.int32))
    out = _port(pfn, left, right, max_disparity=d, kernel_size=k,
                cost_dtype=torch.int32)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert (out == np.iinfo(np.int32).max).any()     # the d > w wedge


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("shape", SSD_EDGE_SHAPES, ids=str)
def test_float_volume_bit_equal_to_xla_at_kernel_tile_edges(shape, absolute):
    """The plain volumes at the card tests' SSD shapes (the edges of
    csrc/ssd.cu's tile, k up to 150), so that the kernel, held there
    against the plain version, is held against the JAX package too."""
    h, w, d, k = shape
    left, right = _pair(shape, h * 7 + w)
    jfn = jax_cost.sad_cost_volume if absolute else jax_cost.ssd_cost_volume
    ref = np.asarray(jfn(left, right, max_disparity=d, kernel_size=k))
    out = _port(port_cost._diff_cost_volume, left, right, max_disparity=d,
                kernel_size=k, cost_dtype=torch.float32, absolute=absolute)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
def test_integer_chain_exact_over_several_tiles(absolute):
    """The int32 chain at the card tests' int32 shape (uint8 images)."""
    h, w, d, k = SSD_INT_SHAPE
    rng = np.random.default_rng(8)
    left = rng.integers(0, 256, (h, w)).astype(np.uint8)
    right = rng.integers(0, 256, (h, w)).astype(np.uint8)
    jfn = jax_cost.sad_cost_volume if absolute else jax_cost.ssd_cost_volume
    ref = np.asarray(jfn(left, right, max_disparity=d, kernel_size=k,
                         cost_dtype=jnp.int32))
    out = _port(port_cost._diff_cost_volume, left, right, max_disparity=d,
                kernel_size=k, cost_dtype=torch.int32, absolute=absolute)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_float_volume_matches_pallas_interpret(shape):
    h, w, d, k = shape
    left, right = _pair(shape, h + 7 * w)
    ref = np.asarray(diff_cost_volume_pallas(left, right, max_disparity=d,
                                             kernel_size=k, interpret=True))
    out = _port(port_cost.ssd_cost_volume, left, right, max_disparity=d,
                kernel_size=k)
    np.testing.assert_array_equal(ref == np.inf, out == np.inf)
    fin = ref != np.inf
    err = np.abs(out[fin] - ref[fin])
    assert (err <= ABS_TOL + REL_TOL * np.abs(ref[fin])).all(), err.max()


def test_shifted_right_stack_matches_xla():
    rng = np.random.default_rng(4)
    right = rng.random((6, 11), np.float32)
    ref = np.asarray(jax_cost.shifted_right_stack(right, 5))
    out = port_cost.shifted_right_stack(torch.from_numpy(right), 5).numpy()
    np.testing.assert_array_equal(out, ref)


def test_box_sum_is_half_open_clipped_window():
    """[i-k, i+k) with zero padding, on a 1-D ramp: out[i] sums
    x[max(i-k, 0) : min(i+k, n)]."""
    x = torch.arange(1, 11, dtype=torch.int32)
    out = port_cost._box_sum(x, 2, axes=(0,))
    want = [int(x[max(i - 2, 0):min(i + 2, 10)].sum()) for i in range(10)]
    assert out.tolist() == want


@pytest.mark.parametrize("cls,jfn", [
    (port_cost_api.SSD, jax_cost.ssd_cost_volume),
    (port_cost_api.SAD, jax_cost.sad_cost_volume)], ids=["SSD", "SAD"])
def test_class_api_on_cpu(cls, jfn):
    left, right = _pair((24, 40), 11)
    cost = cls(16, kernel_size=3)
    assert cost.backend == "auto"
    out = cost(torch.from_numpy(left), torch.from_numpy(right),
               cost_volume=torch.empty(0))          # accepted and ignored
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jfn(left, right, max_disparity=16,
                                    kernel_size=3)))
    cost.max_disparity = 8                           # mutable, as upstream
    assert cost(torch.from_numpy(left),
                torch.from_numpy(right)).shape == (24, 40, 8)
    explicit = cls(8, kernel_size=3, backend="torch")
    torch.testing.assert_close(explicit(torch.from_numpy(left),
                                        torch.from_numpy(right)),
                               out[..., :8], rtol=0, atol=0)


def test_class_api_validates():
    left = torch.zeros((4, 5), dtype=torch.float32)
    with pytest.raises(validation.ShapeError):
        port_cost_api.SSD(4)(left, torch.zeros((4, 6)))
    with pytest.raises(validation.DTypeError):
        port_cost_api.SSD(4)(left.double(), left.double())
    with pytest.raises(validation.DTypeError):
        port_cost_api.SSD(4, cost_volume_dtype=torch.float64)(left, left)
    with pytest.raises(ValueError):
        port_cost_api.SSD(0)
    with pytest.raises(ValueError):
        port_cost_api.SSD(4, backend="xla")(left, left)
