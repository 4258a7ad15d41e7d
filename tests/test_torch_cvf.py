"""The port's guided-filter aggregation (wedge path) against the JAX package.

The same numpy volumes and guides, made from a seed, go through:

* JAX ``guided_filter_aggregate(..., wedge_offset=off, use_mxu=False)``,
  the XLA wedge path with every box a ``reduce_window``.  The port keeps
  its association (window-order box sums, XLA's CPU cumsum blocks, and
  a fused multiply-add wherever XLA's CPU backend contracts one), so
  the two are held bit-equal for r >= 1.  At r = 0 XLA drops the
  one-tap boxes and fuses differently: there the bound is
  rtol=1e-5, atol=1e-6, with identical +inf placement.
* JAX's default lowering (the H box as an einsum where H <= 512), and
  the fused Pallas kernels K9 (``guided_filter_wedge_pallas``) and K10
  (``guided_filter_wedge_chunked_pallas``) in interpret mode, as
  tests/test_cvf_pallas.py runs them: rtol=1e-4, atol=1e-5, the JAX
  package's own bound for its Pallas-vs-XLA comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stereomatch_tpu.aggregation import CostFilter as JaxCostFilter
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.cvf import guided_filter_aggregate as jax_cvf
from stereomatch_tpu.ops.cvf_pallas import (
    guided_filter_wedge_chunked_pallas, guided_filter_wedge_pallas)
from stereomatch_tpu_torch.aggregation import CostFilter
from stereomatch_tpu_torch.ops import cvf as port
from stereomatch_tpu_torch.utils import validation
from stereomatch_tpu_torch.utils.numeric import fma

from .conftest import synthetic_stereo_pair
from .oracles import guided_filter_oracle

PALLAS_RTOL, PALLAS_ATOL = 1e-4, 1e-5     # tests/test_cvf_pallas.py:45,145
R0_RTOL, R0_ATOL = 1e-5, 1e-6

# tests/test_cvf_pallas.py:27-33 (full width) and :124-128 (chunked, with
# the chunk width), plus r = 0.
FULL = [(20, 30, 12, 3, 0), (17, 25, 8, 2, 3), (33, 41, 16, 8, 0),
        (12, 40, 16, 1, 0), (24, 26, 5, 4, 0)]
CHUNKED = [(30, 72, 12, 3, 24, 0), (26, 70, 8, 4, 32, 2),
           (22, 64, 16, 8, 40, 0)]


def _wedge_volume(rng, h, w, d, off=0):
    vol = rng.random((h, w, d), np.float32)
    x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    vol[:, x < dd + off] = np.inf
    return vol


def _case(h, w, d, off):
    rng = np.random.default_rng(h + w)
    return _wedge_volume(rng, h, w, d, off), rng.random((h, w), np.float32)


def _port(vol, g, r, off):
    return port.guided_filter_aggregate(torch.from_numpy(vol),
                                        torch.from_numpy(g), radius=r,
                                        wedge_offset=off).numpy()


def _assert_close(got, ref, rtol, atol):
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=atol)


@pytest.mark.parametrize("h,w,d,r,off",
                         FULL + [(h, w, d, r, off)
                                 for h, w, d, r, _, off in CHUNKED])
def test_bit_equal_to_xla_reduce_window_path(h, w, d, r, off):
    vol, g = _case(h, w, d, off)
    ref = np.asarray(jax_cvf(vol, g, radius=r, wedge_offset=off,
                             use_mxu=False))
    got = _port(vol, g, r, off)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_radius_zero_within_bound_of_xla():
    vol, g = _case(8, 12, 4, 0)
    ref = np.asarray(jax_cvf(vol, g, radius=0, wedge_offset=0,
                             use_mxu=False))
    _assert_close(_port(vol, g, 0, 0), ref, R0_RTOL, R0_ATOL)


@pytest.mark.parametrize("h,w,d,r,off", FULL)
def test_matches_default_lowering_and_fused_kernel(h, w, d, r, off):
    vol, g = _case(h, w, d, off)
    got = _port(vol, g, r, off)
    ref = np.asarray(jax_cvf(vol, g, radius=r, wedge_offset=off))
    _assert_close(got, ref, PALLAS_RTOL, PALLAS_ATOL)
    k9 = np.asarray(guided_filter_wedge_pallas(vol, g, radius=r,
                                               wedge_offset=off,
                                               interpret=True))
    _assert_close(got, k9, PALLAS_RTOL, PALLAS_ATOL)


@pytest.mark.parametrize("h,w,d,r,wc,off", CHUNKED)
def test_matches_chunked_fused_kernel(h, w, d, r, wc, off):
    vol, g = _case(h, w, d, off)
    k10 = np.asarray(guided_filter_wedge_chunked_pallas(
        vol, g, radius=r, wedge_offset=off, chunk_width=wc, interpret=True))
    _assert_close(_port(vol, g, r, off), k10, PALLAS_RTOL, PALLAS_ATOL)


def test_matches_float64_oracle():
    """The masked guided filter in its direct windowed form
    (tests/oracles.py), held at tests/test_cvf.py's bound for the XLA
    wedge path: rtol=2e-4, atol=2e-5."""
    left, right, _ = synthetic_stereo_pair(14, 22, 8, seed=3)
    vol = np.array(ssd_cost_volume(left, right, max_disparity=8,
                                   kernel_size=2))
    ref = guided_filter_oracle(vol, left, radius=2, eps=1e-4)
    _assert_close(_port(vol, left, 2, 0), ref, 2e-4, 2e-5)


def test_xla_cpu_fuses_multiply_add_as_the_port_does():
    """XLA's CPU backend contracts a product feeding a difference into one
    FMA; the port's ``utils.numeric.fma`` (which the plain CVF takes)
    rounds the same way, where two roundings would not."""
    rng = np.random.default_rng(6)
    x, y, z = (rng.random(20_000, np.float32) for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: a - b * c)(x, y, z))
    fused = fma(-torch.from_numpy(y), torch.from_numpy(z),
                torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(fused, ref)
    assert (x - y * z != ref).any()


def test_prefix_sum_takes_xla_cpu_association():
    rng = np.random.default_rng(2)
    for n in (1, 16, 17, 40, 257, 450, 1280):
        plane = (rng.random((5, n), np.float32) * 17).astype(np.float32)
        np.testing.assert_array_equal(
            port._prefix_sum_w(torch.from_numpy(plane)).numpy(),
            np.asarray(jnp.cumsum(plane, axis=1)))


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(radius=-1, wedge_offset=0), ValueError, "radius"),
    (dict(eps=0.0, wedge_offset=0), ValueError, "eps"),
    (dict(wedge_offset=-1), ValueError, "wedge_offset"),
    (dict(subsample=0, wedge_offset=0), ValueError, "subsample"),
    (dict(assume_finite=True, wedge_offset=0), ValueError, "exclusive"),
    (dict(subsample=2, wedge_offset=0), ValueError, "subsampled"),
    (dict(), None, None),
    (dict(subsample=2), None, None),
],
    # The last two cases' ids from while the masked path and the fast
    # guided filter were refused (ROADMAP A.9).
    ids=[f"kwargs{i}-ValueError-{m}" for i, m in enumerate(
        ("radius", "eps", "wedge_offset", "subsample", "exclusive",
         "subsampled"))]
    + ["kwargs6-NotImplementedError-A.9", "kwargs7-NotImplementedError-A.9"])
def test_argument_errors_raise_as_in_jax(kwargs, exc, match):
    """The JAX package's argument errors; the masked path (``wedge_offset
    =None``) and the fast guided filter, refused until they were ported,
    run and equal JAX's XLA paths (the masked one bit for bit, the fast
    one within tests/test_torch_cvf_masked.py's FAST_RTOL/FAST_ATOL)."""
    vol, g = _case(8, 12, 4, 0)
    if exc is None:
        got = port.guided_filter_aggregate(torch.from_numpy(vol),
                                           torch.from_numpy(g),
                                           **kwargs).numpy()
        ref = np.asarray(jax_cvf(vol, g, use_mxu=False, **kwargs))
        if kwargs:
            _assert_close(got, ref, 2e-4, 2e-5)
        else:
            np.testing.assert_array_equal(got, ref)
        return
    with pytest.raises(exc, match=match):
        port.guided_filter_aggregate(torch.from_numpy(vol),
                                     torch.from_numpy(g), **kwargs)
    with pytest.raises(ValueError):
        jax_cvf(vol, g, **kwargs)


def test_cost_filter_class_matches_jax_class():
    vol, g = _case(20, 30, 12, 0)
    ref = np.asarray(JaxCostFilter(radius=3, eps=1e-3, wedge_offset=0)(vol,
                                                                       g))
    layer = CostFilter(radius=3, eps=1e-3, wedge_offset=0)
    got = layer(torch.from_numpy(vol), torch.from_numpy(g)).numpy()
    _assert_close(got, ref, PALLAS_RTOL, PALLAS_ATOL)
    assert np.array_equal(
        got, CostFilter(radius=3, eps=1e-3, wedge_offset=0,
                        backend="torch")(torch.from_numpy(vol),
                                         torch.from_numpy(g)).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        CostFilter(wedge_offset=0, backend="cuda")(torch.from_numpy(vol),
                                                   torch.from_numpy(g))
    with pytest.raises(validation.DTypeError, match="float"):
        CostFilter(wedge_offset=0)(torch.zeros(20, 30, 12, dtype=torch.int32),
                                   torch.from_numpy(g))
    # The masked path (wedge_offset=None), refused until it was ported,
    # equals the JAX class's (its default lowering: the H box an einsum,
    # equal to the sequential sum at this height).
    np.testing.assert_array_equal(
        CostFilter()(torch.from_numpy(vol), torch.from_numpy(g)).numpy(),
        np.asarray(JaxCostFilter()(vol, g)))
