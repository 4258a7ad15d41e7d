"""The port's plain SGM aggregation against the JAX package.

The same numpy volume and image go through
``stereomatch_tpu.ops.aggregation.semiglobal_aggregate`` (the XLA scan,
the semantic oracle) and ``stereomatch_tpu_torch.ops.aggregation``.  The
port keeps the scan's association (normalise first, +inf band edges,
the XLA traversal order), so the volumes must be equal bit for bit.
Against the Pallas kernels (interpret mode), which sum the traversals in
another order, the bound is the JAX package's own: rtol 2e-6 / atol 1e-5
with identical finiteness.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.ops.aggregation import (
    semiglobal_aggregate as jax_sgm, sgm_scan_with_carry as jax_scan)
from stereomatch_tpu.ops.cost import ssd_cost_volume as jax_ssd
from stereomatch_tpu.ops.sgm_pallas import semiglobal_aggregate_pallas
from stereomatch_tpu_torch.aggregation import Semiglobal
from stereomatch_tpu_torch.ops import aggregation as port_agg
from stereomatch_tpu_torch.utils import validation

from .torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-6, 1e-5   # Pallas pass order vs the XLA traversal order


def _scene(h, w, d, seed, k=3):
    rng = np.random.default_rng(seed)
    left = rng.random((h, w), np.float32)
    right = rng.random((h, w), np.float32)
    vol = np.array(jax_ssd(left, right, max_disparity=d, kernel_size=k))
    return vol, left


def _port(vol, left, **kw):
    return port_agg.semiglobal_aggregate(torch.from_numpy(vol),
                                         torch.from_numpy(left), **kw).numpy()


@pytest.mark.parametrize("shape", [
    (16, 24, 8), (13, 17, 8), (23, 37, 16), (1, 10, 4), (10, 1, 4),
    (37, 53, 24)], ids=lambda s: "x".join(map(str, s)))
def test_bit_equal_to_xla(shape):
    h, w, d = shape
    vol, left = _scene(h, w, d, seed=h * 31 + w)
    ref = np.asarray(jax_sgm(vol, left))
    np.testing.assert_array_equal(_port(vol, left), ref)


@pytest.mark.parametrize("p1,p2", [(0.3, 1.5), (0.05, 0.05), (1.0, 0.2)])
def test_nondefault_penalties_bit_equal(p1, p2):
    vol, left = _scene(19, 29, 12, seed=2)
    ref = np.asarray(jax_sgm(vol, left, penalty1=p1, penalty2=p2))
    np.testing.assert_array_equal(_port(vol, left, penalty1=p1,
                                        penalty2=p2), ref)


def test_flat_image_zero_gradient_bit_equal():
    """|dI| = 0 everywhere: P2 / 0 = +inf drops the P2 candidate."""
    vol, _ = _scene(11, 14, 8, seed=3)
    left = np.full((11, 14), 0.5, np.float32)
    np.testing.assert_array_equal(_port(vol, left),
                                  np.asarray(jax_sgm(vol, left)))


def test_distinct_value_volume_bit_equal_and_same_argmin():
    """The reference's distinct-value design: no ties for WTA to break."""
    rng = np.random.default_rng(9)
    h, w, d = 12, 20, 16
    vol = (rng.permutation(h * w * d).reshape(h, w, d)
           .astype(np.float32) / (h * w * d))
    left = rng.random((h, w), np.float32)
    ref = np.asarray(jax_sgm(vol, left))
    out = _port(vol, left)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out.argmin(axis=2), ref.argmin(axis=2))


@pytest.mark.parametrize("shape", [(16, 24, 8), (23, 37, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_close_to_pallas_interpret(shape):
    h, w, d = shape
    vol, left = _scene(h, w, d, seed=h + w)
    ref = np.asarray(semiglobal_aggregate_pallas(vol, left, interpret=True))
    out = _port(vol, left)
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(out))
    np.testing.assert_allclose(out[finite], ref[finite], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("carry_shift", [0, 1, -1])
def test_scan_with_carry_matches_xla_and_hands_off(carry_shift):
    """One scan equals the XLA scan; split in two chunks with the carry
    handed over, it equals itself unsplit."""
    rng = np.random.default_rng(carry_shift + 5)
    s, n, d = 14, 9, 6
    cost = rng.random((s, n, d), np.float32)
    image = rng.random((s, n), np.float32)
    (jf, ji), jout = jax_scan(cost, image, 0.1, 0.2, carry_shift)
    cost_t, image_t = torch.from_numpy(cost), torch.from_numpy(image)
    (pf, pi), pout = port_agg.sgm_scan_with_carry(cost_t, image_t, 0.1, 0.2,
                                                  carry_shift)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))

    carry, head = port_agg.sgm_scan_with_carry(cost_t[:5], image_t[:5], 0.1,
                                               0.2, carry_shift)
    _, tail = port_agg.sgm_scan_with_carry(cost_t[5:], image_t[5:], 0.1, 0.2,
                                           carry_shift, init_carry=carry,
                                           seed_first=False)
    np.testing.assert_array_equal(torch.cat([head, tail]).numpy(),
                                  pout.numpy())


def test_sweeps_follow_traversal_table():
    """``sweep`` per step, summed in TRAVERSALS order, is the aggregate;
    each traversal visits every pixel once (no +inf left where the cost
    is finite)."""
    vol, left = _scene(9, 12, 6, seed=8)
    cost, image = torch.from_numpy(vol), torch.from_numpy(left)
    total = None
    for step in port_agg.TRAVERSALS:
        part = port_agg.sweep(cost, image, 0.1, 0.2, step)
        assert torch.equal(torch.isfinite(part), torch.isfinite(cost))
        total = part if total is None else total + part
    assert torch.equal(total, port_agg.semiglobal_aggregate(cost, image))
    assert len(set(port_agg.TRAVERSALS)) == 8


def test_semiglobal_class_on_cpu():
    vol, left = _scene(14, 18, 8, seed=1)
    agg = Semiglobal(penalty1=0.2, penalty2=0.7)
    out = agg(torch.from_numpy(vol), torch.from_numpy(left),
              sga_volume=torch.empty(0))            # accepted and ignored
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_sgm(vol, left, penalty1=0.2,
                                        penalty2=0.7)))
    with pytest.raises(validation.ShapeError):
        agg(torch.from_numpy(vol), torch.zeros((3, 3)))
    with pytest.raises(TypeError):
        agg(torch.from_numpy(vol).to(torch.int32), torch.from_numpy(left))
