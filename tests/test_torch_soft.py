"""The port's differentiable SGM surface (``stereomatch_tpu_torch/ops/soft.py``)
against the JAX package's ``ops/soft.py``, on the CPU.

The forward pass equals JAX's ``semiglobal_aggregate_diff`` and the
port's plain ``semiglobal_aggregate`` bit for bit (flat rows exercise
the P2 / |dI| = 0 division; the diagonals' entry columns the zero
re-seed), for traced penalties too.  Gradients against ``jax.grad``:
the forward values feeding the loss are the same, but torch's softmax and
mean sum in other orders, so the cotangents differ in the last places:
measured 3.4e-6 relative on (P1, P2) and 3.6e-6 of the largest volume
cotangent at 32x48, D=16; held within 2e-5 and 2e-5 of it.  On costs
of 0 and 1 at D = 2 with integer penalties every tie is exact and
two-way, and the cotangents (sums of powers of one half) equal JAX's bit
for bit: the ties split as JAX splits them.  (With three-way ties over D
both split by thirds, which the two packages sum in other orders.)  ``soft_argmin`` within 1e-5 absolute
(measured 2.9e-6 on [0, 10) costs), +inf cells taking zero weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.ops.cost import census_hamming_cost_volume
from stereomatch_tpu.ops.soft import semiglobal_aggregate_diff as jax_diff
from stereomatch_tpu.ops.soft import soft_argmin as jax_soft_argmin
from stereomatch_tpu_torch.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu_torch.ops.soft import (semiglobal_aggregate_diff,
                                            soft_argmin)

from .conftest import synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = 16
GRAD_RTOL = 2e-5


@pytest.fixture(scope="module")
def scene():
    left, right, gt = synthetic_stereo_pair(32, 48, D, seed=5)
    vol = np.asarray(census_hamming_cost_volume(left, right,
                                                max_disparity=D))
    flat = np.array(left)
    flat[5:9, :] = 0.5                      # the /0 adaptive P2
    return vol, flat, gt


@pytest.mark.parametrize("p1,p2", [(0.1, 0.2), (2.0, 4.0), (0.7, 0.3)])
def test_forward_bit_equal_to_jax_and_plain(scene, p1, p2):
    vol, flat, _ = scene
    want = np.asarray(jax_diff(vol, flat, p1, p2))
    got = semiglobal_aggregate_diff(torch.from_numpy(vol),
                                    torch.from_numpy(flat), p1, p2)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = semiglobal_aggregate(torch.from_numpy(vol),
                                 torch.from_numpy(flat), penalty1=p1,
                                 penalty2=p2)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_traced_penalties_one_call_serves_every_value(scene):
    """Penalties as tensors (with gradients) give the float values'
    results; two values differ."""
    vol, flat, _ = scene
    out = []
    for p in ((0.1, 0.2), (2.0, 4.0)):
        pt = torch.tensor(p, requires_grad=True)
        out.append(semiglobal_aggregate_diff(torch.from_numpy(vol),
                                             torch.from_numpy(flat), pt[0],
                                             pt[1]).detach().numpy())
        np.testing.assert_array_equal(out[-1],
                                      np.asarray(jax_diff(vol, flat, *p)))
    assert not np.array_equal(*out)


def test_batched_scenes_equal_each_alone(scene):
    """[B, H, W, D] runs the scans once for B scenes; each scene gets its
    own result bit for bit (the diagonals' roll does not cross scenes)."""
    vol, flat, _ = scene
    rng = np.random.default_rng(3)
    vol2 = (rng.integers(0, 25, vol.shape)).astype(np.float32)
    img2 = rng.random(flat.shape).astype(np.float32)
    vols = torch.from_numpy(np.stack([vol, vol2]))
    imgs = torch.from_numpy(np.stack([flat, img2]))
    out = semiglobal_aggregate_diff(vols, imgs, 0.3, 0.9)
    for b in range(2):
        np.testing.assert_array_equal(
            out[b].numpy(),
            semiglobal_aggregate_diff(vols[b], imgs[b], 0.3, 0.9).numpy())


def _jax_grads(vol, image, gt, mask, tau):
    def loss(params, v):
        agg = jax_diff(v, image, params[0], params[1])
        disp = jax_soft_argmin(agg, tau)
        return jnp.mean(jnp.where(mask, (disp - gt) ** 2, 0.0))
    gp, gv = jax.grad(loss, argnums=(0, 1))(
        jnp.array([0.1, 0.2], jnp.float32), jnp.asarray(vol))
    return np.asarray(gp), np.asarray(gv)


def _port_grads(vol, image, gt, mask, tau, params=(0.1, 0.2)):
    p = torch.tensor(params, dtype=torch.float32, requires_grad=True)
    v = torch.from_numpy(np.array(vol)).requires_grad_(True)
    agg = semiglobal_aggregate_diff(v, torch.from_numpy(image), p[0], p[1])
    disp = soft_argmin(agg, tau)
    err = (disp - torch.from_numpy(np.asarray(gt, np.float32))) ** 2
    torch.where(torch.from_numpy(mask), err, 0.0).mean().backward()
    return p.grad.numpy(), v.grad.numpy()


def test_gradients_match_jax_grad(scene):
    vol, flat, gt = scene
    mask = np.zeros(gt.shape, bool)
    mask[:, D:] = True
    want_p, want_v = _jax_grads(vol, flat, gt, mask, 1.0)
    got_p, got_v = _port_grads(vol, flat, gt, mask, 1.0)
    assert np.all(np.isfinite(got_p)) and np.all(got_p != 0)
    assert np.all(np.isfinite(got_v))
    np.testing.assert_allclose(got_p, want_p, rtol=GRAD_RTOL)
    np.testing.assert_allclose(got_v, want_v, rtol=0,
                               atol=GRAD_RTOL * np.abs(want_v).max())


def test_tied_candidates_split_as_jax_splits_them():
    """Costs of 0 and 1, integer penalties and a two-level image, at D = 2
    (so every tie is two-way): the band's candidates and the per-path
    minima tie all over, every value is exact, and the cotangents (sums
    of powers of one half) must equal JAX's bit for bit."""
    rng = np.random.default_rng(11)
    vol = rng.integers(0, 2, (6, 7, 2)).astype(np.float32)
    vol[:, :1, 1:] = np.inf
    image = np.where(rng.random((6, 7)) < 0.5, 0.0, 0.5).astype(np.float32)
    p1, p2 = 1.0, 1.0

    def jloss(params, v):
        return jnp.sum(jnp.where(jnp.isfinite(v),
                                 jax_diff(v, image, params[0], params[1]),
                                 0.0))
    gp, gv = jax.grad(jloss, argnums=(0, 1))(
        jnp.array([p1, p2], jnp.float32), jnp.asarray(vol))
    p = torch.tensor([p1, p2], requires_grad=True)
    v = torch.from_numpy(vol).requires_grad_(True)
    agg = semiglobal_aggregate_diff(v, torch.from_numpy(image), p[0], p[1])
    torch.where(torch.isfinite(v), agg, 0.0).sum().backward()
    assert np.any(np.asarray(gv) % 1 != 0)          # halves: ties split
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(gv))
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(gp))


def test_soft_argmin_matches_jax_and_ignores_inf_cells():
    rng = np.random.default_rng(0)
    v = (rng.random((24, 32, D)) * 10).astype(np.float32)
    v[:, :4, 4:] = np.inf                   # invalid-disparity convention
    for tau in (0.7, 2.0):
        got = soft_argmin(torch.from_numpy(v), tau).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_soft_argmin(v, tau)),
                                   rtol=0, atol=1e-5)
    # Distinct values: low temperature gives the hard argmin; the +inf
    # cells carry no weight.
    v = rng.permutation(24 * 32 * D).reshape(24, 32, D).astype(np.float32)
    v[:, :4, 4:] = np.inf
    soft = soft_argmin(torch.from_numpy(v), 1e-2).numpy()
    np.testing.assert_array_equal(np.round(soft).astype(np.int64),
                                  np.argmin(v, axis=2))
    assert np.all(soft[:, :4] <= 3 + 1e-3)


def test_soft_argmin_gradient_matches_jax():
    rng = np.random.default_rng(2)
    v = (rng.random((8, 10, D)) * 4).astype(np.float32)
    v[:, :2, 2:] = np.inf
    w = rng.random((8, 10)).astype(np.float32)
    gv = np.asarray(jax.grad(
        lambda x: jnp.sum(jax_soft_argmin(x, 0.5) * w))(jnp.asarray(v)))
    t = torch.from_numpy(v).requires_grad_(True)
    (soft_argmin(t, 0.5) * torch.from_numpy(w)).sum().backward()
    assert np.all(t.grad.numpy()[:, :2, 2:] == 0)
    np.testing.assert_allclose(t.grad.numpy(), gv, rtol=0,
                               atol=1e-5 * np.abs(gv).max())
