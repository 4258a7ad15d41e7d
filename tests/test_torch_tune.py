"""The port's penalty tuning (``stereomatch_tpu_torch/tune.py``) against
the JAX package's ``tune.py``, on the CPU.

The optimiser arithmetic is bit-equal: an ``optax.adam`` update for 60
steps (XLA folds its first bias correction into the denominator and
contracts the moments and the parameter update into fused multiply-adds;
the port computes that form), ``optax.huber_loss`` and
``jax.nn.softplus`` (``logaddexp(x, 0)`` on XLA's CPU polynomials for
``exp`` and ``log1p``) with its derivative.  A whole ``tune_penalties``
run is held within 2e-5 relative on its loss and penalty histories
(measured 3.5e-7 and 9.1e-7 at 32x64, D=16, 2 scenes, 40 steps): the
soft-argmin and the loss sums run in torch's order.  And the JAX
package's claim holds on the port: tuning improves the hard census
pipeline on a training and a held-out scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereomatch_tpu import tune as jax_tune
from stereomatch_tpu_torch import cli_common, convert, tune

from .conftest import synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = 16
HISTORY_RTOL = 2e-5


@pytest.mark.parametrize("lr", [0.05, 0.1])
def test_adam_steps_bit_equal_to_optax(lr):
    rng = np.random.default_rng(0)
    n = 4096
    grads = [rng.normal(0, 10.0 ** rng.uniform(-4, 2), n).astype(np.float32)
             for _ in range(60)]
    theta0 = rng.normal(0, 1, n).astype(np.float32)
    opt = optax.adam(lr)

    @jax.jit
    def update(theta, state, g):
        updates, state = opt.update(g, state, theta)
        return optax.apply_updates(theta, updates), state

    want_theta, state = jnp.asarray(theta0), opt.init(jnp.asarray(theta0))
    theta = torch.from_numpy(theta0.copy())
    port_state = tune.adam_init(theta)
    for g in grads:
        want_theta, state = update(want_theta, state, jnp.asarray(g))
        theta, port_state = tune.adam_step(theta, torch.from_numpy(g),
                                           port_state, learning_rate=lr)
        np.testing.assert_array_equal(theta.numpy(), np.asarray(want_theta))
    np.testing.assert_array_equal(port_state.mu.numpy(),
                                  np.asarray(state[0].mu))
    np.testing.assert_array_equal(port_state.nu.numpy(),
                                  np.asarray(state[0].nu))


@pytest.mark.parametrize("delta", [1.0, 0.75, 2.5])
def test_huber_loss_bit_equal_to_optax(delta):
    e = np.random.default_rng(1).normal(0, 2, 100000).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: optax.huber_loss(x, delta=delta))(e))
    np.testing.assert_array_equal(
        tune.huber_loss(torch.from_numpy(e), delta=delta).numpy(), want)


def test_softplus_and_its_gradient_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0, 3, 100000), rng.normal(0, 30, 1000),
                        np.linspace(-30, 30, 10001),
                        [0.0, 19.9, 20.0, 20.1, 88.0, -88.0]]
                       ).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    out = tune.softplus(t)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax.nn.softplus(x)))
    out.sum().backward()
    want = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(x))
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_softplus_inv_round_trips():
    """The starting point: softplus(softplus_inv(y)) is y, on both sides
    of the linear cut at 20."""
    for y in (0.1, 0.2, 3.0, 19.5, 25.0):
        theta = torch.tensor([tune.softplus_inv(y)], dtype=torch.float32)
        assert tune.softplus(theta).item() == pytest.approx(y, rel=1e-6)


@pytest.fixture(scope="module")
def train():
    return [synthetic_stereo_pair(32, 64, D, seed=s) for s in (7, 8)]


def test_tune_penalties_histories_match_jax(train):
    kw = dict(max_disparity=D, cost="census", steps=40, tau=0.5,
              learning_rate=0.1)
    want = jax_tune.tune_penalties(train, **kw)
    got = tune.tune_penalties(train, device="cpu", **kw)
    assert got.penalty_history.shape == (40, 2)
    assert got.loss_history.dtype == np.float32
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=HISTORY_RTOL)
    np.testing.assert_allclose(got.penalty_history, want.penalty_history,
                               rtol=HISTORY_RTOL)
    assert got.penalty1 == pytest.approx(want.penalty1, rel=HISTORY_RTOL)
    assert got.penalty2 == pytest.approx(want.penalty2, rel=HISTORY_RTOL)
    carried = convert.tune_result_from_jax(want)
    assert carried.penalty1 == want.penalty1
    np.testing.assert_array_equal(carried.loss_history, want.loss_history)


@pytest.mark.parametrize("cost", ["ssd", "sad", "ncc", "birchfield"])
def test_other_cost_families_and_masks_match_jax(train, cost):
    """Every cost the tuner builds, with explicit masks, 3 steps."""
    masks = np.zeros((2, 32, 64), bool)
    masks[:, 4:, D + 3:] = True
    kw = dict(max_disparity=D, cost=cost, steps=3, tau=1.0,
              valid_masks=masks)
    want = jax_tune.tune_penalties(train, **kw)
    got = tune.tune_penalties(train, device="cpu", **kw)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=HISTORY_RTOL)
    np.testing.assert_allclose(got.penalty_history, want.penalty_history,
                               rtol=HISTORY_RTOL)


def test_tune_census_improves_hard_pipeline(train):
    """The JAX package's claim, on the port: descending the soft loss
    improves the hard WTA pipeline on a training and a held-out scene."""
    res = tune.tune_penalties(train, max_disparity=D, cost="census",
                              steps=40, tau=0.5, learning_rate=0.1,
                              device="cpu")
    assert res.penalty1 > 0 and res.penalty2 > 0
    assert res.loss_history[-1] < res.loss_history[0]

    def bad(p1, p2, scene):
        left, right, gt = scene
        pipe = cli_common.create_pipeline("census", "wta", "sgm",
                                          max_disparity=D, penalty1=p1,
                                          penalty2=p2, device="cpu")
        d = pipe.estimate(left, right).numpy()
        return np.mean((np.abs(d - gt) > 1)[:, D:])

    held_out = synthetic_stereo_pair(32, 64, D, seed=99)
    for scene in (train[0], held_out):
        assert bad(res.penalty1, res.penalty2, scene) < bad(0.1, 0.2, scene)


def test_unknown_cost_refused(train):
    with pytest.raises(ValueError, match="unknown cost"):
        tune.tune_penalties(train, max_disparity=D, cost="sobel", steps=1,
                            device="cpu")
