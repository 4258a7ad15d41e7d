"""The port's chain-difference timing (``utils/benchmarking.py``)
against the JAX package's: the same chained body, seeded, gives the
same scalar (within 1e-6 relative: XLA fuses and sums in its own
order), and the marginal time is a finite, non-negative number."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.utils import benchmarking as jax_benchmarking
from stereomatch_tpu_torch.utils import benchmarking

RTOL = 1e-6


def _args(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.random((16, 24), np.float32),
            rng.random((7,), np.float32),
            {"b": rng.integers(0, 9, (5,), dtype=np.int32),
             "a": rng.random((3, 3), np.float32)})


def _body(carry):
    """The same elementwise body for torch tensors and JAX arrays."""
    x, y, nest = carry
    return (x * 0.75 + y.sum() * 0.01, y * 0.5 + 0.25,
            {"a": nest["a"] * 0.9, "b": nest["b"] + 1})


def _as_torch(args):
    x, y, nest = args
    return (torch.from_numpy(x), torch.from_numpy(y),
            {key: torch.from_numpy(value) for key, value in nest.items()})


def _as_jax(args):
    x, y, nest = args
    return (jnp.asarray(x), jnp.asarray(y),
            {key: jnp.asarray(value) for key, value in nest.items()})


@pytest.mark.parametrize("n", [1, 8, 24])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_runner_scalar_equals_jax(n, seed):
    """n chained calls of one seeded elementwise body, every leaf of the
    nest (dict keys in sorted order, the int32 leaf included) summed in
    float32: the port's scalar is JAX's."""
    args = _args(seed)
    got = benchmarking.chain_runner(_body)(_as_torch(args), n)
    want = jax_benchmarking.chain_runner(_body)(_as_jax(args), n)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_leaves_follow_jax_tree_order():
    """Leaves in JAX's order: sequences in order, dict keys sorted, None
    skipped, Python numbers as 0-d tensors."""
    a, b, c = torch.zeros(1), torch.ones(2), torch.full((3,), 2.0)
    leaves = benchmarking._leaves({"z": a, "m": [b, None], "a": (c, 4.0)})
    assert [tuple(x.shape) for x in leaves] == [(3,), (), (2,), (1,)]
    assert float(leaves[1]) == 4.0


def test_best_of_and_marginal_ms():
    """best_of is the least of its repeats, a positive wall time;
    marginal_ms = (t(3k) - t(k)) / 2k is finite and at least 0."""
    args = _as_torch(_args(2))
    run = benchmarking.chain_runner(_body)
    best = benchmarking.best_of(run, args, 4, repeats=3)
    assert math.isfinite(best) and best > 0
    ms = benchmarking.marginal_ms(_body, args, chain_k=4, repeats=3)
    assert math.isfinite(ms) and ms >= 0
