"""Chain-difference timing, the counterpart of
``stereomatch_tpu/utils/benchmarking.py``.

The marginal cost of one iteration between two chain lengths, each
ending in one scalar fetched to the host:

    t_op = (t(chain_3k) - t(chain_k)) / 2k

cancels the constant costs of a call (the fetch, the host's launch
latency up to the first kernel) exactly.  On the card the n calls of a
chain are queued back to back and ``float()`` of the scalar waits for
them; on the CPU they run as they are called.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _leaves(tree) -> list:
    """The tensors of a nest of tuples, lists and dicts, in JAX's
    ``tree_leaves`` order (dict keys sorted; None holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [torch.as_tensor(tree)]


def chain_runner(body_fn: Callable):
    """Wrap ``body_fn(carry) -> carry`` into ``run(args, n)``: n chained
    calls, then the sum of every leaf of the result in float32, a 0-d
    tensor on the leaves' device."""

    def run(args, n):
        out = args
        for _ in range(n):
            out = body_fn(out)
        return sum(torch.sum(leaf.to(torch.float32))
                   for leaf in _leaves(out))

    return run


def best_of(run, args, n, repeats: int) -> float:
    """The least wall time, in seconds, of ``repeats`` calls of
    ``run(args, n)``, each waited for by fetching its scalar."""
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        float(run(args, n))
        best = min(best, time.perf_counter() - start)
    return best


def marginal_ms(body_fn: Callable, args, chain_k: int = 8,
                repeats: int = 5) -> float:
    """Marginal per-iteration milliseconds of ``body_fn`` (see module
    doc); one call first, to build what the chain launches."""
    run = chain_runner(body_fn)
    float(run(args, 1))
    ta = best_of(run, args, chain_k, repeats)
    tb = best_of(run, args, 3 * chain_k, repeats)
    return max(tb - ta, 0.0) / (2 * chain_k) * 1e3
