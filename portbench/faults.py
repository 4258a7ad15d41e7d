"""Faults planted under a run, to show that the check sees them.

Each fault is a pair (``overrides``, ``estimator_cls``) for
``run.measure``: options that break the program as the configuration
runs it, or an estimator whose batches come out wrong where they are
produced.  ``portbench/control.py`` reads them on the card at a cell's
own size; ``tests/test_portbench_faults.py`` at a small size on the CPU.
Benchmark runs never plant them.

* ``stale``: every batch after the first returns the first's answers
  (a step that returns its state unchanged);
* ``half_batch``: the second half of each batch is never computed;
* ``altered``: one row of one answer is altered where it is produced;
* ``p1_ignored``: the program run with P1 = 0;
* ``path_left_out``: the SGM's last path left out (the plain reference,
  with seven paths, in the program's place);
* ``p2_constant``: P2' = max(P1, P2) where the adaptive P2 divides by
  |dI| (the plain reference so changed, in the program's place).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from stereomatch_tpu_torch.stream import StreamingEstimator

from .reference import stereo


class Stale(StreamingEstimator):
    first = None

    def _run_batch(self, left, right):
        out = super()._run_batch(left, right)
        if self.first is None:
            self.first = out.clone()
        return self.first.clone()


class HalfBatch(StreamingEstimator):
    def _run_batch(self, left, right):
        out = super()._run_batch(left, right)
        out[(out.shape[0] + 1) // 2:] = 0
        return out


class Altered(StreamingEstimator):
    """Its third batch's first answer has one row altered."""

    def _run_batch(self, left, right):
        out = super()._run_batch(left, right)
        if self.stats.batches == 2:
            out[0, 3] = (out[0, 3] + 1) % self.max_disparity
        return out


def reference_in_place(config: dict, **sgm) -> type:
    """An estimator whose answers are the plain reference's for
    ``config`` with ``semiglobal(**sgm)``: the stream runs as it does,
    and each batch's answers are replaced where they are produced."""
    import torch

    class ReferenceInPlace(StreamingEstimator):
        def _run_batch(self, left, right):
            out = super()._run_batch(left, right)
            with torch.no_grad():
                answer = stereo.disparity(config, left.to(torch.float32),
                                          right.to(torch.float32), **sgm)
            return answer.to(out.dtype)

    return ReferenceInPlace


def planted(name: str, config: dict
            ) -> Tuple[Optional[dict], Optional[Callable]]:
    """(overrides, estimator_cls) of fault ``name`` for ``config``."""
    faults: Dict[str, Callable[[], tuple]] = {
        "stale": lambda: (None, Stale),
        "half_batch": lambda: (None, HalfBatch),
        "altered": lambda: (None, Altered),
        "p1_ignored": lambda: ({"penalty1": 0.0}, None),
        "path_left_out": lambda: (None, reference_in_place(
            config, paths=stereo.PATHS[:-1])),
        "p2_constant": lambda: (None, reference_in_place(
            config, adaptive=False)),
    }
    return faults[name]()


SGM = ("p1_ignored", "path_left_out", "p2_constant")
