"""Faults of the census + SGM configurations, planted under a run as
``portbench/faults.py`` plants its own: options that break the program
as the configuration runs it, or an estimator whose answers are the
plain reference's with the fault.  ``portbench/census_control.py``
reads them on the card at a cell's own size,
``portbench/tests/test_portbench_census_sgm.py`` at a small size on the
CPU.  Benchmark runs never plant them.

* ``window_9x9``: the census window 9 rows tall where it is 7;
* ``window_7x7``: the census window 7 columns wide where it is 9;
* ``p2_adaptive``: the adaptive P2' = max(P1, P2 / |dI|) where P2 is
  constant;
* ``path_left_out``: the SGM's last path left out (the plain reference,
  with seven paths, in the program's place);
* ``p1_ignored``: the program run with P1 = 0.

Every other name is ``faults.py``'s (``stale``, ``half_batch``,
``altered``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from stereomatch_tpu_torch.stream import StreamingEstimator

from . import faults
from .reference import census_sgm, stereo


def reference_in_place(config: dict, **sgm) -> type:
    """An estimator whose answers are those of ``census_sgm`` for
    ``config`` with ``stereo.semiglobal(**sgm)``: the stream runs as it
    does, and each batch's answers are replaced where they are
    produced."""
    import torch

    class ReferenceInPlace(StreamingEstimator):
        def _run_batch(self, left, right):
            out = super()._run_batch(left, right)
            with torch.no_grad():
                answer = census_sgm.disparity(
                    config, left.to(torch.float32),
                    right.to(torch.float32), **sgm)
            return answer.to(out.dtype)

    return ReferenceInPlace


CENSUS_SGM = ("window_9x9", "window_7x7", "p2_adaptive", "path_left_out",
              "p1_ignored")


def planted(name: str, config: dict
            ) -> Tuple[Optional[dict], Optional[Callable]]:
    """(overrides, estimator_cls) of fault ``name`` for ``config``."""
    census = {
        "window_9x9": lambda: ({"census_height": 9}, None),
        "window_7x7": lambda: ({"census_window": 7}, None),
        "p2_adaptive": lambda: ({"adaptive_p2": True}, None),
        "path_left_out": lambda: (None, reference_in_place(
            config, paths=stereo.PATHS[:-1])),
        "p1_ignored": lambda: ({"penalty1": 0.0}, None),
    }
    if name in census:
        return census[name]()
    return faults.planted(name, config)
