"""The lower-precision control fails the check at the cells' own size.

The control is the program with the configuration's ``control``
options: its own bf16 path (volumes stored in bfloat16) in the float32
configuration's place, judged against the float32 reference.  On the
card this runs each cell at its own size and load;
``portbench/control.py`` takes the readings the limits were set from.
"""

import time

import pytest
import torch

from portbench import registry, run


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.load_benchmark()["workloads"]])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_the_bf16_control_is_not_correct(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size on the card")
    cell = registry.find_cell(name)
    _, checks, _ = run.measure(cell, seed, 2.0, False,
                               torch.device("cuda", 0), time.perf_counter(),
                               overrides=cell.config["control"])
    worst = next(c for c in checks if c.name == "mismatch_worst")
    assert not worst.ok, checks
