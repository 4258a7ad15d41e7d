"""What the harness and the reference load, compared by whole
top-level module names (``stereomatch_tpu_torch`` begins with
``stereomatch_tpu``), and the run's refusal without a card."""

import json
import subprocess
import sys

import pytest

from portbench.registry import ROOT

BANNED = {"jax", "jaxlib", "flax", "stereomatch_tpu"}

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def loaded(body: str):
    out = subprocess.run([sys.executable, "-c",
                          LOADED.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    names = loaded("from portbench import reference, check, scenes\n"
                   "import torch\n"
                   "print(reference.disparity)")
    assert not names & (BANNED | {"stereomatch_tpu_torch"})


def test_a_run_loads_no_jax_and_no_jax_package():
    # A whole run at a tiny size on the CPU: set-up, window, check, the
    # metric readers.
    body = """
import time
from portbench import registry, run
cell = registry.find_cell("teddy-ssd-sgm.stream8")
cell = cell._replace(config=dict(cell.config, height=24, width=40,
                                 max_disparity=8),
                     traffic=dict(cell.traffic, pool=2, batch=2))
record, checks, result = run.measure(cell, 9, 1.0, False, "cpu",
                                     time.perf_counter(), frames=4)
assert all(c.ok for c in checks), checks
registry.read_metrics(cell.end_to_end + cell.per_layer, record)
assert run.banned_modules() == [], run.banned_modules()
"""
    names = loaded(body)
    assert "stereomatch_tpu_torch" in names
    assert not names & BANNED


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "stereomatch_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "teddy-ssd-sgm.stream8", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "needs 1 CUDA device" in out.stderr
