"""A run with the timed path broken underneath comes out not correct.

Each fault of ``portbench/faults.py`` is planted under the program, and
the rest of a run is driven on the CPU at a small size, past the
harness's look for a card: set-up, warm-up, window, check.  The cells
have no exchange between chips and no training step, so the faults
they can have are: an answer that repeats an earlier one (the state
left unchanged), half of a batch left out, an answer altered, and the
SGM's faults (P1 ignored, a path left out, a constant P2).
"""

import time

import pytest

from portbench import faults, registry, run
from stereomatch_tpu_torch.stream import StreamingEstimator

WINDOW = 12           # frames; every one is kept and judged


def small_cell(name):
    cell = registry.find_cell(name)
    return cell._replace(
        config=dict(cell.config, height=24, width=48, max_disparity=16),
        traffic=dict(cell.traffic, pool=6,
                     batch=min(int(cell.traffic["batch"]), 4)))


def measure(cell, overrides=None, estimator_cls=None, seed=2 ** 31 + 99):
    return run.measure(cell, seed, 60.0, False, "cpu", time.perf_counter(),
                       frames=WINDOW, overrides=overrides,
                       estimator_cls=estimator_cls)


CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
FAULTS = ["stale", "half_batch", "altered", *faults.SGM]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    record, checks, result = measure(small_cell(name))
    assert all(c.ok for c in checks), checks
    assert result["attempted"] == WINDOW and result["failed"] == 0
    assert len(record["mismatch_shares"]) == WINDOW


# A batch of one has no half to leave out.
PAIRS = [(name, fault) for name in CELLS for fault in FAULTS
         if fault != "half_batch" or small_cell(name).traffic["batch"] > 1]


@pytest.mark.parametrize("name, fault", PAIRS)
def test_a_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    record, checks, result = measure(cell,
                                     *faults.planted(fault, cell.config))
    worst = next(c for c in checks if c.name == "mismatch_worst")
    assert not worst.ok, (fault, checks)
    assert result["failed"] > 0


def test_the_reference_in_place_is_correct():
    # The faults planted in the reference's place differ from a sound
    # run only by the fault.
    cell = small_cell(CELLS[0])
    _, checks, _ = measure(cell, estimator_cls=faults.reference_in_place(
        cell.config))
    assert all(c.ok for c in checks), checks


def test_lost_frames_are_not_correct():
    class Drops(StreamingEstimator):
        def run(self, capture, max_frames=None):
            for i, item in enumerate(super().run(capture, max_frames)):
                if i != 6:
                    yield item

    record, checks, result = measure(small_cell(CELLS[0]),
                                     estimator_cls=Drops)
    lost = next(c for c in checks if c.name == "frames_lost")
    assert lost.value > 0 and not lost.ok


def test_the_sample_holds_every_batch_slot():
    # A fault confined to one place in a batch is always in the sample.
    from portbench import scenes, window

    class Echo:
        def run(self, capture):
            while True:
                ok, pair = capture.read_next()
                if not ok:
                    return
                yield pair.left, None

    pool = scenes.pool(1, 4, 8, 16, 4)
    for batch in (1, 8):
        capture = window.PoolCapture(pool, batch, frames=800)
        kept = window.drive(Echo(), capture, 2 ** 31 + 5).kept
        per_slot = [sum(k.index % batch == s for k in kept)
                    for s in range(batch)]
        assert min(per_slot) >= window.PER_SLOT
        assert len(kept) >= window.SAMPLE
