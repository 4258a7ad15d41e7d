"""The rate and percentile arithmetic on synthetic timestamps."""

import statistics

import numpy as np
import pytest

from portbench import registry, stats

CELL = registry.find_cell("teddy-ssd-sgm.stream8")
READ = {m.name: m.read for m in CELL.end_to_end}


def steady(n, period, latency, stall_at=None, stall=0.0):
    """Frames handed over every ``period`` s, each back ``latency`` s
    later; a stall of ``stall`` s before frame ``stall_at`` delays it and
    every later frame."""
    read_t, yield_t, t = [], [], 100.0
    for i in range(n):
        if i == stall_at:
            t += stall
        read_t.append(t)
        yield_t.append(t + latency)
        t += period
    return {"read_t": read_t, "yield_t": yield_t, "setup_s": 7.5}


def test_steady_window():
    record = steady(1000, 0.001, 0.004)
    assert READ["fps"](record) == pytest.approx(1000 / (0.999 + 0.004))
    assert READ["latency_p50_ms"](record) == pytest.approx(4.0)
    assert READ["latency_p95_ms"](record) == pytest.approx(4.0)
    assert READ["setup_s"](record) == 7.5


def test_a_stall_moves_fps_and_the_tail():
    calm = steady(1000, 0.001, 0.004)
    # A 0.5 s stall: the frames behind it wait in the capture, and 60 of
    # them come back late (their latency takes the stall's remainder).
    stalled = steady(1000, 0.001, 0.004, stall_at=500, stall=0.5)
    for i in range(500, 560):
        stalled["yield_t"][i] += 0.5 - (i - 500) * 0.008
    assert READ["fps"](stalled) < 0.7 * READ["fps"](calm)
    assert READ["latency_p50_ms"](stalled) == pytest.approx(4.0)
    assert READ["latency_p95_ms"](stalled) > 100.0


def test_percentile_matches_numpy():
    rng = np.random.default_rng(5)
    values = list(rng.exponential(3.0, 997))
    for q in (0, 5, 50, 95, 99, 100):
        assert stats.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)))


def test_latency_counts_only_frames_that_came_back():
    assert stats.latencies_ms([1.0, 2.0, 3.0], [1.5, 2.25]) == [500.0, 250.0]
    assert READ["latency_p95_ms"]({"read_t": [], "yield_t": []}) is None
    assert READ["fps"]({"read_t": [1.0], "yield_t": []}) is None


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)
