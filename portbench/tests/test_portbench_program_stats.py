"""The metrics that read the program's own counters of the window's run
(``stereomatch_tpu_torch.stream.LAST_STATS``): each gives None where the
last run is not the window's (its frame count differs from the
record's) or where the program has no such counter, and the right value
on synthetic stats."""

import dataclasses

import pytest

from portbench import registry
from stereomatch_tpu_torch import stream
from stereomatch_tpu_torch.stream import StreamStats

BENCH = registry.load_benchmark()
NEW = ("cost_window_ms", "aggregation_window_ms", "reduce_window_ms",
       "program_ops_per_frame", "program_ops_per_frame.live",
       "stream_stage_ms.live", "stream_handoff_ms.live")


def _stats(**over):
    stats = StreamStats(frames=40, batches=5, seconds=1.0, decode_s=0.01,
                        dispatch_s=0.02, fetch_s=0.5, stage_s=0.004,
                        handoff_s=0.006, frames_run=40, device_ops=590,
                        stamps=96, frames_stamped=24)
    stats.stage_device_s.update(cost=24 * 0.085e-3,
                                aggregation=24 * 0.995e-3,
                                reduce=24 * 0.093e-3)
    return dataclasses.replace(stats, **over) if over else stats


# The value each reads from _stats(), and the frames of a window.
WANT = {"cost_window_ms": 0.085, "aggregation_window_ms": 0.995,
        "reduce_window_ms": 0.093, "program_ops_per_frame": 590 / 40,
        "program_ops_per_frame.live": 590 / 40,
        "stream_stage_ms.live": 0.004 / 40 * 1e3,
        "stream_handoff_ms.live": 0.006 / 40 * 1e3}


def _record(frames=40):
    return {"read_t": [0.0] * frames, "yield_t": [0.0] * frames}


@pytest.fixture
def last(monkeypatch):
    def put(stats):
        monkeypatch.setattr(stream, "LAST_STATS", stats)
    return put


def test_every_new_metric_is_entered_with_its_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        entry = entries[name]
        assert entry["source"] == "program_counter"
        live = name.endswith(".live")
        assert entry["workloads"] == (["teddy-ssd-sgm.live1"] if live
                                      else ["teddy-ssd-sgm.stream8"])
        assert entry["moves"] == ("latency_p50_ms.live" if live else "fps")


@pytest.mark.parametrize("name", NEW)
def test_reads_the_window_run(last, name):
    last(_stats())
    value = registry.metric_reader(name)(_record())
    assert value == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_last_run_is_not_the_window(last, name):
    last(_stats())
    assert registry.metric_reader(name)(_record(frames=39)) is None
    assert registry.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_program_has_no_counters(last, name):
    last(None)
    assert registry.metric_reader(name)(_record()) is None


@pytest.mark.parametrize("name", NEW)
def test_none_on_a_program_older_than_the_counters(last, name):
    """A program whose stats lack the new counters: nothing read, nothing
    raised."""

    @dataclasses.dataclass
    class Older:
        frames: int = 40
        frames_run: int = 40

    last(Older())
    assert registry.metric_reader(name)(_record()) is None


@pytest.mark.parametrize("name,over", [
    ("cost_window_ms", {"frames_stamped": 0}),
    ("aggregation_window_ms", {"frames_stamped": 0}),
    ("reduce_window_ms", {"frames_stamped": 0}),
    ("program_ops_per_frame", {"device_ops": None}),
    ("program_ops_per_frame", {"frames_run": 0}),
    ("stream_stage_ms.live", {"frames": 0}),
])
def test_none_where_nothing_was_counted(last, name, over):
    last(_stats(**over))
    frames = over.get("frames", 40)
    assert registry.metric_reader(name)(_record(frames)) is None
