"""The port's spans, stage stamps and stream counters, on the CPU.

* With no profiler recording, ``profiling.annotate`` and
  ``profiling.stage`` enter no ``record_function``: a span is one check
  of the profiler's flag (a monkeypatched ``record_function`` counts
  every call, from a pipeline frame and a whole ``StreamingEstimator``
  run too).
* Under ``torch.profiler`` a CPU ``StreamingEstimator.run`` shows every
  ``stm/stream/*`` span; each batch's spans carry its index as their
  args, and no span is still open on the thread that yields when a
  frame is yielded.
* ``StreamStats``: ``stage_s <= dispatch_s``, ``handoff_s <= fetch_s``,
  ``device_ops`` None after eager frames, ``LAST_STATS`` the last run's
  stats (also after the estimator is gone, and after an abandoned run),
  and ``stage_ms_per_frame`` keeps the JAX package's keys.
* The host half of the stamps: ``stage_seconds`` parses a ring's
  records (complete frames only, with and without aggregation), and
  ``StampRing.read`` finds slots across the ring's wrap and refuses
  overwritten ones.  The device half is ``tests/test_torch_trace_cuda.py``.
"""

import collections
import contextlib
import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereomatch_tpu_torch import stream as stream_mod
from stereomatch_tpu_torch.cli_common import create_pipeline
from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.pipeline import _Graph
from stereomatch_tpu_torch.stream import StreamingEstimator, StreamStats
from stereomatch_tpu_torch.utils import profiling

from .torch_threads import one_torch_thread  # noqa: F401

D = 16
STREAM_SPANS = ("stm/stream/read", "stm/stream/stage", "stm/stream/upload",
                "stm/stream/frames", "stm/stream/fetch", "stm/stream/wait",
                "stm/stream/sync")
# The spans a batch opens once each (read opens once a frame).
BATCH_SPANS = STREAM_SPANS[1:]


def _frames(n, h=24, w=32):
    out = []
    for i in range(n):
        left, right, _ = stereo_pair(h, w, D, seed=40 + i)
        out.append(np.concatenate([left, right], axis=1).astype(np.uint8))
    return out


class _Spy:
    """``torch.profiler.record_function`` that logs (name, args, thread)
    of each span and how many spans each thread has open."""

    def __init__(self, real):
        self.real = real
        self.calls = []
        self.open = collections.Counter()
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name, args=None):
        me = threading.get_ident()
        with self.lock:
            self.calls.append((name, args, me))
            self.open[me] += 1
        try:
            with self.real(name, args):
                yield
        finally:
            with self.lock:
                self.open[me] -= 1


@pytest.fixture
def spy(monkeypatch):
    spy = _Spy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return spy


# --------------------------------------------------------------------------
# Spans are free when nothing records
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_spans_enter_nothing_without_a_profiler(spy, device):
    assert not profiling.recording()
    with profiling.annotate("stm/x", batch=3):
        pass
    for name in profiling.STAGE_IDS:
        with profiling.stage(name, device):
            pass
    assert spy.calls == []
    assert profiling.annotate("stm/y") is profiling.annotate("stm/z", 1)


def test_pipeline_and_stream_enter_nothing_without_a_profiler(spy):
    left, right, _ = stereo_pair(24, 32, D, seed=2)
    create_pipeline("ssd", "wta", "sgm", max_disparity=D, kernel_size=3,
                    device="cpu").estimate(left, right)
    est = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu")
    assert len(list(est.run(ImageSequenceCapture(_frames(3))))) == 3
    assert spy.calls == []


def test_spans_enter_record_function_while_a_profiler_records(spy):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.annotate("stm/x", batch=3):
            pass
        with profiling.stage("cost", "cpu"):
            pass
    assert not profiling.recording()
    assert [(n, a) for n, a, _ in spy.calls] == [("stm/x", "3"),
                                                ("stm/cost", None)]
    assert {"stm/x", "stm/cost"} <= {e.name for e in prof.events()}


def test_stage_records_the_stage_a_pipeline_entered():
    pipe = create_pipeline("ssd", "wta", "sgm", max_disparity=D,
                           kernel_size=3, device="cpu")
    left, right, _ = stereo_pair(24, 32, D, seed=3)
    pipe.estimate(left, right)
    assert pipe._stage == profiling.last_stage() == "disparity_reduce"
    seen = []

    def cost(left_image, right_image):
        seen.append(pipe._stage)
        raise RuntimeError("stop")

    pipe.cost = cost
    with pytest.raises(RuntimeError, match="stop"):
        pipe.estimate(left, right)
    assert seen == ["cost"] and pipe._stage == "cost"


@pytest.mark.parametrize("on", [True, False])
def test_stamping_overrides_and_restores(on):
    assert getattr(profiling._LOCAL, "stamps", None) is None
    with profiling.stamping(on):
        assert profiling._LOCAL.stamps is on
        with profiling.stamping(not on):
            assert profiling._LOCAL.stamps is (not on)
        assert profiling._LOCAL.stamps is on
        # The CPU is never stamped.
        assert profiling._stamp_ring_for("cpu") is None
        assert profiling._stamp_ring_for(None) is None
    assert profiling._LOCAL.stamps is None


# --------------------------------------------------------------------------
# The stream's spans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,depth,n", [(2, 2, 7), (3, 1, 6), (1, 1, 3)])
def test_stream_spans_under_the_profiler(spy, batch, depth, n):
    est = StreamingEstimator(D, batch=batch, depth=depth, kernel_size=3,
                             device="cpu")
    main = threading.get_ident()
    open_at_yield = []
    # The fetch threads' spans show in a capture of every thread.
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=profiling.all_threads()) as prof:
        for _ in est.run(ImageSequenceCapture(_frames(n))):
            open_at_yield.append(spy.open[main])
    assert len(open_at_yield) == n and set(open_at_yield) == {0}
    assert set(STREAM_SPANS) <= {e.name for e in prof.events()}
    batches = est.stats.batches
    assert batches == -(-n // batch)
    by_name = collections.defaultdict(list)
    threads = collections.defaultdict(set)
    for name, args, thread in spy.calls:
        by_name[name].append(args)
        threads[name].add(thread)
    for name in BATCH_SPANS:
        assert sorted(by_name[name], key=int) == [
            str(b) for b in range(batches)], name
    # One read a frame, and the read that finds the capture's end (of the
    # batch it would have filled).
    assert by_name["stm/stream/read"] == [
        str(i // batch) for i in range(n + 1)]
    assert threads["stm/stream/sync"].isdisjoint({main})
    assert threads["stm/stream/wait"] == {main}


def test_stream_spans_of_an_abandoned_run_are_closed(spy):
    est = StreamingEstimator(D, batch=2, depth=2, kernel_size=3,
                             device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        frames = est.run(ImageSequenceCapture(_frames(6)))
        next(frames)
        frames.close()
    assert all(v == 0 for v in spy.open.values())
    assert stream_mod.LAST_STATS is est.stats
    assert est.stats.frames >= 1 and est.stats.seconds > 0


# --------------------------------------------------------------------------
# StreamStats
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,depth", [(2, 2), (3, 1), (1, 3)])
def test_stream_counters_nest(batch, depth):
    est = StreamingEstimator(D, batch=batch, depth=depth, kernel_size=3,
                             device="cpu")
    assert len(list(est.run(ImageSequenceCapture(_frames(5))))) == 5
    st = est.stats
    assert 0 < st.stage_s <= st.dispatch_s
    assert 0 <= st.handoff_s <= st.fetch_s
    assert st.decode_s + st.dispatch_s + st.fetch_s <= st.seconds
    # Eager frames (the CPU) leave the device count incomplete; nothing
    # is stamped off the card.
    assert st.device_ops is None
    assert (st.stamps, st.frames_stamped) == (0, 0)
    assert st.stage_device_s == {"cost": 0.0, "aggregation": 0.0,
                                 "reduce": 0.0}


def test_last_stats_is_the_last_run():
    first = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu")
    list(first.run(ImageSequenceCapture(_frames(3))))
    assert stream_mod.LAST_STATS is first.stats
    second = StreamingEstimator(D, batch=1, kernel_size=3, device="cpu")
    list(second.run(ImageSequenceCapture(_frames(2))))
    assert stream_mod.LAST_STATS is second.stats
    stats = second.stats
    del first, second
    gc.collect()
    assert stream_mod.LAST_STATS is stats and stats.frames == 2
    assert stats.frames_run == 2 and stats.batches == 2


def test_stage_split_keeps_its_keys():
    est = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu")
    list(est.run(ImageSequenceCapture(_frames(3))))
    assert set(est.stats.stage_ms_per_frame()) == {
        "decode", "dispatch", "fetch", "other", "total"}
    assert set(StreamStats().stage_ms_per_frame()) == {
        "decode", "dispatch", "fetch", "other", "total"}


def test_launches_count_as_before_on_the_cpu():
    """No kernel runs on the CPU: the eager frames add nothing."""
    est = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu")
    list(est.run(ImageSequenceCapture(_frames(3))))
    assert est.stats.launches == collections.Counter()
    assert est.stats.frames_run == 4


def test_graph_device_ops_leave_the_stamps_out():
    nodes = collections.Counter(kernel=15, memcpy=2, memset=1, other=3)
    graph = _Graph(None, None, None, None, collections.Counter(), 0, nodes, 4)
    assert graph.device_ops == 14
    plain = graph._replace(nodes=collections.Counter(kernel=11), stamps=0)
    assert plain.device_ops == 11


# --------------------------------------------------------------------------
# Stamp records back to stage times
# --------------------------------------------------------------------------


def _records(frames, first_slot=0):
    """Rows {slot, time ns, frame, stage} of ``frames``, each a list of
    (stage id, time) after its BEGIN time."""
    rows, slot = [], first_slot
    for number, (begin, stamps) in enumerate(frames, start=1):
        for stage_id, t in [(profiling.BEGIN, begin)] + stamps:
            rows.append((slot, t, number, stage_id))
            slot += 1
    return np.array(rows, dtype=np.uint64).reshape(-1, 4)


def test_stage_seconds_of_complete_frames():
    rows = _records([(1000, [(1, 1085), (2, 2085), (3, 2180)]),
                     (5000, [(1, 5100), (2, 6000), (3, 6090)])])
    seconds, frames = profiling.stage_seconds(rows)
    assert frames == 2
    assert seconds["cost"] == pytest.approx((85 + 100) * 1e-9)
    assert seconds["aggregation"] == pytest.approx((1000 + 900) * 1e-9)
    assert seconds["reduce"] == pytest.approx((95 + 90) * 1e-9)


def test_stage_seconds_without_aggregation():
    rows = _records([(0, [(1, 40), (3, 100)])])
    assert profiling.stage_seconds(rows) == (
        {"cost": pytest.approx(40e-9), "aggregation": 0.0,
         "reduce": pytest.approx(60e-9)}, 1)


def test_stage_seconds_leave_incomplete_frames_out():
    rows = _records([(0, [(1, 40), (2, 90)]),              # no reduce
                     (100, [(1, 150), (2, 400), (3, 450)])])
    seconds, frames = profiling.stage_seconds(rows)
    assert frames == 1
    assert seconds["aggregation"] == pytest.approx(250e-9)
    # A stamp of another frame number breaks the frame it lands in.
    mixed = rows.copy()
    mixed[-1, 2] = 99
    assert profiling.stage_seconds(mixed)[1] == 0
    assert profiling.stage_seconds(rows[:0])[1] == 0


def _host_ring(capacity=8):
    ring = object.__new__(profiling.StampRing)
    ring.CAPACITY = capacity
    ring._records = np.zeros((capacity, 4), dtype=np.uint64)
    return ring


def test_ring_reads_across_its_wrap():
    ring = _host_ring()
    rows = _records([(0, [(1, 40), (2, 90), (3, 95)]),
                     (100, [(1, 150), (2, 400), (3, 450)])], first_slot=5)
    for row in rows:
        ring._records[int(row[0]) % ring.CAPACITY] = row
    np.testing.assert_array_equal(ring.read(5, 13), rows)
    np.testing.assert_array_equal(ring.read(9, 13), rows[4:])
    assert ring.read(9, 9).shape == (0, 4)


def test_ring_refuses_slots_it_no_longer_holds():
    ring = _host_ring()
    rows = _records([(0, [(1, 40), (2, 90), (3, 95)])] * 3)   # slots 0-11
    for row in rows:
        ring._records[int(row[0]) % ring.CAPACITY] = row
    assert ring.read(0, 4) is None            # overwritten by slots 8-11
    assert ring.read(4, 12) is not None
    assert ring.read(0, 9) is None            # more than the ring holds
    assert ring.read(12, 13) is None          # not yet written
