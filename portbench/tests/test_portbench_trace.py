"""The profiler slice's reduction on hand-made events."""

import pytest

from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from portbench.trace import MARKER, Event, from_profiler, reduce_slice, union


def ev(name, start, end, device=False, thread=1, top=True):
    return Event(name, float(start), float(end), device, thread, top)


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_busy_idle_ops_and_gaps():
    events = [
        ev("portbench/slice", 100, 1100),
        # Device: two overlapping kernels, one clipped at the slice's
        # start, a copy; busy = (100-150) + (200-400) + (900-1000).
        ev("k_warm", 50, 150, device=True),
        ev("sgm", 200, 350, device=True),
        ev("sgm", 300, 400, device=True),
        ev("Memcpy DtoH", 900, 1000, device=True),
        # Host of the step's thread, and another thread's event.
        ev("cudaEventSynchronize", 400, 880),
        ev("aten::copy_", 880, 1100),
        ev("other thread", 150, 200, thread=2),
        ev("child", 410, 420, top=False),
    ]
    s = reduce_slice(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.device_ops == 4
    assert dict(s.ops_by_name) == pytest.approx(
        {"sgm": 250e-6, "Memcpy DtoH": 100e-6, "k_warm": 50e-6})
    # Gaps: 150-200 (no host event of the thread: python), 400-900
    # (mostly the event wait), 1000-1100 (the copy).
    assert dict(s.idle_gaps) == pytest.approx(
        {"cudaEventSynchronize": 500e-6, "aten::copy_": 100e-6,
         "python": 50e-6})


def test_no_step_or_no_device_event_gives_nothing():
    assert reduce_slice([ev("k", 0, 1, device=True)]) is None
    assert reduce_slice([ev("portbench/slice", 0, 10), ev("x", 1, 2)]) \
        is None


def test_device_annotations_are_no_device_operations():
    def fe(i, name, start, end, device=False, annotation=False):
        return FunctionEvent(i, name, thread=7, start_us=start, end_us=end,
                             device_type=(DeviceType.CUDA if device
                                          else DeviceType.CPU),
                             is_user_annotation=annotation)

    marker = fe(1, MARKER, 0, 100, annotation=True)
    child = fe(2, "aten::copy_", 10, 20)
    child.cpu_parent = marker
    events = from_profiler([
        marker, child, fe(3, MARKER, 5, 95, device=True, annotation=True),
        fe(4, "stm/aggregation", 5, 60, device=True, annotation=True),
        fe(5, "sgm_rows_kernel", 30, 60, device=True)])
    assert [(e.name, e.device, e.top_level) for e in events] == [
        (MARKER, False, True), ("aten::copy_", False, True),
        ("sgm_rows_kernel", True, True)]
    s = reduce_slice(events)
    assert s.busy_s == pytest.approx(30e-6) and s.device_ops == 1
