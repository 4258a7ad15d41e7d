"""The device half of the port's tracing, on the card: stage stamps in a
CUDA graph, graph node counts and the stream's device-operation count.

Marked ``cuda``: each test needs an NVIDIA GPU and nvcc and skips, with
its reason, where there is none.  On the card:

    python -m pytest tests/test_torch_trace_cuda.py -q

* The stamped graph's disparities are bit-equal to the plain graph's
  and to the eager frame's at teddy (375x450, D = 128, SSD + SGM + WTA);
  it holds the plain graph's nodes and four stamps.
* With no profiler recording the plain graph replays: as many device
  operations as an eager frame, the eager frame's kernel launches, and
  no stamp in ``_build.LAUNCHES`` or in the ring.
* Over one stream8 batch and one live frame, the graph nodes plus the
  stream's own enqueues plus the stamps equal the profiler's count of
  device operations, and the three stage times sum to no more than the
  device's busy time.
* Eager (post-processed) frames stamp directly, and leave
  ``device_ops`` None; their stage times hold the host's launch gaps.

This file imports nothing of JAX.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import _build
from stereomatch_tpu_torch.stream import StreamingEstimator
from stereomatch_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

H, W, D = 375, 450, 128


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _frames(n, seed0=70):
    """n different side-by-side teddy-size uint8 frames."""
    out = []
    for i in range(n):
        left, right, _ = stereo_pair(H, W, D, seed=seed0 + i)
        out.append(np.concatenate([(left * 255).astype(np.uint8),
                                   (right * 255).astype(np.uint8)], axis=1))
    return out


def _pair(frame, device):
    return (torch.from_numpy(frame[:, :W]).to(device).float(),
            torch.from_numpy(frame[:, W:]).to(device).float())


def _device_events(prof):
    """The profiler's device operations: kernels, copies and sets."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _busy_s(events):
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy * 1e-6


def _profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def test_stamped_graph_equals_the_plain_graph_at_teddy(device):
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=D)
    pairs = [_pair(f, device) for f in _frames(2)]
    want = [pipe.estimate(*p).clone() for p in pairs]
    fn = pipe.compiled()
    plain = [fn(*p) for p in pairs]
    stamped, _ = _profiled(lambda: [fn(*p) for p in pairs])
    torch.cuda.synchronize()
    for a, b, c in zip(want, plain, stamped):
        assert torch.equal(a, b) and torch.equal(b, c)
    (key,) = fn.graphs
    graph, with_stamps = fn.graphs[key], fn.stamped[key]
    assert (graph.stamps, with_stamps.stamps) == (0, 4)
    assert with_stamps.nodes - graph.nodes == collections.Counter(kernel=4)
    assert with_stamps.launches == graph.launches
    assert with_stamps.device_ops == graph.device_ops


def test_plain_graph_replays_with_the_profiler_off(device, monkeypatch):
    counter = collections.Counter()
    monkeypatch.setattr(_build, "LAUNCHES", counter)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=D)
    pair = _pair(_frames(1)[0], device)
    pipe.estimate(*pair)
    eager_launches = collections.Counter(counter)
    with profiling.stamping(False):
        _, prof = _profiled(lambda: pipe.estimate(*pair))
    eager_ops = len(_device_events(prof))
    fn = pipe.compiled()
    fn(*pair)
    _profiled(lambda: fn(*pair))                 # captures the stamped one
    ring = profiling.stamp_ring(device)
    enqueued, ops = ring.enqueued, fn.device_ops
    counter.clear()
    for _ in range(3):
        fn(*pair)
    torch.cuda.synchronize()
    (graph,) = fn.graphs.values()
    assert graph.stamps == 0 and graph.launches == eager_launches
    assert graph.device_ops == eager_ops
    assert graph.nodes["other"] == 0
    assert ring.enqueued == enqueued             # no stamp replayed
    assert fn.device_ops - ops == 3 * (eager_ops + 2 + 1)
    assert counter == collections.Counter()      # a replay launches nothing
    assert not any(name.startswith("stm_stamp") for name in _build.LAUNCHES)


@pytest.mark.parametrize("batch,depth", [(8, 2), (1, 1)],
                         ids=["stream8", "live1"])
def test_stream_counts_every_device_operation(device, batch, depth):
    est = StreamingEstimator(D, batch=batch, depth=depth)
    frames = _frames(batch)
    list(est.run(ImageSequenceCapture(frames)))          # the plain graph
    _profiled(lambda: list(est.run(ImageSequenceCapture(frames))))
    outs, prof = _profiled(
        lambda: list(est.run(ImageSequenceCapture(frames))))
    st = est.stats
    events = _device_events(prof)
    assert st.frames_run == batch and st.frames_stamped == batch
    assert st.stamps == 4 * batch
    # The graph's nodes, the copies around each replay, and the batch's
    # uploads, widenings, narrowing and copy to the host.
    (graph,) = est._compiled.graphs.values()
    assert st.device_ops == batch * (graph.device_ops + 3) + 6
    assert st.device_ops + st.stamps == len(events)
    stages = st.stage_device_s
    assert all(v > 0 for v in stages.values())
    assert sum(stages.values()) <= _busy_s(events)
    plain = [d for _, d in StreamingEstimator(D, batch=batch, depth=depth)
             .run(ImageSequenceCapture(frames))]
    for (_, got), want in zip(outs, plain):
        np.testing.assert_array_equal(got, want)


def test_eager_frames_stamp_directly(device):
    """An eager frame's stages also hold the host's gaps between its
    launches: their sum lies inside the device operations' span, not
    inside their busy time."""
    est = StreamingEstimator(D, batch=2, depth=1, median=True)
    frames = _frames(2)
    list(est.run(ImageSequenceCapture(frames)))
    _, prof = _profiled(lambda: list(est.run(ImageSequenceCapture(frames))))
    st = est.stats
    assert st.device_ops is None
    assert st.frames_stamped == st.frames_run == 2 and st.stamps == 8
    assert all(v > 0 for v in st.stage_device_s.values())
    events = _device_events(prof)
    span_s = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) * 1e-6
    assert sum(st.stage_device_s.values()) <= span_s
