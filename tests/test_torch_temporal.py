"""The port's video tracker (``stereomatch_tpu_torch/temporal.py``)
against the JAX package's ``temporal.py`` (``backend="xla"``), on the CPU.

Both run the same ``io.synthetic.stereo_sequence`` frames; every frame's
disparity must be equal bit for bit, and so must the ``keyframes`` and
``drift_keyframes`` counters after it: the cadence, the drift keyframe
after a reversed (garbage) pair, recovery after it, the keyframe a
change of geometry forces, ``reset`` and a pyramid keyframe.  The drift
fraction is held equal to JAX's float32 division, and the argument
errors are JAX's.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu.io.synthetic import stereo_sequence
from stereomatch_tpu import pyramid as jax_pyramid
from stereomatch_tpu import temporal as jax_temporal
from stereomatch_tpu_torch import convert, pyramid, temporal

from .torch_threads import one_torch_thread  # noqa: F401


def _pair(d, **kw):
    return (jax_temporal.TemporalPipeline(d, backend="xla", **kw),
            temporal.TemporalPipeline(d, device="cpu", **kw))


def _step(jax_pipe, pipe, left, right):
    want = np.asarray(jax_pipe.estimate(left, right))
    got = pipe.estimate(left, right)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert pipe.keyframes == jax_pipe.keyframes
    assert pipe.drift_keyframes == jax_pipe.drift_keyframes
    return got


@pytest.mark.parametrize("interval", [0, 2, 3])
def test_frames_and_cadence_equal_jax(interval):
    jax_pipe, pipe = _pair(16, keyframe_interval=interval)
    for left, right, _ in stereo_sequence(48, 64, 16, 5, seed=4, motion=1):
        _step(jax_pipe, pipe, left, right)
    assert pipe.keyframes == {0: 1, 2: 3, 3: 2}[interval]


def test_drift_keyframe_and_recovery_equal_jax():
    jax_pipe, pipe = _pair(32, keyframe_interval=0)
    a = stereo_sequence(64, 96, 32, 3, seed=3, motion=1)
    for left, right, _ in a:
        _step(jax_pipe, pipe, left, right)
    left, right, _ = a[-1]
    _step(jax_pipe, pipe, right, left)          # lose the track
    assert pipe.drift_keyframes == 1 and pipe.keyframes == 2
    for left, right, _ in stereo_sequence(64, 96, 32, 3, seed=21, motion=1):
        _step(jax_pipe, pipe, left, right)


def test_geometry_change_and_reset_equal_jax():
    jax_pipe, pipe = _pair(16, keyframe_interval=0)
    for left, right, _ in stereo_sequence(48, 64, 16, 2, seed=4):
        _step(jax_pipe, pipe, left, right)
    left, right, _ = stereo_sequence(32, 48, 16, 1, seed=4)[0]
    _step(jax_pipe, pipe, left, right)
    assert pipe.keyframes == 2
    jax_pipe.reset()
    pipe.reset()
    assert pipe._prev is None and pipe._frame_index == 0
    assert (pipe.keyframes, pipe.drift_keyframes) == (0, 0)
    _step(jax_pipe, pipe, left, right)
    assert pipe.keyframes == 1


def test_tracked_frame_is_band_refine_plus_median_and_its_fraction():
    from stereomatch_tpu_torch.ops.refine import median_filter_3x3
    frames = stereo_sequence(48, 64, 16, 2, seed=6, motion=1)
    pipe = temporal.TemporalPipeline(16, keyframe_interval=0, device="cpu")
    jax_pipe = jax_temporal.TemporalPipeline(16, keyframe_interval=0,
                                             backend="xla")
    (l0, r0, _), (l1, r1, _) = frames
    prev = pipe.estimate(l0, r0)
    got = pipe.estimate(l1, r1)
    want = median_filter_3x3(pyramid.band_refine_census(
        torch.from_numpy(l1), torch.from_numpy(r1), prev,
        band_radius=pipe.band_radius, max_disparity=16))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(pipe.host_disparity().numpy(), got.numpy())
    _, frac = pipe._track(torch.from_numpy(l1), torch.from_numpy(r1), prev)
    jax_pipe.estimate(l0, r0)
    _, want_frac = jax_pipe._track(l1, r1, np.asarray(prev))
    assert frac.dtype == torch.float32
    assert frac.item() == float(want_frac)
    _, frac = pipe._track(torch.from_numpy(r1), torch.from_numpy(l1), prev)
    _, want_frac = jax_pipe._track(r1, l1, np.asarray(prev))
    assert frac.item() == float(want_frac) > pipe.drift_threshold


def test_pyramid_keyframe_and_temporal_from_jax():
    kw = dict(keyframe_interval=3, band_radius=4, drift_threshold=0.2,
              poor_bits=6, median=False)
    jax_pipe = jax_temporal.TemporalPipeline(
        16, keyframe=jax_pyramid.PyramidPipeline(16, band_radius=4,
                                                 backend="xla"), **kw)
    pipe = convert.temporal_from_jax(jax_pipe, device="cpu")
    assert isinstance(pipe.keyframe, pyramid.PyramidPipeline)
    for name in ("max_disparity", "band_radius", "window_size",
                 "keyframe_interval", "drift_threshold", "poor_bits",
                 "median"):
        assert getattr(pipe, name) == getattr(jax_pipe, name), name
    for left, right, _ in stereo_sequence(32, 48, 16, 4, seed=2, motion=1):
        _step(jax_pipe, pipe, left, right)
    default = convert.temporal_from_jax(
        jax_temporal.TemporalPipeline(16, backend="xla"), device="cpu")
    assert default.poor_bits == 8
    assert default.keyframe.aggregation.penalty1 == 0.1


def test_validates_arguments_and_default_device():
    for kw in (dict(band_radius=0), dict(drift_threshold=0.0),
               dict(drift_threshold=1.5)):
        with pytest.raises(ValueError):
            jax_temporal.TemporalPipeline(16, **kw)
        with pytest.raises(ValueError):
            temporal.TemporalPipeline(16, device="cpu", **kw)
    pipe = temporal.TemporalPipeline(16)
    assert pipe.device == "cuda" and pipe.keyframe.device == "cuda"
    if not torch.cuda.is_available():
        left, right, _ = stereo_sequence(16, 32, 16, 1, seed=1)[0]
        with pytest.raises((RuntimeError, AssertionError)):
            pipe.estimate(left, right)
    with pytest.raises(RuntimeError):
        temporal.TemporalPipeline(16, device="cpu").host_disparity()
