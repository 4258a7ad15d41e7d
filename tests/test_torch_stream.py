"""The port's ``StreamingEstimator`` against the JAX package's, against its
own ``Pipeline.estimate_refined``, and its mechanics, on the CPU.

The same uint8 frames (seeded synthetic scenes, 24x32 and 32x48, D=16)
go through JAX's ``estimate_batch`` (``backend="xla"``) and the port's
(``device="cpu"``): integer disparities are held bit-equal; float ones
too (sub-pixel, background speckle fill), except the smoother, which
JAX's own stream is held to within 1e-3 of its pipeline
(``tests/test_stream.py``; XLA fuses the smoother's system otherwise
inside the ``lax.map`` program): the port is held to that too, and its
largest difference measured 5.5e-6 (the port's frame equals JAX's
``Pipeline.estimate_refined`` bit for bit).  JAX's ``run`` is fed
through its ``ImageSequenceCapture`` over in-memory frames, never
through its native library, whose in-place build races under several
test workers.
"""

import threading

import numpy as np
import pytest
import torch

from stereomatch_tpu.io.capture import \
    ImageSequenceCapture as JaxImageSequenceCapture
from stereomatch_tpu.stream import StreamingEstimator as JaxStreamingEstimator
from stereomatch_tpu_torch.cli_common import create_pipeline
from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
from stereomatch_tpu_torch.parallel import make_mesh
from stereomatch_tpu_torch.pipeline import host_array
from stereomatch_tpu_torch.stream import (StreamingEstimator, _widen_host,
                                          narrow_for_fetch)

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
FGS_ATOL = 1e-3


def _u8(image):
    return (image * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pair_stack():
    """Two different uint8 frames, [2, 24, 32] each side."""
    pairs = [synthetic_stereo_pair(24, 32, D, seed=s)[:2] for s in (9, 10)]
    return (np.stack([_u8(l) for l, _ in pairs]),
            np.stack([_u8(r) for _, r in pairs]))


@pytest.fixture(scope="module")
def sbs_frames():
    """Seven side-by-side [32, 96] uint8 frames, all different."""
    frames = []
    for i in range(7):
        left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3 + i)
        frames.append(np.concatenate([_u8(left), _u8(right)], axis=1))
    return frames


# (name, options): the JAX stream's options; the port takes the same but
# for the dtype's and backend's names.
CONFIGS = [
    ("ssd-sgm-wta", {}),
    ("sad-sgm-wta", dict(cost="sad")),
    ("census-sgm-wta", dict(cost="census")),
    ("ssd-none-wta", dict(aggregation=None)),
    ("census-cvf-wta", dict(cost="census", aggregation="cvf",
                            cvf_radius=3)),
    ("ssd-cvf-dyn", dict(aggregation="cvf", cvf_radius=3,
                         reducer="dynamic_programming")),
    ("ssd-sgm-dyn", dict(reducer="dynamic_programming")),
    ("sad-none-dyn", dict(cost="sad", aggregation=None,
                          reducer="dynamic_programming")),
    ("census-none-wta", dict(cost="census", aggregation=None)),
    ("ssd-sgm-wta-bf16", dict(cost_dtype="bfloat16")),
    ("lr-volume", dict(lr_check=True, lr_mode="volume")),
    ("lr-mirror", dict(lr_check=True, lr_mode="mirror")),
    ("wmf", dict(weighted_median=True, wmf_sigma=25.0)),
    ("median-subpixel", dict(median=True, subpixel=True)),
    ("speckle-zero", dict(speckle=True)),
    ("speckle-background", dict(speckle=True, speckle_fill="background")),
    ("lr-fgs", dict(lr_check=True, fgs_lambda=64.0, fgs_sigma=0.05)),
    ("pyramid1", dict(pyramid_levels=1)),
    ("pyramid1-subpixel-speckle", dict(pyramid_levels=1, subpixel=True,
                                       speckle=True)),
]


def _jax_options(options):
    import jax.numpy as jnp
    options = dict(options)
    if "cost_dtype" in options:
        options["cost_dtype"] = jnp.dtype(options["cost_dtype"])
    return options


@pytest.mark.parametrize("name,options", CONFIGS,
                         ids=[name for name, _ in CONFIGS])
def test_estimate_batch_equals_jax(pair_stack, name, options):
    left, right = pair_stack
    ref = np.asarray(JaxStreamingEstimator(
        D, batch=2, kernel_size=3, backend="xla",
        **_jax_options(options)).estimate_batch(left, right))
    out = host_array(StreamingEstimator(
        D, batch=2, kernel_size=3, device="cpu",
        **options).estimate_batch(left, right))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if "fgs_lambda" in options:
        np.testing.assert_allclose(out, ref, rtol=0, atol=FGS_ATOL)
    else:
        np.testing.assert_array_equal(out, ref)


# (name, StreamingEstimator options, estimate_refined options or None for
# estimate, speckle fill or None)
OWN = [
    ("plain", {}, None, None),
    ("dyn-lr-mirror", dict(reducer="dynamic_programming", lr_check=True,
                           lr_mode="mirror"),
     dict(subpixel=False, median=False, lr_check=True, lr_mode="mirror"),
     None),
    ("refine-wmf", dict(median=True, subpixel=True, weighted_median=True),
     dict(weighted_median=True), None),
    ("lr-fgs-speckle", dict(lr_check=True, fgs_lambda=16.0, speckle=True,
                            speckle_fill="background"),
     dict(subpixel=False, median=False, lr_check=True, lr_mode="volume",
          fgs_lambda=16.0), "background"),
]


@pytest.mark.parametrize("name,options,refined,fill", OWN,
                         ids=[case[0] for case in OWN])
def test_streamed_frame_equals_estimate_refined(sbs_frames, name, options,
                                                refined, fill):
    """A streamed frame is the port's own refined chain, bit for bit."""
    from stereomatch_tpu_torch.ops.refine import filter_speckles
    est = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu",
                             **options)
    outs = list(est.run(ImageSequenceCapture(sbs_frames[:3])))
    pipe = create_pipeline("ssd", "dyn" if "reducer" in options else "wta",
                           "sgm", max_disparity=D, device="cpu",
                           kernel_size=3)
    for (gray, disp), frame in zip(outs, sbs_frames):
        left = frame[:, :48].astype(np.float32)
        right = frame[:, 48:].astype(np.float32)
        want = (pipe.estimate(left, right) if refined is None
                else pipe.estimate_refined(left, right, **refined))
        if fill is not None:
            want = filter_speckles(want.to(torch.float32), fill=fill)
        np.testing.assert_array_equal(gray, frame[:, :48])
        np.testing.assert_array_equal(disp, want.numpy())


def test_run_equals_jax_run(sbs_frames):
    """Both streams over in-memory captures: the same frames, in order,
    int32, with the same stage split keys."""
    jax_est = JaxStreamingEstimator(D, batch=3, kernel_size=3,
                                    backend="xla")
    ref = list(jax_est.run(JaxImageSequenceCapture(sbs_frames)))
    est = StreamingEstimator(D, batch=3, kernel_size=3, device="cpu")
    outs = list(est.run(ImageSequenceCapture(sbs_frames)))
    assert len(outs) == len(ref) == 7
    for (g0, d0), (g1, d1) in zip(ref, outs):
        assert d1.dtype == d0.dtype == np.int32
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_array_equal(d0, d1)
    assert (est.stats.frames, est.stats.batches) == (7, 3)
    assert est.stats.frames_run == 9            # the tail padded to 3
    assert set(est.stats.stage_ms_per_frame()) == set(
        jax_est.stats.stage_ms_per_frame())


def test_uneven_tail_and_depths_agree(sbs_frames):
    est = StreamingEstimator(D, batch=4, kernel_size=3, device="cpu")
    ref = list(est.run(ImageSequenceCapture(sbs_frames)))
    assert len(ref) == 7 and est.stats.batches == 2
    for depth in (1, 3):
        est = StreamingEstimator(D, batch=4, depth=depth, kernel_size=3,
                                 device="cpu")
        outs = list(est.run(ImageSequenceCapture(sbs_frames),
                            max_frames=6))
        assert len(outs) == 6 and est.stats.frames == 6
        for (g0, d0), (g1, d1) in zip(ref, outs):
            assert d1.dtype == np.int32
            np.testing.assert_array_equal(d0, d1)
        split = est.stats.stage_ms_per_frame()
        assert split["total"] > 0 and est.stats.fps > 0


def test_estimate_batch_takes_tensors_and_float_frames(pair_stack):
    """uint8 frames widen on the device: uint8 stacks, their float32
    values and tensors of either give the same disparities."""
    left, right = pair_stack
    est = StreamingEstimator(D, batch=2, kernel_size=3, device="cpu")
    want = host_array(est.estimate_batch(left, right))
    for lt, rt in ((left.astype(np.float32), right.astype(np.float32)),
                   (torch.from_numpy(left), torch.from_numpy(right))):
        np.testing.assert_array_equal(
            host_array(est.estimate_batch(lt, rt)), want)


def test_narrowing_dtypes():
    i32 = torch.zeros((2, 4, 4), dtype=torch.int32)
    assert narrow_for_fetch(i32, 16).dtype == torch.uint8
    assert narrow_for_fetch(i32, 256).dtype == torch.uint8
    assert narrow_for_fetch(i32, 512).dtype == torch.uint16
    f32 = torch.zeros((2, 4, 4))
    assert narrow_for_fetch(f32, 16).dtype == torch.float32
    assert _widen_host(np.zeros(3, np.uint16)).dtype == np.int32
    assert _widen_host(np.zeros(3, np.float32)).dtype == np.float32


def test_wide_range_fetch_round_trips(sbs_frames):
    """D = 272 > 256 narrows to uint16 and still yields int32 equal to the
    pipeline."""
    frames = [np.concatenate([f[:, :48], f[:, 48:]], axis=1)
              for f in sbs_frames[:2]]
    est = StreamingEstimator(272, batch=2, kernel_size=3, aggregation=None,
                             device="cpu")
    pipe = create_pipeline("ssd", "wta", None, max_disparity=272,
                           device="cpu", kernel_size=3)
    for (_, disp), frame in zip(est.run(ImageSequenceCapture(frames)),
                                frames):
        assert disp.dtype == np.int32
        np.testing.assert_array_equal(disp, pipe.estimate(
            frame[:, :48].astype(np.float32),
            frame[:, 48:].astype(np.float32)).numpy())


def test_abandoned_generator_leaves_no_thread(sbs_frames):
    before = {t.ident for t in threading.enumerate()}
    est = StreamingEstimator(D, batch=1, depth=3, fetch_workers=3,
                             kernel_size=3, aggregation=None, device="cpu")
    gen = est.run(ImageSequenceCapture(sbs_frames))
    next(gen)
    next(gen)
    assert any(t.name.startswith("stm-fetch") for t in threading.enumerate())
    gen.close()
    left = [t for t in threading.enumerate() if t.ident not in before]
    assert left == [], left
    assert est.stats.seconds > 0


def test_mesh_equals_single_device(sbs_frames):
    """mesh= over 4 CPU devices (2 frames x 2 row tiles) equals the
    single-device stream; an odd batch rounds up to the batch axis."""
    mesh = make_mesh([torch.device("cpu")] * 4, n_batch=2)
    for options in ({}, dict(median=True, subpixel=True),
                    dict(pyramid_levels=1)):
        est = StreamingEstimator(D, batch=3, kernel_size=3, mesh=mesh,
                                 **options)
        assert est.batch == 4
        outs = list(est.run(ImageSequenceCapture(sbs_frames[:5])))
        ref = list(StreamingEstimator(D, batch=2, kernel_size=3,
                                      device="cpu", **options).run(
            ImageSequenceCapture(sbs_frames[:5])))
        assert len(outs) == len(ref) == 5
        for (_, d0), (_, d1) in zip(ref, outs):
            assert d0.dtype == d1.dtype
            np.testing.assert_array_equal(d0, d1)


def test_validation_matches_jax():
    with pytest.raises(ValueError, match="depth"):
        StreamingEstimator(D, depth=0, device="cpu")
    for options in (dict(lr_check=True), dict(weighted_median=True),
                    dict(fgs_lambda=8.0)):
        with pytest.raises(ValueError, match="pyramid_levels"):
            JaxStreamingEstimator(D, pyramid_levels=1, **options)
        with pytest.raises(ValueError, match="pyramid_levels"):
            StreamingEstimator(D, pyramid_levels=1, device="cpu", **options)
    with pytest.raises(ValueError, match="reducer"):
        StreamingEstimator(D, reducer="dyn", device="cpu")


def test_graph_choice_is_made_from_the_options():
    """The flat paths without post-processing take the compiled frame
    (a CUDA graph on the card, eager here); the others run eagerly."""
    assert StreamingEstimator(D, device="cpu")._compiled is not None
    for options in (dict(subpixel=True), dict(speckle=True),
                    dict(backend="torch"), dict(pyramid_levels=1),
                    dict(lr_check=True)):
        assert StreamingEstimator(D, device="cpu",
                                  **options)._compiled is None
