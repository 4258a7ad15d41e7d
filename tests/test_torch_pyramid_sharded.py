"""The port's row-sharded pyramid and tracking step
(``parallel/pyramid_sharded.py``, ``parallel/temporal_sharded.py``)
against the port's single-device results and the JAX package's mesh
programs, on the CPU.

JAX's programs run over the 8-device virtual CPU mesh, the port's over
``make_mesh([cpu] * 8, n_batch=2)`` (2 frames x 4 tiles, the layout of
``convert.mesh_from_jax``), on two distinct frames.  Exact hand-off and
both overlap depths give JAX's disparities bit for bit, and the exact
mode gives the single-device ``PyramidPipeline`` too (an overlap that
misses predecessors may not: both packages' overlap mode is that
approximation); sub-pixel, median off and speckle as well.  The mesh
tracker equals JAX's mesh tracker and the port's single-device tracker
frame by frame, with the same keyframe schedule, and a lost track in
one stream fires the shared drift keyframe.
"""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu import parallel as jax_parallel
from stereomatch_tpu import temporal as jax_temporal
from stereomatch_tpu.io.synthetic import stereo_pair, stereo_sequence
from stereomatch_tpu_torch import convert, pyramid, temporal
from stereomatch_tpu_torch.ops.refine import filter_speckles
from stereomatch_tpu_torch.parallel import (make_mesh,
                                            make_pyramid_sharded_estimate,
                                            make_temporal_track_sharded)

from .torch_threads import one_torch_thread  # noqa: F401

D = 16


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    jax_mesh = jax_parallel.make_mesh(jax.devices()[:8], n_batch=2)
    return jax_mesh, convert.mesh_from_jax(jax_mesh,
                                           [torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def frames():
    a = stereo_pair(32, 48, D, seed=3)
    b = stereo_pair(32, 48, D, seed=8)
    return np.stack([a[0], b[0]]), np.stack([a[1], b[1]])


CASES = {
    "exact-l1": dict(levels=1),
    "exact-l2": dict(levels=2),
    "overlap-all-l1": dict(levels=1, sgm_mode="overlap", overlap=64),
    "overlap-2-l2": dict(levels=2, sgm_mode="overlap", overlap=2),
    "subpixel": dict(levels=1, subpixel=True),
    "median-off": dict(levels=2, median=False, band_kernel_size=3),
    "speckle": dict(levels=1, speckle=True, speckle_fill="background"),
    "bf16": dict(levels=1, cost_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", CASES)
def test_sharded_pyramid_equals_jax_and_single_device(meshes, frames, case):
    jax_mesh, mesh = meshes
    left, right = frames
    kw = dict(max_disparity=D, band_radius=3, **CASES[case])
    jax_kw = dict(kw)
    if case == "bf16":
        import jax.numpy as jnp
        jax_kw["cost_dtype"] = jnp.bfloat16
    want = np.asarray(jax_parallel.make_pyramid_sharded_estimate(
        jax_mesh, backend="xla", **jax_kw)(left, right))
    got = make_pyramid_sharded_estimate(mesh, **kw)(left, right)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if kw.get("sgm_mode") == "overlap" and kw.get("overlap") == 2:
        return
    single = pyramid.PyramidPipeline(
        D, levels=kw["levels"], band_radius=3,
        band_kernel_size=kw.get("band_kernel_size", 5),
        median=kw.get("median", True),
        cost_dtype=kw.get("cost_dtype", "float32"), device="cpu")
    for f in range(2):
        run = single.estimate_refined if kw.get("subpixel") else \
            single.estimate
        ref = run(left[f], right[f])
        if kw.get("speckle"):
            ref = filter_speckles(ref.to(torch.float32), fill="background")
        np.testing.assert_array_equal(got[f].numpy(), ref.numpy())


def test_sharded_pyramid_five_tiles_one_frame():
    """Another tiling: one frame over 5 tiles of 8 rows at level 2."""
    left, right, _ = stereo_pair(40, 56, D, seed=4)
    mesh = make_mesh([torch.device("cpu")] * 5, n_batch=1)
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=2,
                                       band_radius=4)
    single = pyramid.PyramidPipeline(D, levels=2, band_radius=4,
                                     device="cpu")
    np.testing.assert_array_equal(fn(left[None], right[None])[0].numpy(),
                                  single.estimate(left, right).numpy())


def test_sharded_pyramid_validation(meshes, frames):
    _, mesh = meshes
    left, right = frames
    with pytest.raises(ValueError):
        make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=0)
    with pytest.raises(ValueError):
        make_pyramid_sharded_estimate(mesh, max_disparity=18, levels=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A.14"):
        make_pyramid_sharded_estimate(mesh, max_disparity=D, sgm_mode="auto")
    with pytest.raises(TypeError):
        make_pyramid_sharded_estimate(mesh, max_disparity=D, interpret=True)
    fn = make_pyramid_sharded_estimate(mesh, max_disparity=D, levels=2)
    with pytest.raises(ValueError, match="not divisible"):
        fn(left[:, :24], right[:, :24])        # 24 rows: 4 tiles x 4 no
    with pytest.raises(ValueError):
        fn(left[:1], right[:1])                 # batch 1 over 2 rows


def test_mesh_tracking_equals_jax_and_single_device(meshes):
    jax_mesh, mesh = meshes
    jax_pipe = jax_temporal.TemporalPipeline(D, keyframe_interval=3,
                                             backend="xla", mesh=jax_mesh)
    pipe = temporal.TemporalPipeline(D, keyframe_interval=3, mesh=mesh)
    single = temporal.TemporalPipeline(D, keyframe_interval=3, device="cpu")
    seq_a = stereo_sequence(32, 48, D, 5, seed=3)
    seq_b = stereo_sequence(32, 48, D, 5, seed=9)
    for (la, ra, _), (lb, rb, _) in zip(seq_a, seq_b):
        left, right = np.stack([la, lb]), np.stack([ra, rb])
        want = np.asarray(jax_pipe.estimate(left, right))
        got = pipe.estimate(left, right)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got[0].numpy(),
                                      single.estimate(la, ra).numpy())
        assert pipe.keyframes == jax_pipe.keyframes
        assert pipe.drift_keyframes == jax_pipe.drift_keyframes


def test_mesh_track_step_fraction_equals_single_device(meshes):
    _, mesh = meshes
    frames = stereo_sequence(32, 48, D, 2, seed=5, motion=1)
    single = temporal.TemporalPipeline(D, keyframe_interval=0, device="cpu")
    (l0, r0, _), (l1, r1, _) = frames
    prev = single.estimate(l0, r0)
    fn = make_temporal_track_sharded(mesh, max_disparity=D)
    disp, frac = fn(np.stack([l1, r1]), np.stack([r1, l1]),
                    torch.stack([prev, prev]))
    for b, (left, right) in enumerate(((l1, r1), (r1, l1))):
        want_disp, want_frac = single._track(torch.from_numpy(left),
                                             torch.from_numpy(right), prev)
        np.testing.assert_array_equal(disp[b].numpy(), want_disp.numpy())
        assert frac[b].item() == want_frac.item()


def test_mesh_drift_in_one_stream_fires_the_shared_keyframe(meshes):
    jax_mesh, mesh = meshes
    d = 32
    jax_pipe = jax_temporal.TemporalPipeline(d, keyframe_interval=0,
                                             backend="xla", mesh=jax_mesh)
    pipe = temporal.TemporalPipeline(d, keyframe_interval=0, mesh=mesh)
    frames = stereo_sequence(64, 96, d, 2, seed=3, motion=1)
    for left, right, _ in frames:
        np.testing.assert_array_equal(
            pipe.estimate(np.stack([left] * 2), np.stack([right] * 2)).numpy(),
            np.asarray(jax_pipe.estimate(np.stack([left] * 2),
                                         np.stack([right] * 2))))
    assert pipe.drift_keyframes == 0
    left, right, _ = frames[-1]
    got = pipe.estimate(np.stack([left, right]), np.stack([right, left]))
    want = jax_pipe.estimate(np.stack([left, right]), np.stack([right, left]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pipe.drift_keyframes == jax_pipe.drift_keyframes == 1


def test_mesh_mode_validates_stacks(meshes):
    _, mesh = meshes
    pipe = temporal.TemporalPipeline(D, mesh=mesh)
    with pytest.raises(ValueError, match="batch axis of 1"):
        pipe.estimate(np.zeros((32, 48), np.float32),
                      np.zeros((32, 48), np.float32))
    with pytest.raises(ValueError):
        pipe.estimate(np.zeros((2, 32, 48), np.float32),
                      np.zeros((2, 32, 40), np.float32))
    one = temporal.TemporalPipeline(
        D, mesh=make_mesh([torch.device("cpu")] * 4, n_batch=1))
    left, right, _ = stereo_sequence(32, 48, D, 1, seed=2)[0]
    out = one.estimate(left, right)
    assert tuple(out.shape) == (32, 48)
    assert tuple(one.host_disparity().shape) == (32, 48)
