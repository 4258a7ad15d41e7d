"""Golden teddy disparities of the pyramid and the video tracker, for the
port.

``tests/data/golden_torch_pyramid_teddy.npz`` holds, made by the JAX
package's XLA path on the CPU:

* ``PyramidPipeline(128, levels=L)`` (the defaults: band radius 24, band
  window 5, P1 = 0.1, P2 = 0.2, float32, median) on the golden teddy
  scene (375x450, seed 2026): ``estimate`` and ``estimate_refined`` at
  levels 1 and 2, and ``estimate`` on a bf16 coarse volume, with each
  one's bad-pixel rate;
* an 8-frame teddy-size video through ``TemporalPipeline(128,
  keyframe_interval=4)``: frames 0-4 of ``stereo_sequence(375, 450, 128,
  5, seed=2026, motion=1)``, then a scene cut to frames 0-2 of another
  sequence (seed 2027): every frame's disparity and both keyframe
  counters after each frame (keyframes at frames 0 and 4 by the cadence
  and at 5 by drift).

``chip_smoke.py`` holds the card's paths to it without importing JAX.
The port's plain paths on the CPU must hit it in 0 pixels.

Regenerate (only when the JAX package's semantics change on purpose):

    JAX_PLATFORMS=cpu python -m tests.test_torch_pyramid_golden
"""

from pathlib import Path

import numpy as np
import pytest

from .torch_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "golden_torch_pyramid_teddy.npz"
PARAMS = dict(height=375, width=450, max_disparity=128, seed=2026,
              cut_seed=2027, keyframe_interval=4)
PYRAMIDS = [f"pyramid{levels}_{mode}" for levels in (1, 2)
            for mode in ("estimate", "refined", "bf16")]


def scene():
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    return stereo_pair(PARAMS["height"], PARAMS["width"],
                       PARAMS["max_disparity"], seed=PARAMS["seed"])


def video():
    """The 8 frames: 5 of one sequence, then a cut to 3 of another."""
    from stereomatch_tpu_torch.io.synthetic import stereo_sequence
    h, w, d = PARAMS["height"], PARAMS["width"], PARAMS["max_disparity"]
    return (stereo_sequence(h, w, d, 5, seed=PARAMS["seed"], motion=1)
            + stereo_sequence(h, w, d, 3, seed=PARAMS["cut_seed"], motion=1))


def _bad_pixel(disp, gt):
    d = PARAMS["max_disparity"]
    return float(np.mean((np.abs(disp - gt) > 1)[:, d:]))


def run_pyramid(pipeline_cls, name, left, right, bf16, **kw):
    """One of PYRAMIDS; ``bf16`` is the bfloat16 dtype the pipeline class
    takes."""
    levels, mode = int(name[len("pyramid")]), name.split("_")[1]
    if mode == "bf16":
        kw["cost_dtype"] = bf16
    pipe = pipeline_cls(PARAMS["max_disparity"], levels=levels, **kw)
    return (pipe.estimate_refined if mode == "refined"
            else pipe.estimate)(left, right)


def make_golden(path: Path = GOLDEN) -> None:
    import jax.numpy as jnp
    from stereomatch_tpu.pyramid import PyramidPipeline
    from stereomatch_tpu.temporal import TemporalPipeline
    left, right, gt = scene()
    arrays = {}
    for name in PYRAMIDS:
        disp = np.asarray(run_pyramid(PyramidPipeline, name, left, right,
                                      jnp.bfloat16, backend="xla"))
        arrays[name] = disp
        arrays[f"bad_pixel_{name}"] = _bad_pixel(disp, gt)
    pipe = TemporalPipeline(PARAMS["max_disparity"], backend="xla",
                            keyframe_interval=PARAMS["keyframe_interval"])
    disps, keys, drifts = [], [], []
    for l, r, _ in video():
        disps.append(np.asarray(pipe.estimate(l, r)))
        keys.append(pipe.keyframes)
        drifts.append(pipe.drift_keyframes)
    arrays.update(video=np.stack(disps), keyframes=np.asarray(keys),
                  drift_keyframes=np.asarray(drifts))
    np.savez_compressed(path, **arrays, **PARAMS)


def test_golden_parameters_and_schedule():
    g = np.load(GOLDEN)
    assert {k: g[k].item() for k in PARAMS} == PARAMS
    _, _, gt = scene()
    for name in PYRAMIDS:
        assert g[name].shape == (PARAMS["height"], PARAMS["width"])
        assert _bad_pixel(g[name], gt) == float(g[f"bad_pixel_{name}"])
        assert float(g[f"bad_pixel_{name}"]) < 0.05
    assert g["video"].shape == (8, PARAMS["height"], PARAMS["width"])
    np.testing.assert_array_equal(g["keyframes"], [1, 1, 1, 1, 2, 3, 3, 3])
    np.testing.assert_array_equal(g["drift_keyframes"],
                                  [0, 0, 0, 0, 0, 1, 1, 1])


@pytest.mark.parametrize("name", PYRAMIDS)
def test_port_pyramid_matches_golden(name):
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    g = np.load(GOLDEN)
    left, right, _ = scene()
    disp = run_pyramid(PyramidPipeline, name, left, right, "bfloat16",
                       device="cpu").numpy()
    assert disp.dtype == g[name].dtype
    assert int((disp != g[name]).sum()) == 0


def test_port_video_matches_golden():
    from stereomatch_tpu_torch.temporal import TemporalPipeline
    g = np.load(GOLDEN)
    pipe = TemporalPipeline(PARAMS["max_disparity"], device="cpu",
                            keyframe_interval=PARAMS["keyframe_interval"])
    for i, (left, right, _) in enumerate(video()):
        disp = pipe.estimate(left, right).numpy()
        assert int((disp != g["video"][i]).sum()) == 0, i
        assert pipe.keyframes == g["keyframes"][i]
        assert pipe.drift_keyframes == g["drift_keyframes"][i]


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN}")
