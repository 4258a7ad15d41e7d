"""``Pipeline.estimate_refined`` and ``last_confidence`` of the port
against the JAX package's, on the CPU.

Both pipelines come from ``create_pipeline`` with one set of names, on
synthetic scenes at 24x40 D=16 and 37x53 D=24; the JAX side runs its XLA
path, as its own tests do on the CPU.  Every flag set of the JAX
``estimate_refined`` is held bit for bit (the port reproduces XLA's
arithmetic where the weighted median and the smoother weigh by ``exp``),
for ssd -> sgm -> wta and, for a few flag sets, ssd -> sgm -> dyn and
census -> cvf -> wta.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli_common
from stereomatch_tpu.io.synthetic import stereo_pair
from stereomatch_tpu_torch import cli_common

from .torch_threads import one_torch_thread  # noqa: F401

FLAG_SETS = {
    "default": {},
    "lr_mirror": dict(lr_check=True),
    "lr_volume": dict(lr_check=True, lr_mode="volume"),
    "lr_max_diff_0": dict(lr_check=True, lr_mode="volume", max_diff=0),
    "wmf": dict(weighted_median=True, wmf_sigma=0.1),
    "wmf_window_3": dict(weighted_median=True, wmf_sigma=0.05,
                         wmf_window=3, subpixel=False),
    "fgs": dict(fgs_lambda=16.0, fgs_sigma=0.08),
    "fgs_lr": dict(fgs_lambda=16.0, fgs_sigma=0.08, lr_check=True),
    "min_confidence": dict(min_confidence=0.1),
    "bare": dict(subpixel=False, median=False),
    "everything": dict(lr_check=True, weighted_median=True, wmf_sigma=0.1,
                       fgs_lambda=16.0, fgs_sigma=0.08,
                       min_confidence=0.05),
}
SCENES = {"24x40": (24, 40, 16, 3), "37x53": (37, 53, 24, 5)}


def _pipelines(cost, reducer, aggr, d):
    kw = dict(max_disparity=d, cvf_radius=3)
    jax_pipe = jax_cli_common.create_pipeline(cost, reducer, aggr, **kw)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, device="cpu",
                                      **kw)
    if cost == "ssd":
        jax_pipe.cost.kernel_size = pipe.cost.kernel_size = 3
    return jax_pipe, pipe


def _hold(jax_pipe, pipe, left, right, flags):
    ref = np.asarray(jax_pipe.estimate_refined(left, right, **flags))
    out = pipe.estimate_refined(left, right, **flags)
    assert out.device.type == "cpu"
    assert out.numpy().dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(pipe.last_confidence().numpy(),
                                  np.asarray(jax_pipe.last_confidence()))
    return out


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("flags", FLAG_SETS)
def test_ssd_sgm_wta_refined_equals_jax(scene, flags):
    h, w, d, seed = SCENES[scene]
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    _hold(*_pipelines("ssd", "wta", "sgm", d), left, right, FLAG_SETS[flags])


@pytest.mark.parametrize("config", [("ssd", "dyn", "sgm"),
                                    ("census", "wta", "cvf"),
                                    ("sad", "wta", None)], ids=str)
@pytest.mark.parametrize("flags", ["default", "lr_mirror", "everything"])
def test_other_paths_refined_equal_jax(config, flags):
    h, w, d, seed = SCENES["37x53"]
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    _hold(*_pipelines(*config, d), left, right, FLAG_SETS[flags])


def test_refined_output_types_and_last_confidence():
    h, w, d, seed = SCENES["24x40"]
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      device="cpu")
    with pytest.raises(RuntimeError, match="estimate"):
        pipe.last_confidence()
    assert pipe.estimate_refined(left, right, subpixel=False).dtype == \
        torch.int32
    assert pipe.estimate_refined(left, right).dtype == torch.float32
    conf = pipe.last_confidence()
    assert conf.shape == (h, w) and float(conf.min()) >= 0.0 \
        and float(conf.max()) <= 1.0
    gated = pipe.estimate_refined(left, right, min_confidence=1.1)
    assert not gated.any()
    with pytest.raises(ValueError, match="lr_mode"):
        pipe.estimate_refined(left, right, lr_check=True, lr_mode="both")


def test_refined_takes_tensors_and_keeps_the_stage_captures():
    """Tensor images run on their device; the mirrored run goes first,
    so the captured volumes are the left view's."""
    h, w, d, seed = SCENES["24x40"]
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      device="cpu")
    out = pipe.estimate_refined(torch.from_numpy(left),
                                torch.from_numpy(right), lr_check=True)
    want = pipe.estimate(left, right)
    volume = pipe._aggregation_volume
    again = pipe.estimate_refined(left, right, lr_check=True)
    assert torch.equal(out, again)
    assert torch.equal(pipe._disparity_image, want)
    assert torch.equal(pipe._aggregation_volume, volume)
