"""The port's pipelines end to end against the JAX package and the
committed golden anchors.

Both packages build their pipelines from the same registry names
(``convert.pipeline_from_jax`` carries the configuration across) and run
the same numpy scene: the disparities must be identical.  The port's
plain path must also reproduce the committed golden disparities
(tests/data/golden_*_disparity.npz, generated by the XLA oracles) at
every pixel.  Pipelines run on the card unless asked for the CPU: every
run here passes ``device="cpu"``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli
from stereomatch_tpu_torch import Pipeline, cli_common, convert
from stereomatch_tpu_torch.aggregation import CostFilter, Semiglobal
from stereomatch_tpu_torch.cost import SAD, SSD, Census
from stereomatch_tpu_torch.disparity_reduce import (DynamicProgramming,
                                                     WinnerTakesAll)
from stereomatch_tpu_torch.io.synthetic import stereo_pair

from .torch_threads import one_torch_thread  # noqa: F401

DATA = Path(__file__).parent / "data"


@pytest.mark.parametrize("cost,aggr,dtype", [
    ("ssd", "sgm", "float32"), ("sad", "sgm", "float32"),
    ("ssd", None, "float32"), ("ssd", None, "int32")])
def test_identical_disparities_to_jax(cost, aggr, dtype):
    left, right, _ = stereo_pair(40, 64, 16, seed=3)
    if dtype == "int32":
        left = (left * 255).astype(np.uint8)
        right = (right * 255).astype(np.uint8)
    jax_pipe = jax_cli.create_pipeline(cost, "wta", aggr, max_disparity=16,
                                       penalty1=0.15, penalty2=0.4,
                                       volume_dtype=dtype)
    port_pipe = convert.pipeline_from_jax(jax_pipe, device="cpu")
    direct = cli_common.create_pipeline(cost, "wta", aggr, max_disparity=16,
                                        penalty1=0.15, penalty2=0.4,
                                        volume_dtype=dtype, device="cpu")
    ref = np.asarray(jax_pipe.estimate(left, right))
    out = port_pipe.estimate(left, right)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(direct.estimate(left, right).numpy(), ref)
    np.testing.assert_array_equal(port_pipe._cost_volume.numpy(),
                                  np.asarray(jax_pipe._cost_volume))
    np.testing.assert_array_equal(port_pipe._aggregation_volume.numpy(),
                                  np.asarray(jax_pipe._aggregation_volume))


@pytest.mark.parametrize("name", ["golden_teddy_disparity.npz",
                                  "golden_sgm_disparity.npz"])
def test_plain_path_reproduces_golden(name):
    g = np.load(DATA / name)
    d = int(g["max_disparity"])
    left, right, gt = stereo_pair(int(g["height"]), int(g["width"]), d,
                                  seed=int(g["seed"]))
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                      penalty1=float(g["penalty1"]),
                                      penalty2=float(g["penalty2"]),
                                      device="cpu")
    pipe.cost.kernel_size = int(g["kernel_size"])
    disp = pipe.estimate(left, right).numpy()
    np.testing.assert_array_equal(disp, g["wta"])
    bad = np.mean((np.abs(disp - gt) > 1)[:, d:])
    assert bad <= float(g["bad_pixel_vs_gt"]) + 1e-9


def test_estimate_takes_tensors_and_numpy_and_a_device():
    left, right, _ = stereo_pair(24, 40, 8, seed=1)
    pipe = Pipeline(SSD(8, kernel_size=3), WinnerTakesAll(),
                    aggregation=Semiglobal())
    from_numpy = pipe.estimate(left, right, device="cpu")
    from_tensor = pipe.estimate(torch.from_numpy(left),
                                torch.from_numpy(right), device="cpu")
    assert torch.equal(from_numpy, from_tensor)
    fn = pipe.estimate_fn()
    assert torch.equal(fn(torch.from_numpy(left), torch.from_numpy(right)),
                       from_numpy)
    assert pipe._cost_volume.shape == (24, 40, 8)
    assert pipe._disparity_image is from_tensor


def test_pipeline_without_aggregation_reduces_the_cost_volume():
    left, right, _ = stereo_pair(16, 32, 8, seed=2)
    pipe = cli_common.create_pipeline("sad", "wta", max_disparity=8)
    disp = pipe.estimate(left, right, device="cpu")
    assert pipe._aggregation_volume is pipe._cost_volume
    assert isinstance(pipe.cost, SAD)
    assert torch.equal(disp, pipe._cost_volume.argmin(dim=2).int())


@pytest.mark.parametrize("kwargs", [
    dict(cost_method="birchfield", disp_method="wta"),
    dict(cost_method="ncc", disp_method="wta"),
    dict(cost_method="ssd-texture", disp_method="dyn"),
    dict(cost_method="ssd", disp_method="wta", aggr_method="cvf",
         cvf_subsample=2)])
def test_not_ported_names_refuse_with_roadmap_item(kwargs):
    """Every name of the JAX package's registries: the A.8 costs and the
    fast guided filter (A.9), refused until they were ported, run and
    equal JAX's disparities."""
    left, right, _ = stereo_pair(24, 40, 8, seed=5)
    ref = jax_cli.create_pipeline(max_disparity=8, **kwargs)
    pipe = cli_common.create_pipeline(max_disparity=8, device="cpu",
                                      **kwargs)
    np.testing.assert_array_equal(pipe.estimate(left, right).numpy(),
                                  np.asarray(ref.estimate(left, right)))


@pytest.mark.parametrize("cost,aggr,reducer", [
    ("ssd", None, "wta"), ("ssd", "sgm", "dyn"), ("sad", "sgm", "wta"),
    ("census", "cvf", "wta")])
def test_bfloat16_volume_dtype_runs(cost, aggr, reducer):
    """volume_dtype="bfloat16" (refused until bf16 storage was ported):
    bf16 cost and aggregation volumes, int32 disparities."""
    left, right, _ = stereo_pair(24, 40, 8, seed=4)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, max_disparity=8,
                                      volume_dtype="bfloat16", device="cpu")
    assert pipe.cost.cost_volume_dtype == torch.bfloat16
    disp = pipe.estimate(left, right)
    assert disp.dtype == torch.int32 and tuple(disp.shape) == (24, 40)
    assert pipe._cost_volume.dtype == torch.bfloat16
    assert pipe._aggregation_volume.dtype == torch.bfloat16


def test_unknown_names_and_int32_aggregation_raise():
    with pytest.raises(ValueError, match="unknown cost method"):
        cli_common.create_pipeline("sdd", "wta")
    with pytest.raises(ValueError, match="unknown aggregation"):
        cli_common.create_pipeline("ssd", "wta", "sgn")
    with pytest.raises(ValueError, match="int32"):
        cli_common.create_pipeline("ssd", "wta", "sgm", volume_dtype="int32")


def test_convert_reads_configuration_and_refuses_unported_stages():
    jax_pipe = jax_cli.create_pipeline("sad", "wta", "sgm", max_disparity=24,
                                       penalty1=0.3, penalty2=0.9)
    jax_pipe.cost.kernel_size = 4
    port = convert.pipeline_from_jax(jax_pipe, device="cpu")
    assert isinstance(port.cost, SAD)
    assert (port.cost.max_disparity, port.cost.kernel_size) == (24, 4)
    assert port.cost.cost_volume_dtype == torch.float32
    assert (port.aggregation.penalty1, port.aggregation.penalty2) == (0.3, 0.9)
    assert isinstance(port.disparity_reduce, WinnerTakesAll)
    assert port.device == "cpu"
    # The A.8 costs and the fast guided filter (A.9), refused until they
    # were ported, now carry across and run as JAX's: a JAX CostFilter
    # with wedge_offset=None and subsample=2 crosses as it is.
    left, right, _ = stereo_pair(24, 40, 8, seed=6)
    for kw in (dict(cost_method="ncc", disp_method="wta"),
               dict(cost_method="birchfield", disp_method="dyn"),
               dict(cost_method="ssd", disp_method="wta", aggr_method="cvf",
                    cvf_subsample=2)):
        ref_pipe = jax_cli.create_pipeline(max_disparity=8, **kw)
        port_pipe = convert.pipeline_from_jax(ref_pipe, device="cpu")
        np.testing.assert_array_equal(
            port_pipe.estimate(left, right).numpy(),
            np.asarray(ref_pipe.estimate(left, right)))
    assert port_pipe.aggregation.wedge_offset is None
    assert port_pipe.aggregation.subsample == 2
    with pytest.raises(TypeError):
        convert.pipeline_from_jax(
            Pipeline(SSD(8), WinnerTakesAll()))      # not a JAX pipeline


def test_default_device_is_the_card():
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=8)
    assert pipe.device == "cuda"
    assert Pipeline(SSD(8), WinnerTakesAll()).device == "cuda"
    jax_pipe = jax_cli.create_pipeline("ssd", "wta", max_disparity=8)
    assert convert.pipeline_from_jax(jax_pipe).device == "cuda"
    assert cli_common.create_pipeline("ssd", "wta",
                                      device="cpu").device == "cpu"
    if not torch.cuda.is_available():
        # No silent fallback: without a card the default refuses to run.
        left, right, _ = stereo_pair(8, 16, 4, seed=1)
        with pytest.raises((RuntimeError, AssertionError)):
            pipe.estimate(left, right)


SMALL = np.load(DATA / "golden_sgm_disparity.npz")
TEDDY = np.load(DATA / "golden_teddy_disparity.npz")


def _golden_scene(g):
    d = int(g["max_disparity"])
    return stereo_pair(int(g["height"]), int(g["width"]), d,
                       seed=int(g["seed"])) + (d,)


@pytest.mark.parametrize("golden", [SMALL, TEDDY], ids=["96x128", "teddy"])
def test_ssd_sgm_dyn_reproduces_golden_dp(golden):
    left, right, _, d = _golden_scene(golden)
    pipe = cli_common.create_pipeline(
        "ssd", "dyn", "sgm", max_disparity=d,
        penalty1=float(golden["penalty1"]),
        penalty2=float(golden["penalty2"]), device="cpu")
    pipe.cost.kernel_size = int(golden["kernel_size"])
    assert isinstance(pipe.disparity_reduce, DynamicProgramming)
    np.testing.assert_array_equal(pipe.estimate(left, right).numpy(),
                                  golden["dp"])


def test_census_sgm_wta_reproduces_golden_census():
    """The census port's bit-level anchor, as tests/test_golden_anchor.py
    holds the JAX package to it."""
    left, right, gt, d = _golden_scene(SMALL)
    pipe = cli_common.create_pipeline(
        "census", "wta", "sgm", max_disparity=d,
        penalty1=float(SMALL["penalty1"]),
        penalty2=float(SMALL["penalty2"]), device="cpu")
    assert isinstance(pipe.cost, Census)
    disp = pipe.estimate(left, right).numpy()
    np.testing.assert_array_equal(disp, SMALL["census_wta"])
    bad = np.mean((np.abs(disp - gt) > 1)[:, d:])
    assert bad <= float(SMALL["census_bad_pixel_vs_gt"]) + 1e-9


@pytest.mark.parametrize("reducer", ["wta", "dyn"])
@pytest.mark.parametrize("golden", [SMALL, TEDDY], ids=["96x128", "teddy"])
def test_census_cvf_paths_match_jax(golden, reducer):
    """At most 0.01% of pixels may differ from JAX (0 expected: the port
    equals JAX's reduce_window lowering bit for bit, and JAX's einsum
    lowering lands on the same disparities)."""
    left, right, _, d = _golden_scene(golden)
    jax_pipe = jax_cli.create_pipeline("census", reducer, "cvf",
                                       max_disparity=d)
    ref = np.asarray(jax_pipe.estimate(left, right))
    port_pipe = convert.pipeline_from_jax(jax_pipe, device="cpu")
    assert isinstance(port_pipe.aggregation, CostFilter)
    assert port_pipe.aggregation.wedge_offset == 0
    disp = port_pipe.estimate(left, right).numpy()
    assert int((disp != ref).sum()) <= ref.size // 10_000
    direct = cli_common.create_pipeline("census", reducer, "cvf",
                                        max_disparity=d, device="cpu")
    np.testing.assert_array_equal(direct.estimate(left, right).numpy(), disp)


def test_convert_carries_the_new_stages():
    jax_pipe = jax_cli.create_pipeline("census", "dyn", "cvf",
                                       max_disparity=24, cvf_radius=5,
                                       cvf_eps=3e-4, census_window=7)
    jax_pipe.cost.kernel_size = 3
    port = convert.pipeline_from_jax(jax_pipe, device="cpu")
    assert isinstance(port.cost, Census)
    assert (port.cost.max_disparity, port.cost.window_size,
            port.cost.kernel_size) == (24, 7, 3)
    agg = port.aggregation
    assert (agg.radius, agg.eps, agg.subsample, agg.wedge_offset) == (
        5, 3e-4, 1, 0)
    assert isinstance(port.disparity_reduce, DynamicProgramming)
    left, right, _ = stereo_pair(30, 48, 24, seed=6)
    np.testing.assert_array_equal(port.estimate(left, right).numpy(),
                                  np.asarray(jax_pipe.estimate(left, right)))
