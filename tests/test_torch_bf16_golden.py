"""Golden bf16 disparities at teddy size, for the port.

``tests/data/golden_torch_bf16_teddy.npz`` holds the disparities of three
paths on bf16 volumes, made by the JAX package's XLA ops on the CPU from
the golden teddy scene (375x450, D=128, seed 2026): SSD (k = 7) -> SGM
(P1 = 0.1, P2 = 0.2) -> WTA (``"ssd_sgm_wta"``) and -> DP
(``"ssd_sgm_dyn"``), and census (window 5) -> CVF (r = 8, eps = 1e-4,
the wedge, ``use_mxu=False``) -> WTA (``"census_cvf_wta"``), with each
path's bad-pixel rate against the scene's ground truth and the
parameters.  The port's plain versions equal those ops bit for bit, so
its plain path is held to every pixel here, and ``chip_smoke.py`` holds
the card's bf16 paths to the same 0 pixels without importing JAX.

Regenerate (only when the JAX package's semantics change on purpose):

    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_golden
"""

from pathlib import Path

import numpy as np
import pytest

from .torch_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "golden_torch_bf16_teddy.npz"
PARAMS = dict(height=375, width=450, max_disparity=128, seed=2026,
              kernel_size=7, penalty1=0.1, penalty2=0.2, census_window=5,
              cvf_radius=8, cvf_eps=1e-4)
# path -> (cost, reducer, aggregation), as create_pipeline names them.
PATHS = {"ssd_sgm_wta": ("ssd", "wta", "sgm"),
         "ssd_sgm_dyn": ("ssd", "dyn", "sgm"),
         "census_cvf_wta": ("census", "wta", "cvf")}


def _scene():
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    return stereo_pair(PARAMS["height"], PARAMS["width"],
                       PARAMS["max_disparity"], seed=PARAMS["seed"])


def _bad_pixel(disp, gt):
    d = PARAMS["max_disparity"]
    return float(np.mean((np.abs(disp - gt) > 1)[:, d:]))


def _jax_disparity(path, left, right):
    """The path through the JAX package's XLA ops, volumes in bf16."""
    import jax.numpy as jnp
    from stereomatch_tpu.ops import aggregation, cost, cvf, disparity
    d = PARAMS["max_disparity"]
    if path == "census_cvf_wta":
        vol = cost.census_hamming_cost_volume(
            left, right, max_disparity=d,
            window_size=PARAMS["census_window"], cost_dtype=jnp.bfloat16)
        agg = cvf.guided_filter_aggregate(
            vol, left, radius=PARAMS["cvf_radius"], eps=PARAMS["cvf_eps"],
            wedge_offset=0, use_mxu=False)
        return np.asarray(disparity.winner_takes_all(agg))
    vol = cost.ssd_cost_volume(left, right, max_disparity=d,
                               kernel_size=PARAMS["kernel_size"],
                               cost_dtype=jnp.bfloat16)
    agg = aggregation.semiglobal_aggregate(vol, left,
                                           penalty1=PARAMS["penalty1"],
                                           penalty2=PARAMS["penalty2"])
    reduce = (disparity.winner_takes_all if path == "ssd_sgm_wta"
              else disparity.dynamic_programming)
    return np.asarray(reduce(agg))


def make_golden(path: Path = GOLDEN) -> None:
    left, right, gt = _scene()
    arrays = {}
    for name in PATHS:
        disp = _jax_disparity(name, left, right)
        arrays[name] = disp
        arrays[f"bad_pixel_{name}"] = _bad_pixel(disp, gt)
    np.savez_compressed(path, **arrays, **PARAMS)


def test_golden_parameters_and_accuracy():
    """Each bf16 path within one point of bad-pixel rate of its float32
    golden (tests/data/golden_teddy_disparity.npz, golden_torch_cvf_teddy
    .npz)."""
    g = np.load(GOLDEN)
    assert {k: g[k].item() for k in PARAMS} == PARAMS
    _, _, gt = _scene()
    f32 = np.load(GOLDEN.parent / "golden_teddy_disparity.npz")
    f32_cvf = np.load(GOLDEN.parent / "golden_torch_cvf_teddy.npz")
    float32 = {"ssd_sgm_wta": f32["wta"], "ssd_sgm_dyn": f32["dp"],
               "census_cvf_wta": f32_cvf["census_cvf_wta"]}
    for name in PATHS:
        assert g[name].shape == (PARAMS["height"], PARAMS["width"])
        assert _bad_pixel(g[name], gt) == float(g[f"bad_pixel_{name}"])
        assert float(g[f"bad_pixel_{name}"]) <= \
            _bad_pixel(float32[name], gt) + 0.01


@pytest.mark.parametrize("name", PATHS)
def test_jax_reproduces_golden(name):
    g = np.load(GOLDEN)
    left, right, _ = _scene()
    np.testing.assert_array_equal(_jax_disparity(name, left, right), g[name])


@pytest.mark.parametrize("name", PATHS)
def test_port_plain_path_matches_golden(name):
    """The port's bf16 pipeline on the CPU, through the entry point a
    user calls: every pixel."""
    from stereomatch_tpu_torch import cli_common
    g = np.load(GOLDEN)
    left, right, gt = _scene()
    cost, reducer, aggr = PATHS[name]
    pipe = cli_common.create_pipeline(
        cost, reducer, aggr, max_disparity=PARAMS["max_disparity"],
        penalty1=PARAMS["penalty1"], penalty2=PARAMS["penalty2"],
        cvf_radius=PARAMS["cvf_radius"], cvf_eps=PARAMS["cvf_eps"],
        census_window=PARAMS["census_window"], volume_dtype="bfloat16",
        device="cpu")
    if cost == "ssd":
        pipe.cost.kernel_size = PARAMS["kernel_size"]
    disp = pipe.estimate(left, right).numpy()
    np.testing.assert_array_equal(disp, g[name])
    assert _bad_pixel(disp, gt) == float(g[f"bad_pixel_{name}"])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN}")
