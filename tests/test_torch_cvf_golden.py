"""Golden census -> CVF -> WTA disparities at teddy size, for the port.

``tests/data/golden_torch_cvf_teddy.npz`` holds the disparities of
``create_pipeline("census", "wta", "cvf", max_disparity=128)`` made by
the JAX package on the CPU from the golden teddy scene (375x450, D=128,
seed 2026; census window 5, r = 8, eps = 1e-4), with the bad-pixel rate
against the scene's ground truth and the parameters.  ``chip_smoke.py``
holds the port's card path to it without importing JAX.

Regenerate (only when the JAX package's semantics change on purpose):

    JAX_PLATFORMS=cpu python -m tests.test_torch_cvf_golden
"""

from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).parent / "data" / "golden_torch_cvf_teddy.npz"
PARAMS = dict(height=375, width=450, max_disparity=128, seed=2026,
              census_window=5, cvf_radius=8, cvf_eps=1e-4)
PORT_MAX_DIFF = 16          # pixels of 168,750 (0.01%); 0 expected


def _scene():
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    return stereo_pair(PARAMS["height"], PARAMS["width"],
                       PARAMS["max_disparity"], seed=PARAMS["seed"])


def _bad_pixel(disp, gt):
    d = PARAMS["max_disparity"]
    return float(np.mean((np.abs(disp - gt) > 1)[:, d:]))


def _jax_disparity(left, right):
    from stereomatch_tpu import cli_common
    pipe = cli_common.create_pipeline(
        "census", "wta", "cvf", max_disparity=PARAMS["max_disparity"],
        cvf_radius=PARAMS["cvf_radius"], cvf_eps=PARAMS["cvf_eps"],
        census_window=PARAMS["census_window"])
    return np.asarray(pipe.estimate(left, right))


def make_golden(path: Path = GOLDEN) -> None:
    left, right, gt = _scene()
    disp = _jax_disparity(left, right)
    np.savez_compressed(path, census_cvf_wta=disp,
                        bad_pixel_vs_gt=_bad_pixel(disp, gt), **PARAMS)


def test_jax_reproduces_golden():
    g = np.load(GOLDEN)
    assert {k: g[k].item() for k in PARAMS} == PARAMS
    left, right, gt = _scene()
    disp = _jax_disparity(left, right)
    np.testing.assert_array_equal(disp, g["census_cvf_wta"])
    assert _bad_pixel(disp, gt) == float(g["bad_pixel_vs_gt"])
    assert float(g["bad_pixel_vs_gt"]) < 0.01


def test_port_plain_path_matches_golden():
    from stereomatch_tpu_torch import cli_common
    g = np.load(GOLDEN)
    left, right, gt = _scene()
    pipe = cli_common.create_pipeline(
        "census", "wta", "cvf", max_disparity=PARAMS["max_disparity"],
        cvf_radius=PARAMS["cvf_radius"], cvf_eps=PARAMS["cvf_eps"],
        census_window=PARAMS["census_window"], device="cpu")
    disp = pipe.estimate(left, right).numpy()
    assert int((disp != g["census_cvf_wta"]).sum()) <= PORT_MAX_DIFF
    assert _bad_pixel(disp, gt) <= float(g["bad_pixel_vs_gt"]) + 1e-4


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN}")
