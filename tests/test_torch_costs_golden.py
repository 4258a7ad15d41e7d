"""Golden teddy disparities of the Birchfield, ZNCC and SSD-over-textures
paths, for the port.

``tests/data/golden_torch_costs_teddy.npz`` holds the disparities of
five ``create_pipeline`` paths made by the JAX package's XLA path on the
CPU from the golden teddy scene (375x450, D=128, seed 2026; SGM P1 =
0.1, P2 = 0.2; CVF r = 8, eps = 1e-4; each cost with its default
window): birchfield, ncc and ssd-texture -> sgm -> wta, birchfield ->
sgm -> dyn and ncc -> cvf -> wta, with the bad-pixel rate of each
against the scene's ground truth and the parameters.  ``chip_smoke.py``
holds the card's paths to it without importing JAX.

Gates, for the port's plain path on the CPU (and the card's):

* birchfield and ssd-texture: 0 pixels.  Their volumes are the JAX
  package's bit for bit.
* ncc: the count measured on the port's CPU path, 0 for both paths.
  At 375 rows the JAX package sums ZNCC's volume row box as a banded
  matrix product (H <= 512), which departs from the sequential window
  sum the port takes: measured here, 63,705 of the volume's 21,600,000
  cells (0.29%) differ, by at most 2.9802322e-07 absolute (the costs
  lie in [0, 2]; 2.5 units in the last place of 1.0), with the +inf
  cells identical (``test_ncc_teddy_volume_within_its_measured_bound``).
  Neither the SGM minimum nor, through CVF (whose own banded-matrix box
  sums stay within 1e-4 of the port's, ``tests/test_torch_cvf.py``),
  the WTA minimum moves at any pixel.

Regenerate (only when the JAX package's semantics change on purpose):

    JAX_PLATFORMS=cpu python -m tests.test_torch_costs_golden
"""

from pathlib import Path

import numpy as np
import pytest

from .torch_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "golden_torch_costs_teddy.npz"
PARAMS = dict(height=375, width=450, max_disparity=128, seed=2026,
              penalty1=0.1, penalty2=0.2, cvf_radius=8, cvf_eps=1e-4)
# name -> (cost, reducer, aggregation)
PATHS = {"birchfield_sgm_wta": ("birchfield", "wta", "sgm"),
         "ncc_sgm_wta": ("ncc", "wta", "sgm"),
         "ssd_texture_sgm_wta": ("ssd-texture", "wta", "sgm"),
         "birchfield_sgm_dyn": ("birchfield", "dyn", "sgm"),
         "ncc_cvf_wta": ("ncc", "wta", "cvf")}
# Pixels of 168,750 that the port's path may differ from the golden
# (for ncc: the count measured on the port's CPU path).
MAX_DIFF = {"birchfield_sgm_wta": 0, "ssd_texture_sgm_wta": 0,
            "birchfield_sgm_dyn": 0, "ncc_sgm_wta": 0, "ncc_cvf_wta": 0}
# The teddy ZNCC volume against the JAX package's: cells that differ and
# their largest absolute difference, measured on the CPU.
NCC_VOLUME_CELLS = 63705
NCC_VOLUME_MAX_ABS = 5 * 2.0 ** -24      # 2.9802322e-07


def _scene():
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    return stereo_pair(PARAMS["height"], PARAMS["width"],
                       PARAMS["max_disparity"], seed=PARAMS["seed"])


def _bad_pixel(disp, gt):
    d = PARAMS["max_disparity"]
    return float(np.mean((np.abs(disp - gt) > 1)[:, d:]))


def _pipeline(cli_common, name, **kw):
    cost, reducer, aggr = PATHS[name]
    return cli_common.create_pipeline(
        cost, reducer, aggr, max_disparity=PARAMS["max_disparity"],
        penalty1=PARAMS["penalty1"], penalty2=PARAMS["penalty2"],
        cvf_radius=PARAMS["cvf_radius"], cvf_eps=PARAMS["cvf_eps"], **kw)


def make_golden(path: Path = GOLDEN) -> None:
    from stereomatch_tpu import cli_common
    left, right, gt = _scene()
    arrays = {}
    for name in PATHS:
        disp = np.asarray(_pipeline(cli_common, name,
                                    backend="xla").estimate(left, right))
        arrays[name] = disp
        arrays[f"bad_pixel_{name}"] = _bad_pixel(disp, gt)
    np.savez_compressed(path, **arrays, **PARAMS)


def test_golden_parameters_and_accuracy():
    g = np.load(GOLDEN)
    assert {k: g[k].item() for k in PARAMS} == PARAMS
    _, _, gt = _scene()
    for name in PATHS:
        disp = g[name]
        assert disp.shape == (PARAMS["height"], PARAMS["width"])
        assert disp.min() >= 0 and disp.max() < PARAMS["max_disparity"]
        assert _bad_pixel(disp, gt) == float(g[f"bad_pixel_{name}"])
        if name.endswith("wta"):
            assert float(g[f"bad_pixel_{name}"]) < 0.02


@pytest.mark.parametrize("name", list(PATHS))
def test_port_plain_path_matches_golden(name):
    from stereomatch_tpu_torch import cli_common
    g = np.load(GOLDEN)
    left, right, gt = _scene()
    disp = _pipeline(cli_common, name, device="cpu").estimate(
        left, right).numpy()
    assert int((disp != g[name]).sum()) <= MAX_DIFF[name]
    assert _bad_pixel(disp, gt) <= float(g[f"bad_pixel_{name}"]) + 1e-4


def test_ncc_teddy_volume_within_its_measured_bound():
    import torch
    from stereomatch_tpu.ops import cost as jax_ops
    from stereomatch_tpu_torch.ops import cost as ops
    left, right, _ = _scene()
    d = PARAMS["max_disparity"]
    ref = np.asarray(jax_ops.zncc_cost_volume(left, right, max_disparity=d))
    out = ops.zncc_cost_volume(torch.from_numpy(left),
                               torch.from_numpy(right),
                               max_disparity=d).numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), finite)
    np.testing.assert_array_equal(out[~finite], ref[~finite])
    assert int((out != ref).sum()) <= NCC_VOLUME_CELLS
    assert float(np.abs(out[finite] - ref[finite]).max()) <= \
        NCC_VOLUME_MAX_ABS


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN}")
