"""Golden refined disparities at teddy size, for the port.

``tests/data/golden_torch_refined_teddy.npz`` holds the output of the
JAX package's ``Pipeline.estimate_refined`` over SSD (k = 7) -> SGM
(P1 = 0.1, P2 = 0.2) -> WTA on the golden teddy scene (375x450, D=128,
seed 2026), made by its XLA path on the CPU, for three flag sets:
the default (3x3 median, then sub-pixel: float32), the LR check in
volume mode with the background fill (then the default stages), and the
confidence gate at 0.1 (then the default stages), with the parameters.
The port's plain path is held to every pixel here, and ``chip_smoke.py``
holds the card's to the same 0 pixels without importing JAX.

Regenerate (only when the JAX package's semantics change on purpose):

    JAX_PLATFORMS=cpu python -m tests.test_torch_refined_golden
"""

from pathlib import Path

import numpy as np
import pytest

from .torch_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "data" / "golden_torch_refined_teddy.npz"
PARAMS = dict(height=375, width=450, max_disparity=128, seed=2026,
              kernel_size=7, penalty1=0.1, penalty2=0.2)
# name -> estimate_refined keywords.
FLAG_SETS = {"default": {},
             "lr_volume": dict(lr_check=True, lr_mode="volume"),
             "min_confidence": dict(min_confidence=0.1)}


def _scene():
    from stereomatch_tpu_torch.io.synthetic import stereo_pair
    return stereo_pair(PARAMS["height"], PARAMS["width"],
                       PARAMS["max_disparity"], seed=PARAMS["seed"])


def _pipeline(cli_common, **kw):
    pipe = cli_common.create_pipeline(
        "ssd", "wta", "sgm", max_disparity=PARAMS["max_disparity"],
        penalty1=PARAMS["penalty1"], penalty2=PARAMS["penalty2"], **kw)
    pipe.cost.kernel_size = PARAMS["kernel_size"]
    return pipe


def make_golden(path: Path = GOLDEN) -> None:
    from stereomatch_tpu import cli_common
    left, right, _ = _scene()
    pipe = _pipeline(cli_common)
    arrays = {name: np.asarray(pipe.estimate_refined(left, right, **flags))
              for name, flags in FLAG_SETS.items()}
    np.savez_compressed(path, **arrays, **PARAMS)


def test_golden_parameters_and_accuracy():
    """Each refined map is float32 in [0, D) at the scene's shape; the
    default one is as accurate as the integer golden
    (tests/data/golden_teddy_disparity.npz); the gate zeroes some pixels
    and keeps the default's value at the rest."""
    g = np.load(GOLDEN)
    assert {k: g[k].item() for k in PARAMS} == PARAMS
    wta = np.load(GOLDEN.parent / "golden_teddy_disparity.npz")["wta"]
    _, _, gt = _scene()
    d = PARAMS["max_disparity"]
    for name in FLAG_SETS:
        out = g[name]
        assert out.dtype == np.float32
        assert out.shape == (PARAMS["height"], PARAMS["width"])
        assert out.min() >= 0 and out.max() < d
    bad = np.mean((np.abs(g["default"] - gt) > 1)[:, d:])
    assert bad <= np.mean((np.abs(wta - gt) > 1)[:, d:]) + 0.001
    gated = g["min_confidence"] == 0
    assert 0 < gated.sum() < gated.size
    np.testing.assert_array_equal(g["min_confidence"][~gated],
                                  g["default"][~gated])


@pytest.mark.parametrize("name", FLAG_SETS)
def test_jax_reproduces_golden(name):
    from stereomatch_tpu import cli_common
    g = np.load(GOLDEN)
    left, right, _ = _scene()
    out = _pipeline(cli_common).estimate_refined(left, right,
                                                 **FLAG_SETS[name])
    np.testing.assert_array_equal(np.asarray(out), g[name])


@pytest.mark.parametrize("name", FLAG_SETS)
def test_port_plain_path_matches_golden(name):
    """The port's pipeline on the CPU, through the entry point a user
    calls: every pixel."""
    from stereomatch_tpu_torch import cli_common
    g = np.load(GOLDEN)
    left, right, _ = _scene()
    out = _pipeline(cli_common, device="cpu").estimate_refined(
        left, right, **FLAG_SETS[name])
    np.testing.assert_array_equal(out.numpy(), g[name])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN}")
