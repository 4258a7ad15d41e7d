"""The port's public surface against the JAX package's, and the
disparity-block building blocks it exposes.

Every name in the ``__all__`` of ``stereomatch_tpu``, ``.io``, ``.ops``
and ``.parallel`` exists in the port's module of the same name, except
the ``*_pallas`` entry points, whose counterparts are the CUDA launchers
(``ops/*_cuda.py``).  ``from stereomatch_tpu_torch.io import load_image``
works where PIL is not installed.  The plain ``ssd_cost_volume``,
``sad_cost_volume`` and ``census_hamming_cost_volume`` take the JAX
package's ``disparity_offset`` and equal its volumes bit for bit at each
offset, the blocks at increasing offsets concatenating to the full
volume (``tests/test_parallel.py:316``); ``ssd_texture_cost_volume``
equals JAX's.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu.texture import TextureImage as JaxTexture
from stereomatch_tpu_torch.ops import cost as port_cost
from stereomatch_tpu_torch.texture import TextureImage

from .torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("module", ["", ".io", ".ops", ".parallel"])
def test_every_jax_name_exists_in_the_port(module):
    jax_mod = importlib.import_module("stereomatch_tpu" + module)
    port_mod = importlib.import_module("stereomatch_tpu_torch" + module)
    wanted = [n for n in jax_mod.__all__ if not n.endswith("_pallas")]
    assert wanted
    missing = [n for n in wanted if not hasattr(port_mod, n)]
    assert not missing, f"stereomatch_tpu_torch{module} lacks {missing}"
    exported = set(getattr(port_mod, "__all__", ()))
    assert not [n for n in wanted if n not in exported]


def test_io_names_load_without_pil_or_opencv():
    code = ("import sys\n"
            "sys.modules['PIL'] = None\n"
            "sys.modules['cv2'] = None\n"
            "from stereomatch_tpu_torch.io import load_image, read_pfm\n"
            "import stereomatch_tpu_torch as p\n"
            "print(p.io.load_image is load_image, p.metrics.__name__,\n"
            "      p.reconstruction.__name__, p.utils.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "stereomatch_tpu_torch.metrics",
                                  "stereomatch_tpu_torch.reconstruction",
                                  "stereomatch_tpu_torch.utils"]


def _images(shape=(16, 40), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random(shape).astype(np.float32))


VOLUMES = {
    "ssd": (jax_cost.ssd_cost_volume, port_cost.ssd_cost_volume,
            dict(kernel_size=3)),
    "sad": (jax_cost.sad_cost_volume, port_cost.sad_cost_volume,
            dict(kernel_size=3)),
    "census": (jax_cost.census_hamming_cost_volume,
               port_cost.census_hamming_cost_volume, {}),
    "census-box": (jax_cost.census_hamming_cost_volume,
                   port_cost.census_hamming_cost_volume,
                   dict(kernel_size=2)),
}


@pytest.mark.parametrize("name", VOLUMES)
def test_offset_blocks_equal_jax_and_tile_the_full_volume(name):
    jax_fn, port_fn, kw = VOLUMES[name]
    left, right = _images()
    full = port_fn(torch.from_numpy(left), torch.from_numpy(right),
                   max_disparity=16, **kw)
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jax_fn(left, right, max_disparity=16,
                                        **kw)))
    blocks = []
    for offset in (0, 4, 8, 12):
        got = port_fn(torch.from_numpy(left), torch.from_numpy(right),
                      max_disparity=4, disparity_offset=offset, **kw)
        want = np.asarray(jax_fn(left, right, max_disparity=4,
                                 disparity_offset=offset, **kw))
        np.testing.assert_array_equal(got.numpy(), want)
        blocks.append(got)
    assert torch.equal(torch.cat(blocks, dim=2), full)


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
def test_offset_blocks_in_the_other_dtypes(dtype):
    """Integer (int32 max beyond the wedge) and bf16 blocks tile the full
    volume of their dtype."""
    rng = np.random.default_rng(1)
    left = torch.from_numpy(rng.integers(0, 255, (12, 30), dtype=np.int32))
    right = torch.from_numpy(rng.integers(0, 255, (12, 30), dtype=np.int32))
    if dtype == torch.bfloat16:
        left, right = left / 255.0, right / 255.0
    for fn in (port_cost.ssd_cost_volume, port_cost.sad_cost_volume):
        full = fn(left, right, max_disparity=12, kernel_size=2,
                  cost_dtype=dtype)
        blocks = [fn(left, right, max_disparity=3, kernel_size=2,
                     cost_dtype=dtype, disparity_offset=o)
                  for o in (0, 3, 6, 9)]
        assert torch.equal(torch.cat(blocks, dim=2), full)
    # An offset past the width leaves every cell beyond the wedge.
    far = port_cost.ssd_cost_volume(left, right, max_disparity=2,
                                    disparity_offset=40, cost_dtype=dtype)
    inf = port_cost.inf_value(dtype)
    assert bool((far == inf).all())


def test_ssd_texture_cost_volume_equals_jax():
    left, right = _images((12, 20), seed=2)
    got = port_cost.ssd_texture_cost_volume(
        TextureImage.from_array(left), TextureImage.from_array(right),
        max_disparity=8, kernel_size=3)
    want = jax_cost.ssd_texture_cost_volume(
        JaxTexture.from_array(left), JaxTexture.from_array(right),
        max_disparity=8, kernel_size=3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError):
        port_cost.ssd_texture_cost_volume(torch.zeros(4, 4),
                                          torch.zeros(4, 4),
                                          max_disparity=2)
