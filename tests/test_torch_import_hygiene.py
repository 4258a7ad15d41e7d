"""The port runs where JAX is not installed.

Importing ``stereomatch_tpu_torch`` (every module of it) must leave JAX
out of ``sys.modules``, and the numpy-only scene generator it carries
must stay byte-identical in behaviour to the JAX package's, which the
golden anchors were generated from.
"""

import json
import subprocess
import sys

import pytest

from stereomatch_tpu.io import synthetic as jax_synthetic
from stereomatch_tpu_torch.io import synthetic as port_synthetic


def test_import_leaves_jax_out():
    code = (
        "import sys, json\n"
        "import stereomatch_tpu_torch\n"
        "import stereomatch_tpu_torch.cli_common, stereomatch_tpu_torch.convert\n"
        "import stereomatch_tpu_torch.ops._build\n"
        "import stereomatch_tpu_torch.ops.ssd_cuda\n"
        "import stereomatch_tpu_torch.ops.sgm_cuda\n"
        "import stereomatch_tpu_torch.ops.dp_cuda\n"
        "import stereomatch_tpu_torch.ops.cvf_cuda\n"
        "import stereomatch_tpu_torch.ops.cvf, stereomatch_tpu_torch.ops.disparity\n"
        "import stereomatch_tpu_torch.io.synthetic\n"
        "import stereomatch_tpu_torch.utils.profiling\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m == 'jax' or m.startswith('jax.')\n"
        "                        or m.startswith('stereomatch_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("shape,seed", [((375, 450, 128), 2026),
                                        ((37, 53, 24), 5)])
def test_synthetic_scene_byte_identical(shape, seed):
    ref = jax_synthetic.stereo_pair(*shape, seed=seed)
    out = port_synthetic.stereo_pair(*shape, seed=seed)
    for a, b in zip(ref, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
