"""The port runs where JAX is not installed.

Importing ``stereomatch_tpu_torch`` (every module of it) must leave JAX
out of ``sys.modules``, ``chip_smoke.py`` must import neither JAX nor
the JAX package, and the numpy-only scene generator the port carries
must stay byte-identical in behaviour to the JAX package's, which the
golden anchors were generated from.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

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
        "import stereomatch_tpu_torch.parallel\n"
        "import stereomatch_tpu_torch.parallel.mesh\n"
        "import stereomatch_tpu_torch.parallel.halo\n"
        "import stereomatch_tpu_torch.parallel.sharded\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m == 'jax' or m.startswith('jax.')\n"
        "                        or m.startswith('stereomatch_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    source = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    tree = ast.parse(source.read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            modules.add(node.module)
    assert "stereomatch_tpu_torch" in modules
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "stereomatch_tpu")]


@pytest.mark.parametrize("shape,seed", [((375, 450, 128), 2026),
                                        ((37, 53, 24), 5)])
def test_synthetic_scene_byte_identical(shape, seed):
    ref = jax_synthetic.stereo_pair(*shape, seed=seed)
    out = port_synthetic.stereo_pair(*shape, seed=seed)
    for a, b in zip(ref, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
