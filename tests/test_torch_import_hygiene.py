"""The port runs where JAX is not installed.

Importing ``stereomatch_tpu_torch`` (every module of it, the CLI
included) must leave JAX and the JAX package out of ``sys.modules``; no
source file of the port and not ``chip_smoke.py`` may import either; and
the numpy-only scene generator the port carries must stay byte-identical
in behaviour to the JAX package's, which the golden anchors were
generated from.
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
        "import stereomatch_tpu_torch.io.data\n"
        "import stereomatch_tpu_torch.io.calibration\n"
        "import stereomatch_tpu_torch.ops.refine\n"
        "import stereomatch_tpu_torch.metrics\n"
        "import stereomatch_tpu_torch.reconstruction\n"
        "import stereomatch_tpu_torch.cli.evaluate\n"
        "import stereomatch_tpu_torch.cli.image\n"
        "import stereomatch_tpu_torch.io.png\n"
        "import stereomatch_tpu_torch.texture\n"
        "import stereomatch_tpu_torch.utils.viz\n"
        "import stereomatch_tpu_torch.utils.backend\n"
        "import stereomatch_tpu_torch.utils.numeric\n"
        "import stereomatch_tpu_torch.utils.profiling\n"
        "import stereomatch_tpu_torch.utils.benchmarking\n"
        "import stereomatch_tpu_torch.parallel\n"
        "import stereomatch_tpu_torch.parallel.mesh\n"
        "import stereomatch_tpu_torch.parallel.halo\n"
        "import stereomatch_tpu_torch.parallel.transport\n"
        "import stereomatch_tpu_torch.parallel.sharded\n"
        "import stereomatch_tpu_torch.parallel.pyramid_sharded\n"
        "import stereomatch_tpu_torch.parallel.temporal_sharded\n"
        "import stereomatch_tpu_torch.parallel.disp_sharded\n"
        "import stereomatch_tpu_torch.parallel.tiled2d\n"
        "import stereomatch_tpu_torch.parallel.ici_model\n"
        "import stereomatch_tpu_torch.pyramid, stereomatch_tpu_torch.temporal\n"
        "import stereomatch_tpu_torch.tune, stereomatch_tpu_torch.ops.soft\n"
        "import stereomatch_tpu_torch.stream, stereomatch_tpu_torch.native\n"
        "import stereomatch_tpu_torch.io.capture\n"
        "import stereomatch_tpu_torch.cli.video\n"
        "import stereomatch_tpu_torch.cli.serve\n"
        "import stereomatch_tpu_torch.cli.fetch\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m in ('jax', 'optax', 'PIL', 'cv2',\n"
        "                                 'matplotlib')\n"
        "                        or m.startswith(('jax.', 'optax.', 'PIL.',\n"
        "                                         'cv2.', 'matplotlib.'))\n"
        "                        or m.startswith('stereomatch_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in
                      (ROOT / "stereomatch_tpu_torch").rglob("*.py"))


def _imported_modules(source: Path, in_functions: bool = True) -> set:
    """Every module an import statement of ``source`` names (relative
    imports resolved against its package); with ``in_functions`` False,
    only those run when the module is imported."""
    tree = ast.parse(source.read_text())
    package = source.relative_to(ROOT).with_suffix("").parts[:-1]
    skip = set()
    if not in_functions:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                skip.update(id(n) for n in ast.walk(node))
    modules = set()
    for node in ast.walk(tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Import):
            modules.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) - node.level + 1]
                        if node.level else [])
            modules.add(".".join(base + ([node.module] if node.module
                                         else [])))
    return modules


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_no_port_module_imports_jax(path):
    modules = _imported_modules(ROOT / path)
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                       "stereomatch_tpu")]


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_no_port_module_needs_pil_or_matplotlib(path):
    """The card's machine has neither, nor OpenCV: PNG goes through
    ``io/png.py``, colour maps through ``utils/viz.py``.  PIL is imported
    only inside the functions that read or write other image formats
    (``io/data.py``, ``stm-image``'s output check, ``stm-serve``'s
    request decoder), matplotlib only by ``stm-image -sd`` and
    ``stm-video``'s ``i`` key (interactive windows), OpenCV only by the
    camera and video-file captures and ``stm-video``'s display loop, each
    inside its branch."""
    on_import = {m.split(".")[0]
                 for m in _imported_modules(ROOT / path, in_functions=False)}
    assert not on_import & {"PIL", "matplotlib", "cv2"}
    modules = {m.split(".")[0] for m in _imported_modules(ROOT / path)}
    if path not in ("stereomatch_tpu_torch/io/data.py",
                    "stereomatch_tpu_torch/cli/image.py",
                    "stereomatch_tpu_torch/cli/serve.py"):
        assert "PIL" not in modules
    if path not in ("stereomatch_tpu_torch/cli/image.py",
                    "stereomatch_tpu_torch/cli/video.py"):
        assert "matplotlib" not in modules
    if path not in ("stereomatch_tpu_torch/io/capture.py",
                    "stereomatch_tpu_torch/cli/video.py"):
        assert "cv2" not in modules


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    source = ROOT / "chip_smoke.py"
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
