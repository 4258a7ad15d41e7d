"""The port's ``stm-eval`` (``python -m stereomatch_tpu_torch.cli.evaluate``)
against the JAX package's evaluator, offline, on the CPU.

Both CLIs run the same arguments (the port's with ``--device cpu``) on
generated scenes (``--synthetic``) and on a Middlebury-format directory
and a KITTI-layout one built here; each JSON row's metrics, per scene
and averaged, must agree within 1e-6 relative (the metrics' float32
sums run in another order), and the configs' names must be the same.
Every cost family, ``pyramidN`` configs and ``--tune`` run; the tuned
penalties agree with the JAX CLI's within the tuner's tolerance, 2e-5
relative (``tests/test_torch_tune.py``).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stereomatch_tpu.cli import evaluate as jax_evaluate
from stereomatch_tpu.io.synthetic import stereo_pair
from stereomatch_tpu_torch.cli import evaluate

from .torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SYNTHETIC = ["--synthetic", "2", "--synthetic-size", "32x48x16"]
METRICS = ("rmse", "avg_abs_error", "bad_pixel_ratio", "ause")


def _rows(main, args, path):
    assert main(args + ["--json", str(path)]) == 0
    return json.loads(Path(path).read_text())


def _hold(tmp_path, args):
    ref = _rows(jax_evaluate.main, args, tmp_path / "jax.json")
    out = _rows(evaluate.main, args + ["--device", "cpu"],
                tmp_path / "port.json")
    assert [r["name"] for r in out] == [r["name"] for r in ref]
    for row, want in zip(out, ref):
        assert row.keys() == want.keys()
        pairs = [(row, want)] + list(zip(row["scenes"], want["scenes"]))
        for got, exp in pairs:
            for key in METRICS:
                if key in exp:
                    assert got[key] == pytest.approx(exp[key], rel=1e-6,
                                                     abs=1e-12), \
                        (row["name"], key)
    return out


def test_synthetic_default_configs(tmp_path, capsys):
    rows = _hold(tmp_path, SYNTHETIC)
    assert [r["name"] for r in rows] == ["ssd-wta", "ssd-dyn", "ssd-dyn-sgm"]
    assert "| ssd-dyn-sgm |" in capsys.readouterr().out


@pytest.mark.parametrize("configs,extra", [
    ("ssd:wta:sgm+refine,ssd:dyn:sgm+refine", []),
    ("ssd:wta:sgm+wmf,ssd:wta:sgm+wmf+refine", ["--wmf-sigma", "0.2"]),
    ("ssd:wta:sgm+fgs,ssd:dyn:sgm+fgs+refine", ["--fgs-lambda", "8"]),
    ("ssd:wta+speckle,ssd:wta:sgm+refine+speckle", []),
    ("census:wta:cvf+refine,sad:dyn", ["--cvf-radius", "3"]),
    ("ssd:wta:sgm,census:wta:sgm+refine", ["--dtype", "bfloat16"]),
], ids=["refine", "wmf", "fgs", "speckle", "cvf", "bf16"])
def test_synthetic_modifiers_and_confidence(tmp_path, configs, extra):
    rows = _hold(tmp_path, SYNTHETIC + ["--configs", configs,
                                        "--confidence"] + extra)
    assert all("ause" in r for r in rows)


def test_textured_scenes_and_bad_threshold(tmp_path):
    _hold(tmp_path, SYNTHETIC + ["--synthetic-texture", "textured",
                                 "--bad-threshold", "1",
                                 "--configs", "ssd:wta:sgm+wmf+refine"])


@pytest.fixture(scope="module")
def middlebury_dir(tmp_path_factory):
    from PIL import Image
    from stereomatch_tpu_torch.io.data import write_pfm
    root = tmp_path_factory.mktemp("middlebury")
    for i, seed in enumerate([3, 11]):
        left, right, gt = stereo_pair(32, 48, 16, seed=seed)
        scene = root / f"scene{i}"
        scene.mkdir()
        Image.fromarray((left * 255).astype(np.uint8)).save(scene / "im0.png")
        Image.fromarray((right * 255).astype(np.uint8)).save(
            scene / "im1.png")
        write_pfm(scene / "disp0.pfm", gt.astype(np.float32))
        write_pfm(scene / "disp1.pfm", gt.astype(np.float32))
        (scene / "calib.txt").write_text("width=48\nheight=32\nndisp=16\n")
    return root


def test_middlebury_dataset_and_cache(tmp_path, middlebury_dir):
    cache = tmp_path / "cache"
    args = [str(middlebury_dir), "--configs", "ssd:wta,ssd:wta:sgm+refine",
            "--confidence"]
    first = _hold(tmp_path, args + ["--cache", str(cache)])
    cached = sorted(p.name for p in cache.iterdir())
    assert len(cached) == 8 and any(n.endswith("_conf.npy") for n in cached)
    again = _rows(evaluate.main, args + ["--cache", str(cache), "--device",
                                         "cpu"], tmp_path / "again.json")
    assert again == first


def test_kitti_layout(tmp_path):
    from PIL import Image
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (tmp_path / sub).mkdir()
    left, right, gt = stereo_pair(32, 48, 16, seed=5)
    name = "000000_10.png"
    Image.fromarray((left * 255).astype(np.uint8)).save(
        tmp_path / "image_2" / name)
    Image.fromarray((right * 255).astype(np.uint8)).save(
        tmp_path / "image_3" / name)
    Image.fromarray((gt * 256).astype(np.uint16)).save(
        tmp_path / "disp_occ_0" / name)
    out = tmp_path / "out"
    out.mkdir()
    _hold(out, [str(tmp_path), "--format", "kitti", "--max-disparity", "16",
                "--configs", "ssd:wta:sgm"])


@pytest.mark.parametrize("args,item", [
    (["--synthetic", "1", "--tune", "2"], "A.11"),
    (["--synthetic", "1", "--configs", "pyramid2"], "A.12"),
    (["--synthetic", "1", "--configs", "ssd:wta,pyramid+refine"], "A.12"),
    (["--synthetic", "1", "--configs", "ncc:wta"], None),
], ids=["tune", "pyramid", "pyramid-late", "ncc"])
def test_unported_options_refuse_with_status_2(args, item, tmp_path):
    """The options that once refused, each ported since (``ncc``: A.8;
    ``--tune``: A.11; ``pyramidN``: A.12), now run and equal the JAX
    CLI: its metrics and config names, and ``--tune``'s penalties."""
    rows = _hold(tmp_path, args + ["--synthetic-size", "32x48x16"])
    if item == "A.11":
        ref = json.loads((tmp_path / "jax.json").read_text())
        assert [r["name"] for r in rows][-1] == "ssd-dyn-sgm-tuned"
        for row, want in zip(rows, ref):
            for key in ("penalty1", "penalty2"):
                assert (key in row) == (key in want)
                if key in want:
                    assert row[key] == pytest.approx(want[key], rel=2e-5)
    elif item == "A.12":
        assert rows[-1]["name"].startswith("pyramid")


def test_tune_with_pyramid_and_census_configs(tmp_path, capsys):
    """--tune tunes each SGM cost once (census here), leaves the other
    configs untuned, and mixes with pyramid and speckle configs."""
    args = ["--synthetic", "2", "--synthetic-size", "32x48x16", "--tune",
            "1", "--tune-steps", "5", "--configs",
            "census:wta:sgm,census:wta:sgm+refine,pyramid1+speckle,ssd:wta"]
    rows = _hold(tmp_path, args)
    assert [r["name"] for r in rows] == [
        "census-wta-sgm-tuned", "census-wta-sgm-tuned-refine",
        "pyramid1-speckle", "ssd-wta"]
    assert rows[0]["penalty1"] == rows[1]["penalty1"]
    assert evaluate.main(["--tune", "1", "--device", "cpu"]) == 2
    assert "--synthetic" in capsys.readouterr().err
    assert evaluate.main(["--synthetic", "1", "--synthetic-size", "32x48x16",
                          "--configs", "pyramid", "--confidence",
                          "--device", "cpu"]) == 2


def test_usage_errors(capsys):
    assert evaluate.main(["--device", "cpu"]) == 2
    assert "--synthetic" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        evaluate.main(["--synthetic", "1", "--device", "tpu"])


@pytest.mark.parametrize("spec", [
    "ssd:wta", "ssd:wta:sgm+refine+speckle", "census:dyn:cvf+wmf+fgs",
    "pyramid", "pyramid3+refine", "ssd:wta,sad:dyn:sgm+fgs"])
def test_parse_configs_grammar_equals_jax(spec):
    assert evaluate.parse_configs(spec) == jax_evaluate.parse_configs(spec)
    assert evaluate.DEFAULT_CONFIGS == jax_evaluate.DEFAULT_CONFIGS


@pytest.mark.parametrize("spec", ["ssd:wta+blur", "ssd", "a:b:c:d",
                                  "pyramid:ssd", "pyramid+wmf", "pyramidx"])
def test_parse_configs_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jax_evaluate.parse_configs(spec)
    with pytest.raises(ValueError):
        evaluate.parse_configs(spec)


def test_runs_as_a_module_without_jax(tmp_path):
    """``python -m stereomatch_tpu_torch.cli.evaluate`` in a process of
    its own: exit 0, and JAX never imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['evaluate'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('stereomatch_tpu_torch.cli.evaluate',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as exit_:\n"
            "    assert 'jax' not in sys.modules\n"
            "    raise\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "--synthetic", "1",
         "--synthetic-size", "24x40x16", "--configs", "ssd:wta:sgm+refine",
         "--device", "cpu", "--json", str(tmp_path / "rows.json")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert rows[0]["name"] == "ssd-wta-sgm-refine"
