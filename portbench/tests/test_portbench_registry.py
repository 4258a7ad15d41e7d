"""Configurations, traffic mixes and metrics are found by name, and a
new one is added as files alone."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import registry, run
from stereomatch_tpu_torch.stream import StreamingEstimator

ROOT = registry.ROOT
BENCH = registry.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    found = registry.find_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert found.config["name"] == entry["config"]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert {m.name for m in found.end_to_end} == {
        m["name"] for m in BENCH["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert "setup_s" in {m.name for m in found.end_to_end}
    assert len(found.end_to_end) >= 2 and found.per_layer
    assert {m.name for m in found.per_layer} == {
        m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    for metric in found.end_to_end + found.per_layer:
        assert callable(metric.read)
    assert callable(found.reference)


def test_config_files_hold_what_the_entries_say():
    for entry in BENCH["configs"]:
        path = ROOT / entry["file"]
        assert path == registry.config_file(BENCH, entry["name"])
        config = json.loads(path.read_text())
        assert config["name"] == entry["name"]
        assert config["source"] == entry["source"]
        assert entry["reduced"] == []
        assert callable(registry.reference_disparity(config["reference"]))


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_files_dropped_into_a_copy_are_picked_up(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "portbench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    base = tmp_path / "portbench" / "configs" / "teddy-ssd-sgm.json"
    config = dict(json.loads(base.read_text()), name="vga-ssd-sgm",
                  height=480, width=640)
    (tmp_path / "portbench" / "configs" / "vga-ssd-sgm.json").write_text(
        json.dumps(config))
    (tmp_path / "portbench" / "traffic" / "stream4.json").write_text(
        json.dumps({"loop": "closed", "batch": 4, "depth": 3, "pool": 8}))
    (tmp_path / "portbench" / "metrics" / "fetch_ms.py").write_text(
        "def read(record):\n"
        "    s = record['stream']\n"
        "    return s['fetch_s'] / s['frames'] * 1e3\n")
    bench["configs"].append({"name": "vga-ssd-sgm", "source": "x",
                             "file": "portbench/configs/vga-ssd-sgm.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "vga-ssd-sgm.stream4",
                               "config": "vga-ssd-sgm",
                               "traffic": "stream4", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "fetch_ms", "unit": "ms/frame",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "stream", "moves": "fps",
                               "workloads": ["vga-ssd-sgm.stream4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.find_cell("vga-ssd-sgm.stream4", root=tmp_path)
    assert (cell.config["height"], cell.config["width"]) == (480, 640)
    assert cell.traffic["batch"] == 4
    assert [m.name for m in cell.per_layer] == ["fetch_ms"]
    record = {"stream": {"fetch_s": 0.5, "frames": 100}}
    assert registry.read_metrics(cell.per_layer, record) == {
        "fetch_ms": {"value": 5.0, "unit": "ms/frame"}}
    # The cells already there are unchanged, and so is every file.
    old = registry.find_cell("teddy-ssd-sgm.stream8", root=tmp_path)
    assert "fetch_ms" not in {m.name for m in old.per_layer}
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_new_estimator_option_and_reference_need_no_edit(tmp_path):
    # A configuration whose ``estimator`` object holds an option that no
    # file of the benchmark names, judged by a reference file that no
    # file of the benchmark knows: both are files dropped into a copy,
    # and a whole run over them is correct.
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "portbench")
    config = dict(json.loads(
        (ROOT / "portbench/configs/teddy-ssd-sgm.json").read_text()),
        name="tiny-ssd-box", height=20, width=40, max_disparity=8,
        reference="ssd_box")
    config["estimator"] = {"cost": "ssd", "kernel_size": 3,
                           "aggregation": None, "reducer": "wta",
                           "fetch_workers": 1}
    (tmp_path / "portbench/configs/tiny-ssd-box.json").write_text(
        json.dumps(config))
    (tmp_path / "portbench/reference/ssd_box.py").write_text(
        "from portbench.reference.stereo import (ssd_volume,\n"
        "                                        winner_takes_all)\n\n\n"
        "def disparity(config, left, right):\n"
        "    k = config['estimator']['kernel_size']\n"
        "    return winner_takes_all(\n"
        "        ssd_volume(left, right, config['max_disparity'], k))\n")
    bench["configs"].append({"name": "tiny-ssd-box", "source": "x",
                             "file": "portbench/configs/tiny-ssd-box.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-ssd-box.stream8",
                               "config": "tiny-ssd-box",
                               "traffic": "stream8", "chips": 1,
                               "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.find_cell("tiny-ssd-box.stream8", root=tmp_path)
    assert cell.reference.__module__.endswith("ssd_box")
    cell = cell._replace(traffic=dict(cell.traffic, pool=4, batch=2))
    seen = {}

    class Spy(StreamingEstimator):
        def __init__(self, *args, **kwargs):
            seen.update(kwargs)
            super().__init__(*args, **kwargs)

    _, checks, result = run.measure(cell, 3, 60.0, False, "cpu",
                                    time.perf_counter(), frames=4,
                                    estimator_cls=Spy)
    assert seen["fetch_workers"] == 1 and seen["aggregation"] is None
    assert all(c.ok for c in checks), checks
    assert result["failed"] == 0
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_variant_metric_is_read_by_its_base_file():
    base = registry.metric_reader("device_idle_share")
    variant = registry.metric_reader("device_idle_share.live")
    record = {"trace": {"busy_s": 0.75, "window_s": 1.0}}
    assert variant(record) == base(record) == 25.0
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no_such_metric.live")


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    cell = registry.find_cell("teddy-ssd-sgm.stream8")
    assert registry.read_metrics(cell.per_layer,
                                 {"config": cell.config}) == {}


@pytest.mark.parametrize("name", ["../run", "a/b", "", "x y"])
def test_bad_names_are_refused(name):
    with pytest.raises(ValueError):
        registry.metric_reader(name)
