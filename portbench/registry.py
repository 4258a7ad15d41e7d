"""Finds the parts of a cell by name, so that a configuration, a traffic
mix or a metric is added as files alone.

* ``BENCHMARK.json`` at the checkout's root names the cells, each with
  its ``config`` and ``traffic``, and the metrics with their units.
* A configuration is the JSON file its ``configs`` entry names
  (``portbench/configs/<config>.json``).  Its ``estimator`` object goes
  unchanged to ``StreamingEstimator``, and its ``reference`` names the
  plain reference that judges it, ``portbench/reference/<reference>.py``,
  a module whose ``disparity(config, left, right)`` gives the answers.
* A traffic mix is ``portbench/traffic/<traffic>.json``.
* A metric is ``portbench/metrics/<metric>.py``, a module whose
  ``read(record)`` returns the metric's value, or None where the record
  holds nothing to read it from.  A metric ``<base>.<variant>`` with no
  file of its own is read by ``<base>``'s file: the variant is the same
  quantity under another name, with a bound or ``moves`` of its own.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent

# Metric and file names: a letter, digit or _ first, then letters,
# digits, _, . and -.
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class Metric(NamedTuple):
    name: str
    unit: str
    read: Callable[[dict], Optional[float]]


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    reference: Callable          # disparity(config, left, right)


def _checked(name: str, kind: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def config_file(bench: dict, config: str, root: Path = ROOT) -> Path:
    for entry in bench["configs"]:
        if entry["name"] == config:
            return Path(root) / entry["file"]
    raise KeyError(f"BENCHMARK.json has no configuration {config!r}")


def traffic_file(traffic: str, root: Path = ROOT) -> Path:
    return (Path(root) / "portbench" / "traffic"
            / f"{_checked(traffic, 'traffic')}.json")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(
        module_name + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """``read`` of ``portbench/metrics/<name>.py``, or of the file of the
    name before its last '.' where ``name`` has none of its own."""
    folder = Path(root) / "portbench" / "metrics"
    base = _checked(name, "metric")
    while not (folder / f"{base}.py").is_file():
        if "." not in base:
            raise FileNotFoundError(
                f"no reader for metric {name!r} in {folder}")
        base = base.rsplit(".", 1)[0]
    return _load(folder / f"{base}.py", "portbench_metric_").read


def reference_disparity(name: str, root: Path = ROOT) -> Callable:
    """``disparity`` of ``portbench/reference/<name>.py``."""
    path = (Path(root) / "portbench" / "reference"
            / f"{_checked(name, 'reference')}.py")
    if not path.is_file():
        raise FileNotFoundError(f"no reference {name!r} at {path}")
    return _load(path, "portbench_reference_").disparity


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def find_cell(name: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration, traffic
    and the metrics it reports, each with its reader."""
    bench = load_benchmark(root) if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    with open(config_file(bench, entry["config"], root)) as f:
        config = json.load(f)
    with open(traffic_file(entry["traffic"], root)) as f:
        traffic = json.load(f)
    end_to_end = [m for m in bench["end_to_end"]
                  if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]

    def metrics(entries_: List[dict]) -> List[Metric]:
        return [Metric(m["name"], m["unit"], metric_reader(m["name"], root))
                for m in entries_]

    return Cell(name, config, traffic, metrics(end_to_end),
                metrics(per_layer),
                reference_disparity(config["reference"], root))


def read_metrics(metrics: List[Metric], record: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics that found something to
    read in ``record``."""
    out = {}
    for metric in metrics:
        value = metric.read(record)
        if value is not None:
            out[metric.name] = {"value": value, "unit": metric.unit}
    return out
