"""The benchmark's definition: ``BENCHMARK.json`` and the files it names.

Everything is found by a name:

* a configuration is the file its entry names (``configs/<name>.json``);
  its keys ``system`` and ``reference`` name the system under test,
  ``systems/<system>.py`` (a class ``System(config, mix, device,
  chips)``), and its plain reference, ``reference/<reference>.py`` (a
  ``build(config, device, arithmetic)``);
* a traffic mix is ``traffic/<traffic>.json``; its ``op`` names
  ``ops/<op>.py``, which makes the inputs, issues the calls and judges
  their outputs;
* a metric's reader is ``metrics/<metric>.py``, or, where there is none,
  ``metrics/<part before the first dot>.py``, with a ``read(run)`` that
  returns the value, or None where the run holds nothing to read.

Which metrics a cell reports is decided here alone, by BENCHMARK.json's
``workloads`` lists.  A new cell, op, system or metric is new files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _checked(name: str, what: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{_checked(name, 'traffic')}.json") as f:
        return json.load(f)


def op(name: str):
    """The module ``ops/<name>.py``."""
    return importlib.import_module(f"bench_port.ops.{_checked(name, 'op')}")


def system(name: str):
    """The class ``System`` of ``systems/<name>.py``."""
    return importlib.import_module(f"bench_port.systems.{_checked(name, 'system')}").System


def reference(name: str):
    """The module ``reference/<name>.py``."""
    return importlib.import_module(f"bench_port.reference.{_checked(name, 'reference')}")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or of the file of
    the name's part before its first dot."""
    path = HERE / "metrics" / f"{_checked(metric, 'metric')}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
