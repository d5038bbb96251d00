"""BENCHMARK.json against the files it names and the benchmark's rules."""

import ast
import json
from pathlib import Path

import pytest

from bench_port import spec

BENCH = spec.load_benchmark()
HERE = spec.HERE
ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "sventt_tpu"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
SOURCES = sorted(HERE.rglob("*.py"))


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


def test_names_and_units_follow_the_rules():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME.fullmatch(name), name
    for m in METRICS:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    lines = [c["source"] for c in BENCH["configs"]] + [e["why"] for e in BENCH["configs"]]
    lines += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    w = spec.workload(BENCH, cell)
    config = spec.load_config(BENCH, w["config"])
    mix = spec.load_traffic(w["traffic"])
    assert (HERE / "reference" / f"{config['reference']}.py").is_file()
    assert (HERE / "systems" / f"{config['system']}.py").is_file()
    assert callable(spec.system(config["system"]))
    assert callable(spec.reference(config["reference"]).build)
    op = spec.op(mix["op"])
    assert op.LIMITS and op.WORK and callable(op.steps) and callable(op.wrong)
    assert (config["modulus"] - 1) % config["n"] == 0
    e2e = spec.metrics_for(BENCH, cell, trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, trace=True)


def test_configs_are_files_of_their_own_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["n"] > 0
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_a_reader_is_found_by_its_name_or_its_first_part():
    assert spec.reader("device_idle.sync").__module__.endswith("device_idle_sync")
    assert spec.reader("ntt_per_s")(type("R", (), {"window": type(
        "W", (), {"work": {"transforms": 10}, "seconds": 2.0})})()) == 5.0
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.sync")
    with pytest.raises(ValueError):
        spec.reader("../harness")


def test_traffic_files_hold_only_traffic():
    """What does not vary with the traffic is the harness's constants."""
    for path in (HERE / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        assert set(mix) <= {"op", "inflight", "sync", "coefficients"}, path
        assert ("inflight" in mix) != bool(mix.get("sync")), path
        assert (HERE / "ops" / f"{mix['op']}.py").is_file(), path


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        assert f"| {m['layer']} |" in perf, m["layer"]
    for m in BENCH["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in cells


def imports(path: Path) -> set[str]:
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_nothing_imports_jax_or_the_jax_package(path):
    """Whole top-level names: ``sventt_tpu_torch`` starts with ``sventt_tpu``."""
    assert not imports(path) & FORBIDDEN


def test_the_reference_imports_torch_alone():
    for path in (HERE / "reference").glob("*.py"):
        assert imports(path) <= {"__future__", "torch"}, path


def test_the_port_is_imported_only_as_users_import_it():
    used = set()
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                    "sventt_tpu_torch"):
                used |= {(node.module, a.name) for a in node.names}
    assert used == {("sventt_tpu_torch", "NTT"), ("sventt_tpu_torch", "NttConfig"),
                    ("sventt_tpu_torch.apps.convolve", "cyclic_convolve")}
