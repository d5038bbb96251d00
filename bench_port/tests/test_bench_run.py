"""The entry point as a benchmark run calls it: a process per run.

The ``card`` tests run cells on a CUDA card and skip without one; the
others hold what a run does where it finds none.
"""

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from bench_port import harness, spec

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
SEED = 2**31 + 4321


def run_py(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "bench_port/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = run_py(ROOT, "--workload", "flagship-2p24.roundtrip", "--seed", str(SEED),
               "--seconds", "1", "--trace", "0", timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "CUDA device" in p.stderr


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sventt_tpu_torch_lookalike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sventt_tpu.plan", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["sventt_tpu.plan"]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    needs_card()
    p = run_py(ROOT, "--workload", cell, "--seed", str(SEED), "--seconds", "2",
               "--trace", str(trace))
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    names = {m["name"] for m in spec.metrics_for(BENCH, cell, bool(trace))}
    assert set(result["metrics"]) == names
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for k, m in result["metrics"].items():
            if k.endswith("roofline"):
                assert 0 < m["value"] <= 100


@pytest.mark.card
def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory with BENCHMARK.json and bench_port/ but not the program."""
    needs_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = run_py(tmp_path, "--workload", "flagship-2p24.sync", "--seed", str(SEED),
               "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_at_the_cells_size(cell):
    needs_card()
    p = subprocess.run([sys.executable, "bench_port/control.py", "--workload", cell,
                        "--seeds", str(SEED), "--seconds", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    low, high = summary["control_min"], summary["program_max"]
    wrong = [k for k in low if k.endswith("_wrong_words")]
    assert wrong and all(high[k] == 0 < low[k] for k in wrong)
