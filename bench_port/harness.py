"""One run of one cell: set-up, warm-up, the measured window, the check,
the metrics.

The system under test, its plain reference and the op that drives it are
found by the names in the cell's configuration and traffic
(``spec.system``, ``spec.reference``, ``spec.op``).  The reference runs
once the window has closed, the peak memory has been read and the
program's state is freed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import check, spec, traffic as traffic_mod

#: Top-level modules that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "sventt_tpu")


def reference(config: dict, device, arithmetic: str = "exact"):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return spec.reference(config["reference"]).build(config, device, arithmetic)


class ControlSystem:
    """The control: the reference, computed with float64 products, in the
    program's place; it answers every call the reference answers."""

    def __init__(self, config: dict, mix: dict, device, chips: int):
        self._ref = reference(config, device, "float64")

    def __getattr__(self, name):
        return getattr(self._ref, name)


@dataclass
class Run:
    """What a metric's reader reads."""

    n: int
    setup_s: float
    build_s: float
    window: traffic_mod.Window
    #: Seconds of each part of set-up, for the log.
    setup_parts: dict


def _sync(device, chips: int) -> None:
    if torch.device(device).type == "cuda":
        for d in range(chips):
            torch.cuda.synchronize(d)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, n: int | None = None,
             system=None) -> tuple[dict, Run]:
    """Runs ``cell`` once; returns (the result line's object, the Run).
    ``n`` shrinks the cell for a test on the CPU, ``system`` puts another
    system in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    w = spec.workload(bench, cell)
    config = spec.load_config(bench, w["config"])
    mix = spec.load_traffic(w["traffic"])
    if n is not None:
        config = {**config, "n": n}
    cuda = torch.device(device).type == "cuda"
    chips = w["chips"]
    op = spec.op(mix["op"])
    system = system or spec.system(config["system"])

    parts = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    torch.empty(1, device=device)  # the device's context
    _sync(device, chips)
    parts["device"] = time.perf_counter() - t
    t = time.perf_counter()
    program = system(config, mix, device, chips)
    _sync(device, chips)
    build_s = parts["build"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = traffic_mod.make_inputs(mix, config, seed, device)
    caller = traffic_mod.Caller(program, mix, inputs, device, chips)
    _sync(device, chips)
    parts["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    caller.warm_up()
    _sync(device, chips)
    parts["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    window = caller.run(seconds=seconds, sample_seed=seed, trace=trace)
    # the peak on the fullest card
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips)) if cuda else 0
    del caller, program

    values = check.compare(window.samples, inputs, reference(config, device), window.failed, op)
    window.samples = []
    correct, checks = check.judge(values, op.LIMITS)

    run = Run(n=config["n"], setup_s=setup_s, build_s=build_s, window=window, setup_parts=parts)
    metrics = {}
    for m in spec.metrics_for(bench, cell, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else torch.device(device).type,
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": chips if cuda else 0,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": window.calls,
              "failed": window.failed + values["wrong_outputs"],
              "metrics": metrics, "device": dev}
    if window.trace is not None:
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = checks
    return result, run


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(args, t_start: float) -> int:
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, run = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    w = run.window
    parts = ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items())
    print(f"{args.workload} seed {args.seed}: {w.calls} calls in {w.seconds:.3f} s; "
          f"setup {run.setup_s:.3f} s ({parts}); {result['device']['power_limit']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        rule = "max" if "max" in c else "min"
        print(f"check {name} {c['value']} ({rule} {c[rule]})", file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
