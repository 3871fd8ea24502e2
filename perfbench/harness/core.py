"""One benchmark run: the cell found by name, set-up, the measured window,
the traced run's readings, the comparison with the reference, the result.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its check limits and sample
sizes are in ``workloads/<cell>.json``; every metric is read by
``metrics/<metric>.py``.  The traffic file names its driver
(``harness/drivers/<driver>.py``), which builds the system from the
configuration and the mix and knows the one call the window repeats.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench.harness import trace as tracing
from perfbench.harness.spans import Spans

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "lgu_slam_tpu", "lgu_native")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    bench = root / "perfbench"

    def applies(m):
        return name in m.get("workloads", [name])

    return Cell(
        name=name,
        config=load_json(bench / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "workloads" / f"{name}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def load_reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py``'s ``read``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(cell: Cell):
    mod = importlib.import_module(
        f"perfbench.harness.drivers.{cell.traffic['driver']}")
    return mod.Driver


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    seed: int
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # (host s, units) per call
    spans: dict = field(default_factory=dict)  # name -> [ms per call]
    counts: dict = field(default_factory=dict)
    samples: dict = field(default_factory=dict)
    trace: tracing.Trace | None = None
    peak_flops: float = 0.0

    @property
    def units(self) -> float:
        return sum(u for _, u in self.calls)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is that of JAX, Flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def window(driver, seconds: float, run: Run, sync_each: bool):
    """Repeat the driver's call until the first call boundary past
    ``seconds``; the window's length is the measured time, less the time
    of the driver's ``keep`` (the check's copies of the program's state,
    taken between calls and synchronised, so that no call pays for them)."""
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = 0.0
    while True:
        k0 = time.perf_counter()
        if driver.keep("before"):
            if cuda:
                torch.cuda.synchronize()
            kept += time.perf_counter() - k0
        c0 = time.perf_counter()
        units = driver.call()
        if sync_each and cuda:
            torch.cuda.synchronize()
        c1 = time.perf_counter()
        run.calls.append((c1 - c0, units))
        if driver.keep("after"):
            if cuda:
                torch.cuda.synchronize()
            kept += time.perf_counter() - c1
        if c1 - t0 - kept >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0 - kept


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", impl: str = "program", scale: dict | None = None,
             t_start: float | None = None, root: Path = ROOT) -> dict:
    """One run of cell ``name``: returns the result (without printing).
    ``impl`` "control" puts the reference at the control precision in the
    program's place; ``scale`` overrides sizes of the configuration and the
    mix (the CPU tests' tiny cells)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    if scale:
        for part in ("config", "traffic", "limits"):
            for key, value in scale.get(part, {}).items():
                target = getattr(cell, part)
                if isinstance(value, dict):
                    target.setdefault(key, {}).update(value)
                else:
                    target[key] = value
    dev = torch.device(device)
    run = Run(cell, seed, dev)
    driver = load_driver(cell)(cell, seed, dev, impl)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    spans = Spans(dev)
    if traced:
        driver.instrument(spans)
        spans.start()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    window(driver, seconds, run, driver.sync_each)
    memory_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                   else 0)
    if traced:
        spans.stop()
        run.spans = spans.durations()
        run.counts = dict(spans.counts)
        # the device trace after the window, so that the profiler's cost
        # reaches no span
        run.trace = tracing.profile_calls(
            driver.call, cell.traffic["trace_calls"], dev, spans)
        run.samples = dict(spans.samples)
        spans.restore()
    run.peak_flops = driver.peak_flops
    # the readings that need the program's state, then free it
    if traced:
        driver.read_samples(run)
    driver.finish()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers = driver.check()
    check_s = time.perf_counter() - c0
    limits = cell.limits["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(run.calls),
              "failed": driver.failed, "metrics": metrics,
              "device": device_info(dev, cell.chips, memory_peak)}
    if traced:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(run.trace),
                               "idle_gaps": tracing.idle_gaps(run.trace)}
    result["checks"] = {k: {"value": float(numbers[k]),
                            "limit": float(limits[k])} for k in limits}
    result["_notes"] = driver.notes(run) + [
        call_times(run), f"the check took {check_s:.1f} s"]
    return result


def call_times(run: Run) -> str:
    """The window's calls on the host clock: how evenly a run went."""
    ms = sorted(1e3 * t for t, _ in run.calls)
    if not ms:
        return "calls: none"
    q = [ms[min(len(ms) - 1, int(f * len(ms)))] for f in (0.25, 0.5, 0.75)]
    return (f"call ms: first {1e3 * run.calls[0][0]:.3f}, min {ms[0]:.3f}, "
            f"quartiles {q[0]:.3f} {q[1]:.3f} {q[2]:.3f}, max {ms[-1]:.3f}")


def device_info(dev: torch.device, chips: int, memory_peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak)}
