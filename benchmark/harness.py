"""Runs one cell once.  Everything is found by name, so that a later change
adds a configuration, a traffic mix, a cell or a metric as files alone:

* ``BENCHMARK.json`` names the cell's configuration, traffic mix and
  metrics; a configuration's ``file`` holds its sizes;
* ``traffic/<traffic>.json`` holds the mix's parameters and the ``entry``
  point the window drives, ``entries/<entry>.py``;
* ``workloads/<cell>.json`` holds the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``, or the file of the name's part before its
  first dot, reads one per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from .profiling import breakdown

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# modules whose presence after the window refuses the run: JAX and the
# JAX package, compared by top-level name, whole
FORBIDDEN = ("jax", "jaxlib", "flax", "reflectance_filtering_tpu")
# traced calls kept per cell (requests, frames or chunks)
TRACE_CALLS = 5


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError("no {} named '{}' in BENCHMARK.json".format(what, name))


def cell_metrics(spec: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics a cell reports:
    those with no ``workloads`` key and those that list the cell."""
    return [m for m in spec[kind]
            if cell in m.get("workloads", [cell])]


def load_metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader of metric ``name``: ``metrics/<name>.py`` or, where
    there is none, the file of the part of the name before its first dot,
    which the metrics of one kind in several cells share (names hold dots,
    so it is loaded from its file)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, "metrics",
                            name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_entry(name: str):
    return importlib.import_module("benchmark.entries." + name)


@dataclasses.dataclass
class Cell:
    """A cell's files: its entry in BENCHMARK.json, configuration, traffic
    mix and limits."""
    spec: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict

    @classmethod
    def load(cls, name: str, root: str = ROOT,
             bench_dir: str = BENCH_DIR) -> "Cell":
        spec = manifest(root)
        workload = by_name(spec["workloads"], name, "workload")
        config = by_name(spec["configs"], workload["config"], "config")
        return cls(spec, workload,
                   load_json(os.path.join(root, config["file"])),
                   load_json(os.path.join(bench_dir, "traffic",
                                          workload["traffic"] + ".json")),
                   load_json(os.path.join(bench_dir, "workloads",
                                          name + ".json"))["limits"])

    def entry(self):
        """The module of the traffic's ``entry``.  A traffic key that it
        does not read is refused: a mix never runs as another."""
        module = load_entry(self.traffic["entry"])
        unread = sorted(set(self.traffic) - {"entry"} - set(module.TRAFFIC))
        if unread:
            raise ValueError("entry '{}' reads no traffic key {}".format(
                self.traffic["entry"], ", ".join(unread)))
        return module


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the window (its wall time, requests,
    work a request, the host spans) and the traced calls, each
    ``per_call`` requests."""
    config: Dict
    traffic: Dict
    window: Dict
    calls: Optional[list] = None
    per_call: int = 1


def stamp(what: str, started: float) -> None:
    """A line on standard error: seconds since the process started."""
    print("[{:8.3f} s] {}".format(time.perf_counter() - started, what),
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or the JAX package, by top-level name."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float,
             cell: Optional[Cell] = None) -> Dict:
    """One run of cell ``name`` (its files, or ``cell``): set-up, the
    window (then the trace), the memory peak, the program's state dropped,
    the comparison with the reference.  ``started`` is the process's start
    on the window's clock.  Returns the result line's object, its
    ``checks`` last."""
    if cell is None:
        cell = Cell.load(name)
    entry = cell.entry()
    stamp("imports", started)
    session = entry.Session(cell.config, cell.traffic, seed, device)
    stamp("inputs, program and warm-up", started)
    got = session.window(seconds, TRACE_CALLS if trace else 0)
    stamp("window opened at {:.3f} s, closed".format(
        got["start"] - started), started)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    result: Dict[str, Any] = {"attempted": got["requests"], "failed": 0}
    metrics = {}
    if not trace:
        for m in cell_metrics(cell.spec, name, "end_to_end"):
            value = (got["start"] - started if m["name"] == "setup_s"
                     else got["metrics"][m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run = Run(cell.config, cell.traffic, got, got.get("calls"),
                  got.get("per_call", 1))
        for m in cell_metrics(cell.spec, name, "per_layer"):
            value = load_metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.calls:
            device_info["busy_s"] = sum(c.busy_us() for c in run.calls) * 1e-6
            device_info["window_s"] = sum(c.span_us
                                          for c in run.calls) * 1e-6
            result["breakdown"] = breakdown(run.calls)
    judged = session.release()
    del session
    readings = entry.judge(cell.config, cell.traffic, judged["inputs"],
                           judged["outputs"], device)
    stamp("reference", started)
    correct = all(readings[k] <= limit for k, limit in cell.limits.items())
    # a reading that is not finite is printed as text: JSON has no NaN
    checks = {k: {"value": readings[k] if math.isfinite(readings[k])
                  else str(readings[k]), "limit": limit}
              for k, limit in cell.limits.items()}
    result.update(correct=correct, metrics=metrics, device=device_info)
    result["checks"] = checks
    return result
