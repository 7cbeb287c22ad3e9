"""Runs one cell of the benchmark: finds its files by name, hands the
driver its inputs, and turns what the driver measured into the result
line.

A cell (`cells/<cell>.json`) names a configuration (`configs/<name>.json`:
its shapes and every `AvalancheConfig` key) and a traffic mix
(`traffic/<name>.json`: the driver that runs the loop and its
parameters).  Which metrics a cell reports comes from `BENCHMARK.json`;
each end-to-end metric is read by `end_to_end/<metric>.py` from the
driver's `Outcome`, each per-layer metric by `layer_metrics/<metric>.py`
from the traced window's `TraceSlice`; a metric split by a qualifier
for cells of one kind (`votes_per_s.dag`) is read by the reader of its
quantity (`votes_per_s.py`).  A reader that finds nothing to read
returns None, and the metric is left out of the line.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench.compare import Check, as_json, report
from portbench.tracing import TraceSlice

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
PROGRAM = "go_avalanche_tpu_torch"
# Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "go_avalanche_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is in `FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def check_imports(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{when}: loaded {', '.join(found[:20])}")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    return importlib.import_module(f"portbench.{kind}.{name}")


def load_reader(kind: str, metric: str):
    """The reader of `metric` under `kind` ("end_to_end" or
    "layer_metrics"): the file of the quantity before the first dot, so
    a metric split by cell kind (`votes_per_s.dag`) needs no file of its
    own."""
    return load_module(kind, metric.split(".")[0])


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


@dataclass
class Cell:
    name: str
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    params: dict       # cells/<cell>.json


def load_cell(name: str) -> Cell:
    params = load_json("cells", name)
    return Cell(name, load_json("configs", params["config"]),
                load_json("traffic", params["traffic"]), params)


def config_fields(cell: Cell) -> dict:
    """Every `AvalancheConfig` key of the cell: the configuration's, with
    the traffic mix's own keys over them."""
    fields = dict(cell.config["avalanche_config"])
    fields.update(cell.traffic.get("avalanche_config", {}))
    return fields


def key_words(seed: int, *index: int) -> tuple:
    """Two uint32 words of a threefry key, drawn from the seed and an
    index path: the benchmark's own draw, handed to both sides."""
    words = np.random.SeedSequence(
        [seed % 2**64, *index]).generate_state(2, dtype=np.uint32)
    return int(words[0]), int(words[1])


@dataclass
class Run:
    """What a driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object              # torch.device
    shape: dict
    fields: dict                # AvalancheConfig keys
    clock: Callable[[], float]
    t_start: float              # process start on `clock`
    card: str
    after_setup: Callable[[], None] = lambda: None
    marks: Dict[str, float] = field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Note the seconds since process start at a step of set-up."""
        self.marks[name] = self.clock() - self.t_start


@dataclass
class Outcome:
    """What a driver measured and checked."""

    setup_s: float
    window_s: float
    round_s: List[float]
    counters: Dict[str, int]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, Check]
    trace: Optional[TraceSlice] = None
    notes: Dict[str, object] = field(default_factory=dict)


def program_config(fields: dict):
    """The program's `AvalancheConfig` from the cell's keys (enums by
    their values)."""
    from go_avalanche_tpu_torch import config
    fields = dict(fields)
    fields["vote_mode"] = config.VoteMode(fields["vote_mode"])
    fields["adversary_strategy"] = config.AdversaryStrategy(
        fields["adversary_strategy"])
    return config.AvalancheConfig(**fields)


def profiler(device):
    """A `torch.profiler` over the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def span(name: str, on: bool):
    """A profiler range around a call the benchmark makes, in a traced
    window only."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def card_limits(device) -> dict:
    """The card's name and power limit as `nvidia-smi` reads them."""
    if device.type != "cuda":
        return {}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"not read: {e}"}
    return {"nvidia_smi": out[device.index or 0] if out else "not read"}


def applicable(cell: str, bench: dict) -> tuple:
    """``(end_to_end, per_layer)`` metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return e2e, layer


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             clock: Callable[[], float], t_start: float,
             shape: Optional[dict] = None, program=None,
             marks: Optional[dict] = None) -> dict:
    """Run cell `name` and return its result line as a dict.  `shape`
    replaces the configuration's shapes (the tests' small sizes);
    `program` replaces the driver's wrapper of the program (the
    control); `marks` holds the set-up steps timed before the call."""
    cell = load_cell(name)
    driver = load_module("drivers", cell.traffic["driver"])
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=device, shape=dict(shape or cell.config["shape"]),
              fields=config_fields(cell), clock=clock, t_start=t_start,
              card=card_name(device),
              after_setup=lambda: check_imports("after set-up"),
              marks=dict(marks or {}))
    outcome: Outcome = (driver.run(run) if program is None
                        else driver.run(run, program=program))
    check_imports("after the window")
    return result_line(cell, run, outcome, benchmark())


def result_line(cell: Cell, run: Run, outcome: Outcome, bench: dict) -> dict:
    e2e, layer = applicable(cell.name, bench)
    metrics = {}
    for m in (layer if run.trace else e2e):
        kind = "layer_metrics" if run.trace else "end_to_end"
        source = outcome.trace if run.trace else outcome
        value = load_reader(kind, m["name"]).read(source)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.card, "count": 1,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": all(c.ok() for c in outcome.checks.values()),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if run.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {
            "device_ops": [list(x) for x in outcome.trace.device_ops],
            "idle_gaps": [list(x) for x in outcome.trace.idle_gaps]}
    line["samples"] = {"rounds": len(outcome.round_s),
                       "window_s": outcome.window_s,
                       **outcome.counters}
    line["card"] = card_limits(run.device)
    line["notes"] = {"setup_marks_s": run.marks, **outcome.notes}
    report(outcome.checks)
    line["checks"] = as_json(outcome.checks)
    return line
