"""Where a round's device time goes, on the card.

    python -m go_avalanche_tpu_torch.round_profile [CASE ...]

For each case (all by default; a CASE argument keeps the cases whose
name contains it) it builds the state, runs two warm-up rounds, traces
ten more under `torch.profiler` and prints one JSON line with the
numbers below.  The cases: the flagship round (`workload.flagship_state`,
16384 x 16384, k=8) on the megakernel, and phased with the u8 and the
swar32 ingest kernel; the same three with the flight recorder on
("... traced": `metrics_every=1` into an active `metrics_sink` and
`trace_every=1` into the state's trace plane); the DAG baseline round
(`workload.dag_baseline_state`, 10000 x 10000, 2-tx conflict sets) with
each ingest kernel (its first twelve rounds, all before any set
settles); and one step of BASELINE config 6 (`workload.northstar_state`,
100000 nodes x a 1024-set window of 2-tx sets, `streaming_dag.step` on
u8: retire/refill, then the DAG round; its first twelve steps, the first
window's).  The untraced round times are `chip_smoke.py`'s.

  traced_wall_ms  host ms per round inside the trace, synchronised
  busy_ms         device ms per round summed over kernels, copies, sets
  idle_share      1 - busy_ms / traced_wall_ms
  launches        device operations per round
  spans           device ms per round under each `round_step` span; the
                  rest ("other") is the key split, the finality tests,
                  the response planes, the lifecycle and the telemetry
  span_host_ms    host ms per round inside each span (Python and
                  dispatch: the time the host spends there)
  span_launches   device operations per round launched inside each span
  kernels         device ms per round of each of the port's own kernels
  top_kernels     the ten device operations with the most time per round

A traced case's line also carries ``tap_cost``: its ms per round and its
untraced twin's, timed by CUDA events without the profiler, over
`TAP_ROUNDS` rounds a side, alternated off, on, off, on (`TAP_REPS`
pairs), so that neither side always runs first.

Every line carries the card's name and power limit (nvidia-smi).  Needs
an NVIDIA GPU: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from go_avalanche_tpu_torch import obs, workload
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch.models import streaming_dag
from go_avalanche_tpu_torch.obs.tags import PHASE_SPANS, PORT_SPANS

ROUNDS = 10
TAP_ROUNDS = 20
TAP_REPS = 2
# Every span `utils/tracing.annotate` accepts (`obs/tags.py`).
SPANS = PHASE_SPANS + PORT_SPANS
# The port's kernels, by a part of their symbol, and the span that
# launches each.  A kernel launched through ctypes has no aten op above
# it, so the profiler counts its device time under no span; it is added
# to its span here.  Each kernel matches exactly one key:
# `vote_u8_kernel<` / `vote_swar_kernel<` are the ingest kernels' fast
# path (one symbol per k and consider-pack form), `..._kernel_any` their
# general path.
PORT_KERNELS = {"mega_round_kernel": "fused_round",
                "vote_u8_kernel<": "ingest_votes",
                "vote_u8_kernel_any": "ingest_votes",
                "vote_swar_kernel<": "ingest_votes",
                "vote_swar_kernel_any": "ingest_votes"}


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _flagship(round_engine: str = "phased", ingest_engine: str = "u8",
              traced: bool = False):
    nodes, txs = workload.FLAGSHIP_NODES, workload.FLAGSHIP_TXS
    state, cfg = workload.flagship_state(nodes, txs,
                                         round_engine=round_engine)
    cfg = dataclasses.replace(cfg, ingest_engine=ingest_engine)
    if traced:
        cfg = dataclasses.replace(cfg, metrics_every=1, trace_every=1)
        horizon = 2 + max(ROUNDS, 2 * TAP_REPS * TAP_ROUNDS)
        state = av.with_trace(state, cfg, horizon)
    return av.round_step, state, cfg, nodes, txs


def _dag(ingest_engine: str):
    nodes, txs = workload.DAG_NODES, workload.DAG_TXS
    state, cfg = workload.dag_baseline_state(nodes, txs)
    cfg = dataclasses.replace(cfg, ingest_engine=ingest_engine)
    return dag.round_step, state, cfg, nodes, txs


def _config6():
    shape = workload.NORTH_STAR
    state, cfg = workload.northstar_state(**shape)
    return (streaming_dag.step, state, cfg, shape["nodes"],
            shape["window_sets"] * shape["set_cap"])


CASES = {
    "flagship megakernel": lambda: _flagship("megakernel"),
    "flagship phased u8": lambda: _flagship(),
    "flagship phased swar32": lambda: _flagship(ingest_engine="swar32"),
    "flagship megakernel traced": lambda: _flagship("megakernel",
                                                    traced=True),
    "flagship phased u8 traced": lambda: _flagship(traced=True),
    "flagship phased swar32 traced": lambda: _flagship(
        ingest_engine="swar32", traced=True),
    "dag u8": lambda: _dag("u8"),
    "dag swar32": lambda: _dag("swar32"),
    "config6 u8": _config6,
}


def _span_launches(prof) -> dict:
    """Device operations launched inside each span, summed over the
    span's nested host ops."""
    def launched(event):
        return len(getattr(event, "kernels", ())) + sum(
            launched(c) for c in event.cpu_children)
    out = {}
    for e in prof.events():
        if e.name in SPANS and e.device_type == DeviceType.CPU:
            out[e.name] = out.get(e.name, 0) + launched(e)
    return out


def profile_case(case: str) -> dict:
    rounds = ROUNDS
    step, state, cfg, nodes, txs = CASES[case]()
    with tempfile.TemporaryDirectory() as tmp:
        with obs.metrics_sink(Path(tmp) / "tap.jsonl"):
            for _ in range(2):
                state = step(state, cfg)[0]
            torch.cuda.synchronize()

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(rounds):
                    state = step(state, cfg)[0]
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
            taps = (tap_cost(step, state, cfg)
                    if case.endswith(" traced") else None)

    rows = prof.key_averages()
    device_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    busy_ms = sum(r.self_device_time_total for r in device_rows) / 1e3
    span_rows = [r for r in rows
                 if r.key in SPANS and r.device_type == DeviceType.CPU]
    spans = {r.key: r.device_time_total / 1e3 / rounds for r in span_rows}
    kernels = {}
    for r in device_rows:
        for name, launched_in in PORT_KERNELS.items():
            if name in r.key:
                ms = r.self_device_time_total / 1e3 / rounds
                kernels[name] = kernels.get(name, 0.0) + ms
                spans[launched_in] = spans.get(launched_in, 0.0) + ms
    spans["other"] = busy_ms / rounds - sum(spans.values())
    top = sorted(device_rows, key=lambda r: -r.self_device_time_total)[:10]
    out = {
        "case": case, "nodes": nodes, "txs": txs,
        "k": cfg.k, "rounds": rounds, "traced_wall_ms": wall_ms,
        "busy_ms": busy_ms / rounds,
        "idle_share": 1.0 - (busy_ms / rounds) / wall_ms,
        "launches": sum(r.count for r in device_rows) / rounds,
        "spans": spans,
        "span_host_ms": {r.key: r.cpu_time_total / 1e3 / rounds
                         for r in span_rows},
        "span_launches": {k: v / rounds
                          for k, v in _span_launches(prof).items()},
        "kernels": kernels,
        "top_kernels": [{"name": r.key[:100], "per_round": r.count / rounds,
                         "ms": r.self_device_time_total / 1e3 / rounds}
                        for r in top],
    }
    if taps is not None:
        out["tap_cost"] = taps
    return out


def tap_cost(step, state, cfg) -> dict:
    """ms per round with the taps on (`cfg`, inside the caller's active
    sink) and off, by CUDA events, `TAP_ROUNDS` rounds a side, alternated
    off, on, off, on for `TAP_REPS` pairs."""
    off_cfg = dataclasses.replace(cfg, metrics_every=0, trace_every=0)
    off_state = state._replace(trace=None)
    out = {"off_ms": [], "on_ms": []}
    for _ in range(TAP_REPS):
        for side, c in (("off", off_cfg), ("on", cfg)):
            s = off_state if side == "off" else state
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            for _ in range(TAP_ROUNDS):
                s = step(s, c)[0]
            end.record()
            torch.cuda.synchronize()
            out[f"{side}_ms"].append(begin.elapsed_time(end) / TAP_ROUNDS)
            if side == "off":
                off_state = s
            else:
                state = s
    out["rounds_a_side"] = TAP_ROUNDS
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("round_profile: torch.cuda.is_available() is false; the "
              "profile measures the card only", file=sys.stderr)
        return 2
    label = {"card": card_label(), "torch": torch.__version__,
             "cuda": torch.version.cuda}
    wanted = sys.argv[1:]
    for case in CASES:
        if wanted and not any(w in case for w in wanted):
            continue
        out = profile_case(case)
        print(json.dumps({**out, **label}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
