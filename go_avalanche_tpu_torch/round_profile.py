"""Where a round's device time goes, on the card.

    python -m go_avalanche_tpu_torch.round_profile

For each case it builds the state, runs two warm-up rounds, traces ten
more under `torch.profiler` and prints one JSON line with the numbers
below.  The cases: the flagship round (`workload.flagship_state`,
16384 x 16384, k=8) on the megakernel, and phased with the u8 and the
swar32 ingest kernel; the DAG baseline round (`workload.dag_baseline_state`,
10000 x 10000, 2-tx conflict sets) with each ingest kernel (its first
twelve rounds, all before any set settles); and one step of BASELINE
config 6 (`workload.northstar_state`, 100000 nodes x a 1024-set window
of 2-tx sets, `streaming_dag.step` on u8: retire/refill, then the DAG
round; its first twelve steps, the first window's).  The untraced round
times are `chip_smoke.py`'s.

  traced_wall_ms  host ms per round inside the trace, synchronised
  busy_ms         device ms per round summed over kernels, copies, sets
  idle_share      1 - busy_ms / traced_wall_ms
  launches        device operations per round
  spans           device ms per round under each `round_step` span; the
                  rest ("other") is the key split, the finality tests,
                  the response planes, the lifecycle and the telemetry
  kernels         device ms per round of each of the port's own kernels
  top_kernels     the ten device operations with the most time per round

Every line carries the card's name and power limit (nvidia-smi).  Needs
an NVIDIA GPU: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from go_avalanche_tpu_torch import workload
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch.models import streaming_dag

ROUNDS = 10
SPANS = ("retire_refill", "poll_mask", "sample_peers", "gossip_admission",
         "gather_prefs", "fused_round", "ingest_votes")
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


def _flagship(round_engine: str = "phased", ingest_engine: str = "u8"):
    nodes, txs = workload.FLAGSHIP_NODES, workload.FLAGSHIP_TXS
    state, cfg = workload.flagship_state(nodes, txs,
                                         round_engine=round_engine)
    cfg = dataclasses.replace(cfg, ingest_engine=ingest_engine)
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
    "dag u8": lambda: _dag("u8"),
    "dag swar32": lambda: _dag("swar32"),
    "config6 u8": _config6,
}


def profile_case(case: str) -> dict:
    rounds = ROUNDS
    step, state, cfg, nodes, txs = CASES[case]()
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

    rows = prof.key_averages()
    device_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    busy_ms = sum(r.self_device_time_total for r in device_rows) / 1e3
    spans = {r.key: r.device_time_total / 1e3 / rounds for r in rows
             if r.key in SPANS and r.device_type == DeviceType.CPU}
    kernels = {}
    for r in device_rows:
        for name, launched_in in PORT_KERNELS.items():
            if name in r.key:
                ms = r.self_device_time_total / 1e3 / rounds
                kernels[name] = kernels.get(name, 0.0) + ms
                spans[launched_in] = spans.get(launched_in, 0.0) + ms
    spans["other"] = busy_ms / rounds - sum(spans.values())
    top = sorted(device_rows, key=lambda r: -r.self_device_time_total)[:10]
    return {
        "case": case, "nodes": nodes, "txs": txs,
        "k": cfg.k, "rounds": rounds, "traced_wall_ms": wall_ms,
        "busy_ms": busy_ms / rounds,
        "idle_share": 1.0 - (busy_ms / rounds) / wall_ms,
        "launches": sum(r.count for r in device_rows) / rounds,
        "spans": spans,
        "kernels": kernels,
        "top_kernels": [{"name": r.key[:100], "per_round": r.count / rounds,
                         "ms": r.self_device_time_total / 1e3 / rounds}
                        for r in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("round_profile: torch.cuda.is_available() is false; the "
              "profile measures the card only", file=sys.stderr)
        return 2
    label = {"card": card_label(), "torch": torch.__version__,
             "cuda": torch.version.cuda}
    for case in CASES:
        out = profile_case(case)
        print(json.dumps({**out, **label}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
