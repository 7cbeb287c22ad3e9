"""Where the flagship round's device time goes, on the card.

    python -m go_avalanche_tpu_torch.round_profile

For each round engine (megakernel, then phased) it builds the flagship
state (`workload.flagship_state`, 16384 x 16384, k=8), runs two warm-up
rounds, traces ten more under `torch.profiler` and prints one JSON line
with the numbers below.  The untraced round time is `chip_smoke.py`'s.

  traced_wall_ms  host ms per round inside the trace, synchronised
  busy_ms         device ms per round summed over kernels, copies, sets
  idle_share      1 - busy_ms / traced_wall_ms
  launches        device operations per round
  spans           device ms per round under each `round_step` span; the
                  rest ("other") is the key split, the finality tests,
                  the response planes, the lifecycle and the telemetry
  top_kernels     the ten device operations with the most time per round

Every line carries the card's name and power limit (nvidia-smi).  Needs
an NVIDIA GPU: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from go_avalanche_tpu_torch import workload
from go_avalanche_tpu_torch.models import avalanche as av

ROUNDS = 10
SPANS = ("poll_mask", "sample_peers", "gossip_admission", "gather_prefs",
         "fused_round", "ingest_votes")


def card_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_engine(round_engine: str) -> dict:
    rounds = ROUNDS
    nodes, txs = workload.FLAGSHIP_NODES, workload.FLAGSHIP_TXS
    state, cfg = workload.flagship_state(nodes, txs,
                                         round_engine=round_engine)
    for _ in range(2):
        state = av.round_step(state, cfg)[0]
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state = av.round_step(state, cfg)[0]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds

    rows = prof.key_averages()
    device_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    busy_ms = sum(r.self_device_time_total for r in device_rows) / 1e3
    spans = {r.key: r.device_time_total / 1e3 / rounds for r in rows
             if r.key in SPANS and r.device_type == DeviceType.CPU}
    spans["other"] = busy_ms / rounds - sum(spans.values())
    top = sorted(device_rows, key=lambda r: -r.self_device_time_total)[:10]
    return {
        "round_engine": round_engine, "nodes": nodes, "txs": txs,
        "k": cfg.k, "rounds": rounds, "traced_wall_ms": wall_ms,
        "busy_ms": busy_ms / rounds,
        "idle_share": 1.0 - (busy_ms / rounds) / wall_ms,
        "launches": sum(r.count for r in device_rows) / rounds,
        "spans": spans,
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
    for engine in ("megakernel", "phased"):
        out = profile_engine(engine)
        print(json.dumps({**out, **label}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
