"""The retire-cap tradeoff: how low can the scheduler throttle go? — the
port's twin of `examples/retire_cap_tradeoff.py`.

`cfg.stream_retire_cap=K` bounds the streaming conflict-DAG scheduler to
retiring and refilling at most K set-slots a round.  The queueing
prediction: steady state settles sets at r = W / L (window W slots,
in-window settle latency L rounds, ~17 at defaults); a cap K < r makes
admission the bottleneck and the drain of a B-set backlog stretches to
``max(R_dense, B / K + L)``.  At EVERY cap the run stays live (all sets
settle, one winner each) and the in-window settle latency is unchanged;
`main` asserts both.  The script's docstring has the measured knee.

Usage:
    python -m go_avalanche_tpu_torch.examples.retire_cap_tradeoff
        [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/
                    retire_cap_tradeoff.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import streaming_dag as sdg
from go_avalanche_tpu_torch.models.avalanche import _device

NODES = 256
BACKLOG_SETS = 2048
SET_CAP = 2
WINDOW_SETS = 64
CAPS = (None, 64, 16, 8, 4, 3, 2, 1)  # None = dense rewrite
_SCORE_SEED = 11
_SIM_SEED = 5
MAX_ROUNDS = 20_000


def _build_state(cfg, device="cuda"):
    """Deterministic state at the study shape — fixed keys and a score
    backlog, the script's construction, bit for bit."""
    dev = _device(device)
    scores = prng.randint(prng.key(_SCORE_SEED, dev),
                          (BACKLOG_SETS, SET_CAP), 0, 1 << 30)
    backlog = sdg.make_set_backlog(scores)
    return sdg.init(prng.key(_SIM_SEED, dev), NODES, WINDOW_SETS,
                    backlog, cfg, track_finality=False, device=dev)


def run_cell(cap, device="cuda") -> dict:
    """Drain the full backlog at one cap; return the measured cell."""
    dev = _device(device)
    cfg = AvalancheConfig(gossip=False,
                          max_element_poll=WINDOW_SETS * SET_CAP)
    if cap is not None:
        cfg = dataclasses.replace(cfg, stream_retire_cap=cap)
    state = _build_state(cfg, dev)
    final = sdg.run_chunked(state, cfg, max_rounds=MAX_ROUNDS, chunk=512,
                            device=dev)
    summary = sdg.resolution_summary(final)
    rounds = int(final.dag.base.round)
    # End-to-end completion: the round the LAST set settled.
    last_settle = int(final.outputs.settle_round.max())
    return {"cap": cap, "rounds_to_drain": rounds,
            "last_settle_round": last_settle, **summary}


def law(cells: list) -> dict:
    """The B/K+L prediction against the dense anchor."""
    dense = next(c for c in cells if c["cap"] is None)
    r_dense = dense["rounds_to_drain"]
    lat = dense["settle_latency_median"]
    knee = BACKLOG_SETS / r_dense
    rows = []
    for c in cells:
        if c["cap"] is None:
            continue
        pred = max(r_dense, BACKLOG_SETS / c["cap"] + lat)
        rows.append({"cap": c["cap"],
                     "measured": c["rounds_to_drain"],
                     "predicted": round(pred, 1),
                     "ratio_vs_dense": round(
                         c["rounds_to_drain"] / r_dense, 3),
                     "measured_over_predicted": round(
                         c["rounds_to_drain"] / pred, 3)})
    return {"r_dense": r_dense, "knee_cap": round(knee, 2),
            "settle_latency_median": lat,
            "settle_latency_p90": dense["settle_latency_p90"],
            "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("retire_cap_tradeoff.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)

    cells = []
    for cap in CAPS:
        cell = run_cell(cap, dev)
        # Liveness + safety must hold at EVERY cap, down to K=1.
        assert cell["sets_settled_fraction"] == 1.0, cell
        assert cell["sets_one_winner_fraction"] == 1.0, cell
        if cells:  # CAPS[0] is None: cells[0] is the dense anchor
            # A cap may delay retirement/admission but never the
            # consensus in between: the in-window latency stats EQUAL
            # dense.
            for k in ("settle_latency_median", "settle_latency_p90"):
                assert cell[k] == cells[0][k], (k, cell, cells[0])
        cells.append(cell)
        print(json.dumps(cell), flush=True)

    result = {"config": {"nodes": NODES, "backlog_sets": BACKLOG_SETS,
                         "set_cap": SET_CAP, "window_sets": WINDOW_SETS,
                         "caps": list(CAPS),
                         "score_seed": _SCORE_SEED,
                         "sim_seed": _SIM_SEED},
              "cells": cells, "law": law(cells),
              "backend": dev.type}
    print(json.dumps(result["law"]), flush=True)
    if args.json_out:
        _common.write_json(args.json_out, result)
    return result


if __name__ == "__main__":
    main()
