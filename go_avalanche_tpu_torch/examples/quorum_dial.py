"""The quorum dial: availability vs liveness vs SAFETY, per quorum — the
port's twin of `examples/quorum_dial.py`.

Per quorum Q of the 8-vote window: (1) availability from the closed
form C_Q(a) = P[Bin(8, a) >= Q] (`c_q`, `a50`); (2) liveness under
full-rate equivocation, the stall threshold eps*(Q) on the conflict DAG
(`equivocation_threshold.sweep_cell(quorum=Q)`); (3) safety under
contested priors (`agreement_cell`): a 50/50-split network under
equivocation / drop pressure, counting sets two HONEST nodes finalize
differently.  Then the same safety probe across (window, quorum) pairs:
the organizing quantity is the ratio Q/W, not the margin W-Q.  The
script's docstring has the measured finding (7-of-8 is the minimal
measured-safe quorum).

Usage:
    python -m go_avalanche_tpu_torch.examples.quorum_dial [--nodes 512]
        [--txs 64] [--rounds 600] [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/quorum_dial.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.examples.equivocation_threshold import sweep_cell
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.ops import voterecord as vr

QUORUM_GRID = (5, 6, 7, 8)
EPS_GRID = (0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3)
SAFETY_CELLS = ((0.0, 0.2), (0.05, 0.0), (0.05, 0.2))   # (eps, drop)
WINDOW = 8
# (window, quorum) pairs for the ratio-law extension: margin 1 and 2 at
# every window size the uint8 packing admits down to 4.
WINDOW_PAIRS = ((8, 7), (8, 6), (7, 6), (7, 5), (6, 5), (6, 4), (5, 4),
                (4, 3))


def c_q(a: float, quorum: int, window: int = WINDOW) -> float:
    """Bump rate per vote slot: P[Bin(window, a) >= quorum]."""
    return float(sum(math.comb(window, j) * a ** j * (1 - a) ** (window - j)
                     for j in range(quorum, window + 1)))


def a50(quorum: int, window: int = WINDOW) -> float:
    """Availability where the bump rate halves: C_Q(a50) = 1/2."""
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if c_q(mid, quorum, window) < 0.5:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def agreement_cell(n_nodes: int, n_txs: int, set_size: int, rounds: int,
                   quorum: int, eps: float, drop: float,
                   seed: int = 0, n_seeds: int = 1,
                   window: int = WINDOW, device="cuda") -> dict:
    """Contested-priors safety probe: half the nodes initially prefer
    each lane of every conflict set; count sets finalized INCONSISTENTLY
    across honest nodes (the safety violation) and the honest resolution
    fraction.  With `n_seeds` > 1 the probe repeats over independent
    trajectories and reports per-seed conflict counts."""
    per_seed = [_agreement_one(n_nodes, n_txs, set_size, rounds, quorum,
                               eps, drop, s, window, device)
                for s in range(seed, seed + n_seeds)]
    out = dict(per_seed[0])
    out["conflicting_sets_per_seed"] = [p["conflicting_sets"]
                                        for p in per_seed]
    out["conflicting_sets"] = max(out["conflicting_sets_per_seed"])
    out["both_lane_nodes"] = max(p["both_lane_nodes"] for p in per_seed)
    out["honest_resolved"] = round(
        float(np.mean([p["honest_resolved"] for p in per_seed])), 4)
    return out


def _agreement_one(n_nodes: int, n_txs: int, set_size: int, rounds: int,
                   quorum: int, eps: float, drop: float,
                   seed: int, window: int = WINDOW, device="cuda") -> dict:
    dev = _device(device)
    cs = torch.arange(n_txs, dtype=torch.int32, device=dev) // set_size
    lane0 = (torch.arange(n_txs, device=dev) % set_size) == 0
    even_rows = (torch.arange(n_nodes, device=dev)[:, None] % 2) == 0
    init_pref = torch.where(even_rows, lane0[None, :], ~lane0[None, :])
    # The adversary knobs only ride along when eps > 0 — at eps == 0
    # they are inert and the config validator rejects them; the
    # (0, drop) safety cell measures drops alone.
    adv = (dict(flip_probability=1.0,
                adversary_strategy=AdversaryStrategy.EQUIVOCATE)
           if eps > 0 else {})
    cfg = AvalancheConfig(window=window, quorum=quorum,
                          byzantine_fraction=eps,
                          drop_probability=drop, **adv)
    state = dag.init(prng.key(seed, dev), n_nodes, cs, cfg,
                     init_pref=init_pref, device=dev)
    # eps enters only `init` (the byzantine mask is state); the run
    # config pins it at 1.0 for the eps > 0 cells, as the script does.
    run_cfg = (dataclasses.replace(cfg, byzantine_fraction=1.0)
               if eps > 0 else cfg)
    final, _ = dag.run_scan(state, run_cfg, rounds, device=dev)
    conf = final.base.records.confidence
    fin_acc = (vr.has_finalized(conf, cfg)
               & vr.is_accepted(conf)).cpu().numpy()
    honest = ~final.base.byzantine.cpu().numpy()
    n_sets = n_txs // set_size
    by_set = fin_acc.reshape(n_nodes, n_sets, set_size)
    counts = dag.winners_per_set(fin_acc, set_size)
    resolved = (counts == 1) & honest[:, None]
    # A single honest node finalize-accepting BOTH lanes of a set is the
    # most direct double-spend finalization — a conflict in its own
    # right, not only cross-node winner disagreement.
    both = (counts >= 2) & honest[:, None]
    winner = by_set.argmax(2)
    conflicts = 0
    for s in range(n_sets):
        ws = winner[resolved[:, s], s]
        cross = len(ws) > 0 and ws.min() != ws.max()
        if cross or both[:, s].any():
            conflicts += 1
    return {"quorum": quorum, "eps": eps, "drop": drop,
            "honest_resolved": round(float(resolved[honest].mean()), 4),
            "both_lane_nodes": int(both.sum()),
            "conflicting_sets": conflicts, "n_sets": n_sets}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--txs", type=int, default=64)
    ap.add_argument("--conflict-size", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--n-seeds", type=int, default=3,
                    help="independent trajectories per safety cell (the "
                    "zero-conflicts claim is a max over seeds)")
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("quorum_dial.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    rows = []
    t0 = time.time()
    for quorum in QUORUM_GRID:
        # Liveness side: smallest eps that stalls (resolved < 0.5) under
        # full-rate equivocation, at this quorum.
        cells = []
        for eps in EPS_GRID:
            cell = sweep_cell(args.nodes, args.txs, args.conflict_size,
                              args.rounds, eps=eps, p=1.0,
                              strategy=AdversaryStrategy.EQUIVOCATE,
                              quorum=quorum, device=dev)
            cells.append(cell)
            print(f"Q={quorum} eps={eps:<6} resolved={cell['resolved']}",
                  flush=True)
        stalled = [c["eps"] for c in cells if c["resolved"] < 0.5]
        # Safety side: contested priors under (eps, drop) pressure.
        safety = [agreement_cell(args.nodes, args.txs, args.conflict_size,
                                 args.rounds, quorum, eps, drop,
                                 n_seeds=args.n_seeds, device=dev)
                  for eps, drop in SAFETY_CELLS]
        for sc in safety:
            print(f"Q={quorum} SAFETY eps={sc['eps']} drop={sc['drop']}: "
                  f"resolved={sc['honest_resolved']} "
                  f"conflicts={sc['conflicting_sets']}/{sc['n_sets']}",
                  flush=True)
        row = {
            "quorum": quorum,
            "a50": round(a50(quorum), 4),
            "latency_factor_a090": round(1.0 / c_q(0.9, quorum), 2),
            "latency_factor_a075": round(1.0 / c_q(0.75, quorum), 2),
            "equivocation_stall_eps": min(stalled) if stalled else None,
            "max_conflicting_sets": max(sc["conflicting_sets"]
                                        for sc in safety),
            "cells": cells,
            "safety": safety,
        }
        rows.append(row)
        print(f"Q={quorum}: a50={row['a50']} "
              f"1/C(0.9)={row['latency_factor_a090']} "
              f"stall_eps={row['equivocation_stall_eps']} "
              f"max_conflicts={row['max_conflicting_sets']}", flush=True)

    # The ratio-law extension: the same safety probe across (window,
    # quorum) pairs at margin 1 and 2.
    pair_rows = []
    for window, quorum in WINDOW_PAIRS:
        cell = agreement_cell(args.nodes, args.txs, args.conflict_size,
                              args.rounds, quorum, eps=0.05, drop=0.0,
                              n_seeds=args.n_seeds, window=window,
                              device=dev)
        stalled = []
        for eps in EPS_GRID:
            c = sweep_cell(args.nodes, args.txs, args.conflict_size,
                           args.rounds, eps=eps, p=1.0,
                           strategy=AdversaryStrategy.EQUIVOCATE,
                           quorum=quorum, window=window, device=dev)
            if c["resolved"] < 0.5:
                stalled.append(eps)
        pair = {"window": window, "quorum": quorum,
                "ratio": round(quorum / window, 4),
                "margin": window - quorum,
                "a50": round(a50(quorum, window), 4),
                "equivocation_stall_eps": min(stalled) if stalled else None,
                "conflicting_sets_per_seed":
                    cell["conflicting_sets_per_seed"],
                "max_conflicting_sets": cell["conflicting_sets"],
                "n_sets": cell["n_sets"]}
        pair_rows.append(pair)
        print(f"W={window} Q={quorum} ratio={pair['ratio']} "
              f"margin={pair['margin']} "
              f"stall_eps={pair['equivocation_stall_eps']}: conflicts "
              f"{pair['conflicting_sets_per_seed']}", flush=True)

    result = {
        "config": {"nodes": args.nodes, "txs": args.txs,
                   "conflict_size": args.conflict_size,
                   "rounds": args.rounds, "window": WINDOW,
                   "safety_cells": list(SAFETY_CELLS),
                   "safety_n_seeds": args.n_seeds,
                   "backend": dev.type},
        "rows": rows,
        "window_pairs": pair_rows,
        "elapsed_s": round(time.time() - t0, 1),
        "card": card,
    }
    _common.write_json(args.json_out, result)
    print(f"artifact: {args.json_out} ({result['elapsed_s']}s"
          f"{_common.card_note(card)})")
    return result


if __name__ == "__main__":
    main()
