"""Locate the DAG liveness threshold under the equivocation adversary —
the port's twin of `examples/equivocation_threshold.py`.

A threshold map of byzantine_fraction (eps) x flip_probability (p) on
the conflict-DAG model, for both EQUIVOCATE and FLIP, measuring the
fraction of (honest node, conflict set) pairs resolved within a round
budget.  The quantity that organizes the result is the effective lie
rate q = eps * p (the script's docstring has the argument: the
adversary attacks the metastable preference loop, not the vote window).

eps only enters `init` (the byzantine mask is sim state), so the run
config pins it at 1.0, as the script does: the trajectories depend on
that config, and the validator rejects adversary knobs at eps = 0.

Usage:
    python -m go_avalanche_tpu_torch.examples.equivocation_threshold
        [--nodes 512] [--txs 64] [--rounds 600] [--device cuda|cpu]
        [--json-out go_avalanche_tpu_torch/examples/out/
                    equivocation_threshold.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.ops import voterecord as vr

EPS_GRID = (0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3)
P_GRID = (0.25, 0.5, 0.75, 1.0)


def resolved_fraction(state: dag.DagSimState, cfg: AvalancheConfig,
                      set_size: int) -> float:
    """Fraction of (honest live node, set) pairs with exactly one
    finalized-accepted winner."""
    conf = state.base.records.confidence
    fin_acc = (vr.has_finalized(conf, cfg)
               & vr.is_accepted(conf)).cpu().numpy()
    honest = (~state.base.byzantine & state.base.alive).cpu().numpy()
    winners = dag.winners_per_set(fin_acc, set_size)
    return float((winners[honest] == 1).mean()) if honest.any() else 0.0


def sweep_cell(n_nodes: int, n_txs: int, set_size: int, rounds: int,
               eps: float, p: float, strategy: AdversaryStrategy,
               seed: int = 0, quorum: int = 7, window: int = 8,
               device="cuda") -> dict:
    """One (eps, p, strategy) cell.  `quorum`/`window` sweep the vote
    window's conclusiveness rule (default = the protocol's 7-of-8,
    `vote.go:55,58`), as `quorum_dial` does."""
    dev = _device(device)
    cfg = AvalancheConfig(byzantine_fraction=eps, flip_probability=p,
                          adversary_strategy=strategy, quorum=quorum,
                          window=window)
    cs = torch.arange(n_txs, dtype=torch.int32, device=dev) // set_size
    state = dag.init(prng.key(seed, dev), n_nodes, cs, cfg, device=dev)
    run_cfg = dataclasses.replace(cfg, byzantine_fraction=1.0)
    final, _ = dag.run_scan(state, run_cfg, rounds, device=dev)
    frac = resolved_fraction(final, cfg, set_size)
    return {"eps": eps, "p": p, "q": round(eps * p, 4),
            "strategy": strategy.value, "resolved": round(frac, 4)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--txs", type=int, default=64)
    ap.add_argument("--conflict-size", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=600)
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("equivocation_threshold.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    cells = []
    t0 = time.time()
    for strategy in (AdversaryStrategy.EQUIVOCATE, AdversaryStrategy.FLIP):
        for p in P_GRID:
            for eps in EPS_GRID:
                cell = sweep_cell(args.nodes, args.txs, args.conflict_size,
                                  args.rounds, eps, p, strategy, device=dev)
                cells.append(cell)
                print(f"{strategy.value:>12} eps={eps:<5} p={p:<4} "
                      f"q={cell['q']:<6} resolved={cell['resolved']}",
                      flush=True)

    # Threshold per (strategy, p): smallest eps with resolved < 0.5.
    thresholds = {}
    for strategy in ("equivocate", "flip"):
        for p in P_GRID:
            col = [c for c in cells
                   if c["strategy"] == strategy and c["p"] == p]
            stalled = [c["eps"] for c in col if c["resolved"] < 0.5]
            thresholds[f"{strategy}_p{p}"] = min(stalled) if stalled else None

    result = {
        "config": {"nodes": args.nodes, "txs": args.txs,
                   "conflict_size": args.conflict_size,
                   "rounds": args.rounds,
                   "backend": dev.type},
        "cells": cells,
        "stall_threshold_eps": thresholds,
        "elapsed_s": round(time.time() - t0, 1),
        "card": card,
    }
    _common.write_json(args.json_out, result)
    print(f"\nthresholds (smallest eps with resolved<0.5): {thresholds}")
    print(f"artifact: {args.json_out} ({result['elapsed_s']}s"
          f"{_common.card_note(card)})")
    return result


if __name__ == "__main__":
    main()
