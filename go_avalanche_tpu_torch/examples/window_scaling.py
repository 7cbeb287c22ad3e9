"""Streaming-scheduler scaling: settle throughput vs window and node
count — the port's twin of `examples/window_scaling.py`.

Measures settled txs/sec across a (nodes, window) grid for the plain
backlog and the streaming conflict DAG.  Each cell streams a backlog of
``fill * W`` txs (a fixed number of window generations), so every cell
does comparable scheduler work per slot and wall-clock differences
isolate the per-round cost of the window itself.  One step runs before
the clock starts (the kernels' first launch loads them), and every
rate stands beside the card's name and power limit.

    python -m go_avalanche_tpu_torch.examples.window_scaling
    python -m go_avalanche_tpu_torch.examples.window_scaling \
        --nodes 1024,16384 --windows 1024,4096 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import backlog as bl
from go_avalanche_tpu_torch.models import streaming_dag as sdg
from go_avalanche_tpu_torch.models.avalanche import _device


def cell_backlog(n_nodes: int, window: int, fill: int, seed: int,
                 device="cuda") -> dict:
    dev = _device(device)
    cfg = AvalancheConfig(gossip=False, max_element_poll=window)
    b = fill * window
    backlog = bl.make_backlog(
        prng.randint(prng.key(seed + 1, dev), (b,), 0, 1 << 20))
    state = bl.init(prng.key(seed, dev), n_nodes, window, backlog, cfg,
                    device=dev)
    bl.step(state, cfg)        # the first launch out of the timing
    _common.synchronize(dev)
    t0 = time.time()
    final = bl.run(state, cfg, 500_000, device=dev)
    rounds = int(final.sim.round)
    wall = time.time() - t0
    settled = final.outputs.settled.cpu().numpy()
    return {
        "model": "backlog", "nodes": n_nodes, "window": window, "txs": b,
        "rounds": rounds, "settled_fraction": float(settled.mean()),
        "txs_per_sec": round(float(settled.sum()) / wall, 1),
        "wall_s": round(wall, 2),
    }


def cell_streaming_dag(n_nodes: int, window: int, fill: int,
                       seed: int, device="cuda") -> dict:
    c = 2
    if window % c:
        raise ValueError(f"window ({window}) must divide by the conflict-set "
                         f"capacity ({c}) so both models run the same width")
    dev = _device(device)
    w_sets = window // c
    cfg = AvalancheConfig(gossip=False, max_element_poll=window)
    b_sets = fill * w_sets
    backlog = sdg.make_set_backlog(
        prng.randint(prng.key(seed + 1, dev), (b_sets, c), 0, 1 << 20))
    state = sdg.init(prng.key(seed, dev), n_nodes, w_sets, backlog, cfg,
                     device=dev)
    sdg.step(state, cfg)       # the first launch out of the timing
    _common.synchronize(dev)
    t0 = time.time()
    final = sdg.run(state, cfg, 500_000, device=dev)
    rounds = int(final.dag.base.round)
    wall = time.time() - t0
    summary = sdg.resolution_summary(final)
    return {
        "model": "streaming_dag", "nodes": n_nodes, "window": window,
        "txs": b_sets * c, "rounds": rounds,
        "settled_fraction": summary["sets_settled_fraction"],
        "one_winner_fraction": summary["sets_one_winner_fraction"],
        "txs_per_sec": round(summary["txs_settled"] / wall, 1),
        "wall_s": round(wall, 2),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=str, default="1024,8192,32768,100000")
    ap.add_argument("--windows", type=str, default="1024,4096")
    ap.add_argument("--fill", type=int, default=8,
                    help="backlog = fill * window txs per cell")
    ap.add_argument("--models", type=str, default="backlog,streaming_dag")
    ap.add_argument("--seed", type=int, default=0)
    _common.add_device_arg(ap)
    ap.add_argument("--json-out", type=str,
                    default=_common.out_path("window_scaling.json"))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    runners = {"backlog": cell_backlog, "streaming_dag": cell_streaming_dag}
    cells = []
    for model in args.models.split(","):
        for n in (int(x) for x in args.nodes.split(",")):
            for w in (int(x) for x in args.windows.split(",")):
                cell = runners[model](n, w, args.fill, args.seed, dev)
                cells.append(cell)
                print(json.dumps({**cell, "card": card}), flush=True)

    result = {"backend": dev.type, "fill": args.fill,
              "cells": cells, "card": card}
    _common.write_json(args.json_out, result)
    print(f"artifact: {args.json_out}")
    return cells


if __name__ == "__main__":
    main()
