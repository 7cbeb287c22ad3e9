"""Capacity planning: max sustained offered load meeting a p99 finality
SLO — the port's twin of `examples/capacity_planning.py`.

**What sustained tx/round does an N-node network absorb at p99 finality
latency < X rounds?**  The sweep offers poisson load (`arrival_rate`)
to the streaming backlog scheduler, reads the finality-latency
percentiles from the traffic plane's histogram, holds them against a
host recomputation from the per-tx outputs
(`traffic.latency_percentiles_host`, asserted equal at every rate), and
prints the highest rate whose p99 meets the SLO with the whole backlog
drained.

    python -m go_avalanche_tpu_torch.examples.capacity_planning
    python -m go_avalanche_tpu_torch.examples.capacity_planning \
        --rates 4,8,16,32 --slo 40 --nodes 128 --slots 64 \
        --backpressure 0.7,0.95 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch import traffic as tf
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import backlog as bl
from go_avalanche_tpu_torch.models.avalanche import _device


def measure_rate(rate: float, n_nodes: int, slots: int, txs: int,
                 seed: int = 0, max_rounds: int = 20_000,
                 backpressure=None, finalization_score: int = 32,
                 device="cuda") -> dict:
    """One offered-load point: stream `txs` backlog txs at `rate`/round
    until drained; return the drain stats with in-graph AND host-side
    percentiles (asserted identical)."""
    dev = _device(device)
    cfg = AvalancheConfig(arrival_mode="poisson", arrival_rate=float(rate),
                          arrival_backpressure=backpressure,
                          finalization_score=finalization_score,
                          gossip=False, max_element_poll=max(4096, slots))
    backlog = bl.make_backlog(torch.arange(txs, dtype=torch.int32,
                                           device=dev))
    state = bl.init(prng.key(seed, dev), n_nodes, slots, backlog, cfg,
                    device=dev)
    final = bl.run(state, cfg, max_rounds, device=dev)
    settled = final.outputs.settled.cpu().numpy()

    in_graph = tf.latency_percentiles(final.traffic)
    host = tf.latency_percentiles_host(
        final.traffic.arrival_round.cpu().numpy(),
        final.outputs.settle_round.cpu().numpy(), settled.astype(np.int64),
        cfg.arrival_latency_buckets)
    for k in ("count", "p50", "p99", "p999"):
        key = f"finality_latency_{k}"
        if in_graph[key] != host[key]:
            raise AssertionError(
                f"in-graph {key}={in_graph[key]} != host recomputation "
                f"{host[key]} at rate {rate} — the percentile planes "
                f"disagree")
    return {
        "rate": rate,
        "rounds": int(final.sim.round),
        "drained": bool(settled.all()),
        "settled_fraction": float(settled.mean()),
        **in_graph,
    }


def measure(rates, n_nodes: int = 64, slots: int = 32, txs: int = 2048,
            slo_p99: int = 48, seed: int = 0, max_rounds: int = 20_000,
            backpressure=None, device="cuda") -> dict:
    """Sweep offered load; the verdict is the max rate whose p99 meets
    the SLO with the backlog fully drained within the horizon."""
    rows = [measure_rate(r, n_nodes, slots, txs, seed=seed,
                         max_rounds=max_rounds, backpressure=backpressure,
                         device=device)
            for r in rates]
    meeting = [row["rate"] for row in rows
               if row["drained"] and 0 <= row["finality_latency_p99"]
               <= slo_p99]
    return {
        "nodes": n_nodes, "slots": slots, "txs": txs,
        "slo_p99_rounds": slo_p99,
        "backpressure": backpressure,
        "rows": rows,
        "max_sustained_rate": max(meeting) if meeting else None,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rates", type=str, default="2,4,8,16,24",
                        help="comma-separated offered loads (tx/round)")
    parser.add_argument("--nodes", type=int, default=64)
    parser.add_argument("--slots", type=int, default=32)
    parser.add_argument("--txs", type=int, default=2048)
    parser.add_argument("--slo", type=int, default=48,
                        help="p99 finality-latency SLO in rounds")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-rounds", type=int, default=20_000)
    parser.add_argument("--backpressure", type=str, default=None,
                        metavar="LO,HI",
                        help="closed-loop admission occupancy fractions")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the sweep as JSON here")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = _device(args.device)
    card = _common.card(dev)

    rates = [float(r) for r in args.rates.split(",")]
    bp = (tuple(float(x) for x in args.backpressure.split(","))
          if args.backpressure else None)
    res = measure(rates, n_nodes=args.nodes, slots=args.slots,
                  txs=args.txs, slo_p99=args.slo, seed=args.seed,
                  max_rounds=args.max_rounds, backpressure=bp, device=dev)

    print(f"capacity sweep: {args.nodes} nodes, {args.slots}-slot window, "
          f"{args.txs}-tx backlog, SLO p99 <= {args.slo} rounds"
          + (f", backpressure {bp}" if bp else "")
          + f" on {dev.type}{_common.card_note(card)}")
    print(f"{'rate':>8} {'rounds':>8} {'drained':>8} {'p50':>6} "
          f"{'p99':>6} {'p999':>6}  verdict")
    for row in res["rows"]:
        ok = (row["drained"]
              and 0 <= row["finality_latency_p99"] <= args.slo)
        print(f"{row['rate']:>8g} {row['rounds']:>8} "
              f"{str(row['drained']):>8} "
              f"{row['finality_latency_p50']:>6} "
              f"{row['finality_latency_p99']:>6} "
              f"{row['finality_latency_p999']:>6}  "
              f"{'MEETS SLO' if ok else 'violates SLO'}")
    if res["max_sustained_rate"] is None:
        print("no swept rate meets the SLO — lower the load or raise "
              "the window")
    else:
        print(f"max sustained arrival rate meeting p99 <= {args.slo}: "
              f"{res['max_sustained_rate']:g} tx/round "
              f"(in-graph percentiles == host recomputation, bit-for-bit)")
    if args.out:
        _common.write_json(args.out, res)
        print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
