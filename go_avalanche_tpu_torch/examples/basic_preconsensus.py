"""Basic pre-consensus simulation — the reference example, batched; the
port's twin of `examples/basic_preconsensus.py`.

The rendition of the reference's `examples/basic-preconcensus/main.go`:
N nodes reconcile T transactions (every node fed every tx up front),
poll random peers each round, and the run reports wall-clock, how many
nodes fully finalized, and the throughput/finality metrics the
reference never had.

    python -m go_avalanche_tpu_torch.examples.basic_preconsensus \
        --nodes 100 --txs 100 --logging [--device cuda|cpu]

The batched path is the port's `models/avalanche.run` on the card;
``--host-api`` runs the reference example verbatim through the host
`Processor` API instead (pure Python, no device).
"""

from __future__ import annotations

import argparse
import time

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.utils import metrics


def run_host_api(args) -> None:
    """The reference example verbatim through the host `Processor` API.

    One Python `Processor` per node (`main.go:73-87`), synchronous peer
    `query` with gossip-on-poll admission and honest own-acceptance votes
    (`main.go:168-193`), round-robin peer selection (`main.go:111-116`),
    counting nodes whose every tx finalized (`main.go:159-161`).  Object-
    per-record and O(nodes^2 * txs) in Python — the workload the batched
    path above does in one fused step; keep sizes modest here.
    """
    import random

    from go_avalanche_tpu_torch import Connman, Processor
    from go_avalanche_tpu_torch.types import Response, Status, Tx, Vote

    rng = random.Random(args.seed)
    n, t = args.nodes, args.txs
    connman = Connman()
    for i in range(n):
        connman.add_node(i)
    processors = [Processor(connman) for _ in range(n)]
    txs = {h: Tx(h) for h in range(t)}

    t0 = time.time()
    for h in rng.sample(range(t), t):        # shuffled feed (`main.go:49-53`)
        for p in processors:
            p.add_target_to_reconcile(txs[h])

    finalized = [0] * n
    fully = 0
    for rnd in range(args.max_rounds):
        for i, p in enumerate(processors):
            if finalized[i] >= t:
                continue
            # Round-robin over the OTHER n-1 peers: the reference skips
            # itself and immediately queries the next node
            # (`main.go:113-116`), so a self-hit advances one further
            # instead of idling the round.
            peer = (i + 1 + rnd) % n
            if peer == i:
                peer = (peer + 1) % n
            invs = p.get_invs_for_next_poll()
            if not invs:
                continue
            votes = []
            for inv in invs:                  # the peer's `query`
                target = txs[inv.target_hash]
                processors[peer].add_target_to_reconcile(target)  # gossip
                err = 0 if processors[peer].is_accepted(target) else 1
                votes.append(Vote(err, inv.target_hash))
            updates: list = []
            p.register_votes(peer, Response(p.get_round(), 0, votes),
                             updates)
            for u in updates:
                if u.status is Status.FINALIZED:
                    finalized[i] += 1
                    if finalized[i] == t:
                        fully += 1
        if fully == n:
            break
    dt = time.time() - t0
    print(f"Finished in {dt:f}s")
    print(f"Nodes fully finalized: {fully}/{n} "
          f"in {rnd + 1} rounds (host API, pure Python)")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=100)
    parser.add_argument("--txs", type=int, default=100)
    parser.add_argument("--k", type=int, default=8)
    parser.add_argument("--byzantine", type=float, default=0.0,
                        help="fraction of adversarial voters")
    parser.add_argument("--drop", type=float, default=0.0,
                        help="response drop probability")
    parser.add_argument("--max-rounds", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--logging", action="store_true")
    parser.add_argument("--host-api", action="store_true",
                        help="run through the per-node host Processor API "
                             "instead of the batched simulator")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    if args.host_api:
        run_host_api(args)
        return {}

    dev = av._device(args.device)
    card = _common.card(dev)
    note = _common.card_note(card)
    cfg = AvalancheConfig(k=args.k, byzantine_fraction=args.byzantine,
                          drop_probability=args.drop)
    state = av.init(prng.key(args.seed, dev), args.nodes, args.txs, cfg,
                    device=dev)

    t0 = time.time()
    final = av.run(state, cfg, max_rounds=args.max_rounds, device=dev)
    rounds = int(final.round)  # the read waits for the device
    dt = time.time() - t0

    fin = vr.has_finalized(final.records.confidence).cpu().numpy()
    fully = int(fin.all(axis=1).sum())
    votes = args.nodes * args.txs * cfg.k * rounds  # upper bound (pre-freeze)

    result = {"nodes": args.nodes, "txs": args.txs,
              "fully_finalized": fully, "rounds": rounds,
              "backend": dev.type, "seconds": dt,
              "card": card}
    print(f"Finished in {dt:f}s{note}")
    print(f"Nodes fully finalized: {fully}/{args.nodes} "
          f"in {rounds} rounds on {result['backend']}")
    if args.logging:
        stats = metrics.rounds_to_finality(final.finalized_at)
        result["rounds_to_finality"] = stats
        result["votes_per_sec"] = metrics.votes_per_second(votes, dt)
        print(f"rounds-to-finality: {stats}")
        print(f"~{result['votes_per_sec']:.3g} votes/sec "
              f"(upper bound){note}")
    return result


if __name__ == "__main__":
    main()
