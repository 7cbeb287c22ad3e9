"""A multi-process `torch.distributed` smoke of the sharded round —
`go_avalanche_tpu/parallel/distributed_smoke.py`.

N processes join one process group (`runtime.initialize_runtime`),
build the runtime mesh, run two sharded avalanche rounds and
cross-check the psum'd telemetry, which every rank must read the same.
Each process prints one JSON line; a disagreement raises (nonzero
exit).  On the CPU (gloo):

    python -m go_avalanche_tpu_torch.parallel.distributed_smoke \\
        --init-method tcp://localhost:29511 --world-size 2 --rank 0 \\
        --device cpu
    ...the same with --rank 1

On the card each rank takes its own card (NCCL); ranks sharing one
card pass ``--backend gloo``.  Under ``torchrun`` pass
``--init-method env://`` and leave out the world size and rank.
"""

from __future__ import annotations

import argparse
import json
import sys


def run(n_tx_shards: int = 1, device="cuda") -> dict:
    """Two sharded rounds on the runtime mesh of the running process
    group, on this rank's card (`runtime.rank_device`; pass
    ``device="cpu"`` for the CPU); returns this rank's digest after
    checking that every rank read the same telemetry."""
    import torch.distributed as dist

    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import world
    from go_avalanche_tpu_torch.parallel.runtime import (build_on_mesh,
                                                         make_runtime_mesh,
                                                         rank_device)

    size, rank = world()
    dev = rank_device(av._device(device))
    mesh = make_runtime_mesh(n_tx_shards=n_tx_shards)
    cfg = AvalancheConfig()
    # Every rank builds the same global state from the same key and
    # keeps its block.
    state = build_on_mesh(
        lambda: av.init(prng.key(0, dev), 16, 8, cfg, device=dev), mesh,
        sharded.shard_state)
    step = sharded.make_sharded_round_step(mesh, cfg)
    state, tel = step(state)
    state, tel = step(state)
    digest = {
        "process": rank,
        "processes": size,
        "devices": mesh.size,
        "round": int(state.round),
        "polls": int(tel.polls),
        "votes_applied": int(tel.votes_applied),
    }
    assert digest["round"] == 2, digest
    assert digest["polls"] > 0, digest
    if size > 1:
        seen = [None] * size
        dist.all_gather_object(seen, {k: digest[k] for k in
                                      ("round", "polls", "votes_applied")})
        assert all(s == seen[0] for s in seen), seen
    return digest


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--init-method", required=True,
                        help="tcp://host:port of rank 0, file://PATH, or "
                             "env:// under torchrun")
    parser.add_argument("--world-size", type=int, default=None)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                        help="gloo when ranks share one card")
    parser.add_argument("--tx-shards", type=int, default=1)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from go_avalanche_tpu_torch.parallel.runtime import initialize_runtime

    rank = initialize_runtime(args.init_method, args.world_size, args.rank,
                              device=args.device, backend=args.backend)
    if args.rank is not None:
        assert rank == args.rank, (rank, args.rank)
    try:
        print(json.dumps(run(args.tx_shards, args.device)), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
