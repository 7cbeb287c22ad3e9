"""The port's workloads, copied (not imported: `benchmarks/` imports JAX).

  flagship — `benchmarks/workload.py`, synchronous lane only: the config
             and state the reference's `bench.py` times, 16384 nodes x
             16384 txs at its full size, k=8, finalization out of reach
             within a timed window (0x7FFE), gossip off (a pre-seeded
             feed, as in the reference example `main.go:49-53`), the
             poll cap over every tx, seeded with ``key(0)``;
  DAG      — `benchmarks/baseline_suite.config2_dag`, BASELINE.json's
             "Avalanche DAG: 10k nodes, 10k-tx UTXO conflict graph":
             10000 nodes x 10000 txs in 2-tx double-spend sets
             (``conflict_set = arange(T) // 2``), the default protocol
             (k=8, finalization 128), the poll cap over every tx, seeded
             with ``key(0)``, run to settlement.
"""

from __future__ import annotations

from typing import Tuple

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag

FLAGSHIP_NODES = FLAGSHIP_TXS = 16384
DAG_NODES = DAG_TXS = 10_000


def flagship_config(txs: int, k: int = 8,
                    round_engine: str = "phased") -> AvalancheConfig:
    """The flagship config for a `txs`-wide network."""
    return AvalancheConfig(finalization_score=0x7FFE, k=k, gossip=False,
                           max_element_poll=max(4096, txs),
                           round_engine=round_engine)


def flagship_state(nodes: int, txs: int, k: int = 8,
                   round_engine: str = "phased", device="cuda"
                   ) -> Tuple[av.AvalancheSimState, AvalancheConfig]:
    """``(state, cfg)`` of the flagship workload on `device`."""
    cfg = flagship_config(txs, k, round_engine)
    return av.init(prng.key(0, device), nodes, txs, cfg, device=device), cfg


def dag_baseline_config(txs: int) -> AvalancheConfig:
    """The DAG baseline's config for a `txs`-wide network."""
    return AvalancheConfig(max_element_poll=max(4096, txs))


def dag_baseline_state(nodes: int, txs: int, device="cuda"
                       ) -> Tuple[dag.DagSimState, AvalancheConfig]:
    """``(state, cfg)`` of the DAG baseline on `device`."""
    cfg = dag_baseline_config(txs)
    conflict_set = torch.arange(txs, dtype=torch.int32) // 2
    return dag.init(prng.key(0, device), nodes, conflict_set, cfg,
                    device=device), cfg
