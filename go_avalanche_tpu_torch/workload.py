"""The flagship workload — `benchmarks/workload.py`, synchronous lane only.

The config and state the reference's `bench.py` times: 16384 nodes x
16384 txs at its full size, k=8, finalization out of reach within a
timed window (0x7FFE), gossip off (a pre-seeded feed, as in the
reference example `main.go:49-53`), the poll cap over every tx, and the
simulation seeded with ``key(0)``.
"""

from __future__ import annotations

from typing import Tuple

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av

FLAGSHIP_NODES = FLAGSHIP_TXS = 16384


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
