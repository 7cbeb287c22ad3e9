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
             with ``key(0)``, run to settlement;
  config 0 — `benchmarks/baseline_suite.config0_reference_example`
             (lines 52-68): the reference example verbatim, 100 nodes x
             100 txs, the default config, `avalanche.run`;
  config 1 — `config1_snowball` (lines 71-89): single-decree Snowball,
             1000 nodes (64 quick) split 50/50, `snowball.run`;
  config 3 — `config3_byzantine_mix` (lines 115-158): the conflict DAG,
             100000 nodes x 512 txs (512 x 64 quick) in 2-tx sets, 20%
             byzantine lying always, FLIP and EQUIVOCATE, `dag.run` for
             at most 600 rounds (400 quick);
  config 4 — `config4_churn_latency` (lines 161-181): 100000 nodes x
             256 txs (512 x 32 quick), latency-weighted sampling over
             log-normal propensities ``exp(normal(key(42)) * 0.5)``,
             churn 1e-4, `avalanche.run`.

Each config's builder seeds the state with ``key(0)`` as the suite does.
Config 4's propensities come from the port's `prng.normal`, which is
within 3 ulp of `jax.random.normal` (``tests/test_torch_prng.py``), and
an `exp` taken in float64 and rounded once, so the vector is the same on
the CPU and on the card.  The reference's recorded results
(`benchmarks/results.json`, a TPU run) are in `REFERENCE`; configs 0, 1
and 3 take integer paths only, so the record holds on any backend.
Config 4's float path makes the record a claim about jax's own weights:
recorded 17 rounds, finalized fraction 0.99843, finality median 16.  The
JAX package's `avalanche.run` on the CPU at 100000 x 256 gives 17 rounds,
40192 unfinalized records (fraction 0.99843) and median 16 both on the
port's weights and on jax's, so config 4 is gated on the record.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag, snowball

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


# The recorded results of configs 0, 1, 3 and 4 (benchmarks/results.json).
REFERENCE = {
    "config0": {"rounds": 17, "nodes_fully_finalized": 100,
                "finality_median": 16.0},
    "config1": {"rounds": 26, "finalized_fraction": 1.0,
                "agreed_one_value": True, "finality_median": 23.0,
                "finality_min": 19, "finality_max": 25},
    "config3_flip": {"rounds": 97, "honest_sets_resolved": 1.0,
                     "finality_median": 32.0},
    "config3_equivocate": {"rounds": 600, "honest_sets_resolved": 0.0},
    "config4": {"rounds": 17, "unfinalized_records": 40192,
                "finality_median": 16.0},
}

# The JAX package's own results at the suite's --quick shapes, on the CPU
# (`benchmarks/baseline_suite.py --quick`); config 0 has no quick shape.
REFERENCE_QUICK = {
    "config0": REFERENCE["config0"],
    "config1": {"rounds": 21, "finalized_fraction": 1.0,
                "agreed_one_value": True, "finality_median": 18.0,
                "finality_min": 17, "finality_max": 20},
    "config3_flip": {"rounds": 69, "honest_sets_resolved": 1.0,
                     "finality_median": 32.0},
    "config3_equivocate": {"rounds": 400, "honest_sets_resolved": 0.0},
    "config4": {"rounds": 17, "unfinalized_records": 32,
                "finality_median": 16.0},
}


def config0_state(device="cuda") -> Tuple[av.AvalancheSimState,
                                          AvalancheConfig]:
    """``(state, cfg)`` of config 0: 100 x 100, the default config."""
    cfg = AvalancheConfig()
    return av.init(prng.key(0, device), 100, 100, cfg, device=device), cfg


def config1_state(quick: bool = False, device="cuda"
                  ) -> Tuple[snowball.SnowballState, AvalancheConfig]:
    """``(state, cfg)`` of config 1: Snowball, 1000 nodes (64 quick),
    yes_fraction 0.5."""
    cfg = AvalancheConfig()
    n = 64 if quick else 1000
    return snowball.init(prng.key(0, device), n, cfg, yes_fraction=0.5,
                         device=device), cfg


def config3_shape(quick: bool = False) -> Tuple[int, int, int]:
    """``(nodes, txs, max_rounds)`` of config 3."""
    return (512, 64, 400) if quick else (100_000, 512, 600)


def config3_states(quick: bool = False, device="cuda"
                   ) -> Dict[str, Tuple[dag.DagSimState, AvalancheConfig]]:
    """strategy name -> ``(state, cfg)`` of config 3, FLIP and
    EQUIVOCATE."""
    n, t, _ = config3_shape(quick)
    out = {}
    for strategy in (AdversaryStrategy.FLIP, AdversaryStrategy.EQUIVOCATE):
        cfg = AvalancheConfig(byzantine_fraction=0.2, flip_probability=1.0,
                              adversary_strategy=strategy,
                              max_element_poll=max(4096, t))
        conflict_set = torch.arange(t, dtype=torch.int32) // 2
        out[strategy.value] = (dag.init(prng.key(0, device), n, conflict_set,
                                        cfg, device=device), cfg)
    return out


def config4_weights(n: int) -> torch.Tensor:
    """Config 4's float32 ``[n]`` log-normal sampling propensities,
    ``exp(normal(key(42)) * 0.5)``, made on the CPU."""
    z = prng.normal(prng.key(42, "cpu"), (n,)) * 0.5
    return torch.exp(z.double()).float()


def config4_state(quick: bool = False, device="cuda",
                  weights: torch.Tensor = None
                  ) -> Tuple[av.AvalancheSimState, AvalancheConfig]:
    """``(state, cfg)`` of config 4: 100000 x 256 (512 x 32 quick),
    weighted sampling, churn 1e-4; `weights` replaces the port's
    propensities (a test passes the reference's)."""
    n, t = (512, 32) if quick else (100_000, 256)
    cfg = AvalancheConfig(weighted_sampling=True, churn_probability=1e-4,
                          max_element_poll=max(4096, t))
    if weights is None:
        weights = config4_weights(n)
    return av.init(prng.key(0, device), n, t, cfg, latency_weights=weights,
                   device=device), cfg
