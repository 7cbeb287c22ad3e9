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
             churn 1e-4, `avalanche.run`;
  config 5 — `config5_backlog_scale` (lines 184-200): 1,000,000 backlog
             txs (4096 quick) through a 4096-slot window (256 quick) of
             1024 nodes (64 quick), scores ``randint(key(1), 0, 2**20)``,
             gossip off, the poll cap over the window, `backlog.run`;
  config 6 — `config6_streaming_conflict` (lines 203-248) through
             `benchmarks/workload.py`'s north-star builder (lines 20-22,
             205-249): 100000 nodes x 500,000 2-tx conflict sets (64 x
             1024 quick) through a 1024-set window (32 quick), scores
             ``randint(key(1), (sets, 2), 0, 2**20)``, gossip off, the
             poll cap over the window, `streaming_dag.run_chunked`.

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

import dataclasses
from typing import Dict, Tuple

import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import backlog, dag, snowball
from go_avalanche_tpu_torch.models import streaming_dag

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
    "config5": {"rounds": 4165, "txs_settled_fraction": 1.0},
    "config6": {"rounds": 8313, "sets_settled_fraction": 1.0,
                "sets_one_winner_fraction": 1.0,
                "settle_latency_median": 17.0, "settle_latency_p90": 17.0},
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
    "config5": {"rounds": 272, "txs_settled_fraction": 1.0},
    "config6": {"rounds": 544, "sets_settled_fraction": 1.0,
                "sets_one_winner_fraction": 1.0,
                "settle_latency_median": 17.0, "settle_latency_p90": 17.0},
}

# The north-star streaming conflict-DAG shapes (`benchmarks/workload.py`).
NORTH_STAR = dict(nodes=100_000, backlog_sets=500_000, set_cap=2,
                  window_sets=1024)
QUICK = dict(nodes=64, backlog_sets=1024, set_cap=2, window_sets=32)
# key(1) draws the scores, key(0) seeds the sim.
_SCORE_SEED, _SIM_SEED, _SCORE_MAX = 1, 0, 1 << 20


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


def config5_shape(quick: bool = False) -> Tuple[int, int, int]:
    """``(nodes, backlog txs, window slots)`` of config 5."""
    return (64, 4096, 256) if quick else (1024, 1_000_000, 4096)


def config5_config(window: int) -> AvalancheConfig:
    return AvalancheConfig(gossip=False, max_element_poll=window)


def config5_state(quick: bool = False, device="cuda", n_txs: int = None
                  ) -> Tuple[backlog.BacklogSimState, AvalancheConfig]:
    """``(state, cfg)`` of config 5 on `device`; `n_txs` cuts the backlog
    to its first `n_txs` scores of the same draw."""
    n, b, w = config5_shape(quick)
    cfg = config5_config(w)
    scores = prng.randint(prng.key(_SCORE_SEED, device), (b,), 0, _SCORE_MAX)
    if n_txs is not None:
        scores = scores[:n_txs]
    queue = backlog.make_backlog(scores)
    return backlog.init(prng.key(_SIM_SEED, device), n, w, queue, cfg,
                        device=device), cfg


def northstar_config(window_sets: int, set_cap: int) -> AvalancheConfig:
    """Config 6's config: gossip off and the poll cap over the window."""
    return AvalancheConfig(gossip=False,
                           max_element_poll=window_sets * set_cap)


def northstar_state(nodes: int, backlog_sets: int, set_cap: int,
                    window_sets: int, track_finality: bool = True,
                    retire_cap: int = None, device="cuda"
                    ) -> Tuple[streaming_dag.StreamingDagState,
                               AvalancheConfig]:
    """``(state, cfg)`` of the streaming conflict-DAG workload on
    `device`; `retire_cap` sets `cfg.stream_retire_cap`."""
    cfg = northstar_config(window_sets, set_cap)
    if retire_cap is not None:
        cfg = dataclasses.replace(cfg, stream_retire_cap=retire_cap)
    scores = prng.randint(prng.key(_SCORE_SEED, device),
                          (backlog_sets, set_cap), 0, _SCORE_MAX)
    queue = streaming_dag.make_set_backlog(scores)
    return streaming_dag.init(prng.key(_SIM_SEED, device), nodes,
                              window_sets, queue, cfg,
                              track_finality=track_finality,
                              device=device), cfg
