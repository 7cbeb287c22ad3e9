"""The port's workloads, copied (not imported: `benchmarks/` imports JAX).

  flagship — `benchmarks/workload.py` (lines 29-130): the config and
             state the reference's `bench.py` times, 16384 nodes x
             16384 txs at its full size, k=8, finalization out of reach
             within a timed window (0x7FFE), gossip off (a pre-seeded
             feed, as in the reference example `main.go:49-53`), the
             poll cap over every tx, seeded with ``key(0)``; with
             ``latency > 0`` its async lane (`bench.py --latency`):
             fixed latency, one-second rounds and the timeout at
             ``default_timeout_rounds(latency)``, on the chosen delivery
             engine, optionally under a fault script (the reference's
             `flagship_faults` program, `FLAGSHIP_FAULTS`); the
             reference's other program knobs (taps, stake, adaptive
             adversary); `fleet_flagship_state`, F flagship trials
             stacked on a leading trial axis (`bench.py --fleet`);
             `traffic_backlog_state`, the `--arrival` lane (lines
             159-202);
  faults   — `examples/fault_scenarios.py`'s studies at their example
             shape, 512 nodes x 64 txs, contested priors, seed 0:
             `measure()` (lines 76-116, the partition that heals) and
             the three `SCENARIOS` (lines 174-240), each with the JAX
             package's own per-round record (`FAULT_STUDY_RECORDS`) and
             recovery verdict (`RECOVERY_RECORDS`);
  policies — the adaptive adversary's exactness cases (`POLICY_CASES`):
             256 nodes x 64 txs, 20% byzantine, seed 0, 40 rounds, each
             policy on the avalanche round (and "off"), timing and
             withholding under geometric latency 2, split_vote on the
             DAG under it, each with the JAX package's own per-round
             record (`POLICY_RECORDS`);
  fleets   — the Monte-Carlo fleet's two points (`FLEET_CASES`): the
             most hostile point of `examples/adversary_atlas.py` at its
             defaults (16 trials) and an avalanche phase grid over the
             policy axis at 4096 x 1024, each with the JAX package's rows
             (`FLEET_RECORDS`) and a traced run's per-trial trace digest
             (`FLEET_TRACE_RECORDS`);
  sharded  — the sharded drivers' cases (`SHARDED_CASES`): the flagship
             at 4096 x 4096 with 20% byzantine (`mesh_flagship_state`),
             5 rounds of `run_scan_sharded` on meshes 1x1, 2x1 and 4x1,
             and the DAG baseline at 2048 x 2048 through
             `run_sharded_dag` to settlement on 1x1 and 2x1, each with
             the JAX package's sha256 of every final leaf and of the
             telemetry (`SHARDED_RECORDS`, `leaf_digests`);
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
import hashlib
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import (AdversaryStrategy, AvalancheConfig,
                                           fault_script_from_json)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import backlog, dag, snowball
from go_avalanche_tpu_torch.models import streaming_dag
from go_avalanche_tpu_torch.obs.tags import default_timeout_rounds

FLAGSHIP_NODES = FLAGSHIP_TXS = 16384
# key(1) draws the scores, key(0) seeds the sim (the reference's seeds).
_SCORE_SEED, _SIM_SEED, _SCORE_MAX = 1, 0, 1 << 20
DAG_NODES = DAG_TXS = 10_000


# The reference's `flagship_faults` script (`benchmarks/hlo_pin.py`): a
# 50/50 partition over rounds [5, 10), then a +2 latency spike over
# [12, 15), in the JSON spelling.
FLAGSHIP_FAULTS = [["partition", 5, 10, 0.5], ["latency_spike", 12, 15, 2]]


def flagship_config(txs: int, k: int = 8, latency: int = 0,
                    latency_mode: str = "fixed",
                    timeout_rounds: Optional[int] = None,
                    inflight_engine: str = "walk",
                    round_engine: str = "phased",
                    faults: Optional[list] = None,
                    metrics_every: int = 0,
                    trace_every: int = 0,
                    stake: str = "off",
                    clusters: int = 1,
                    adversary: str = "off",
                    byzantine: float = 0.0) -> AvalancheConfig:
    """The flagship config for a `txs`-wide network.  ``latency > 0``
    selects the async lane: `latency_mode` at `latency` rounds,
    ``time_step_s=1`` and the timeout at `timeout_rounds` (default
    `default_timeout_rounds`), on `inflight_engine`; `faults` is a
    JSON-spelled fault script (`fault_script_from_json`).  The rest
    are the reference's program knobs (`benchmarks/workload.py:29-105`):
    `metrics_every` / `trace_every` the taps, `stake` with `clusters`
    the stake-weighted draw, `adversary` with `byzantine` an adaptive
    adversary policy."""
    async_kw = {}
    if latency > 0:
        tr = (default_timeout_rounds(latency) if timeout_rounds is None
              else timeout_rounds)
        if latency_mode == "fixed" and tr <= latency:
            raise ValueError(
                f"timeout_rounds={tr} <= latency={latency}: every fixed-"
                f"latency draw would expire unanswered — the bench lane "
                f"measures delivery, not a timeout storm")
        async_kw = dict(latency_mode=latency_mode, latency_rounds=latency,
                        time_step_s=1.0, request_timeout_s=float(tr - 1),
                        inflight_engine=inflight_engine)
    if faults is not None:
        async_kw["fault_script"] = fault_script_from_json(faults)
    if adversary != "off" or byzantine > 0.0:
        async_kw.update(byzantine_fraction=byzantine,
                        adversary_policy=adversary)
    return AvalancheConfig(finalization_score=0x7FFE, k=k, gossip=False,
                           max_element_poll=max(4096, txs),
                           metrics_every=metrics_every,
                           trace_every=trace_every, stake_mode=stake,
                           n_clusters=clusters,
                           round_engine=round_engine, **async_kw)


def flagship_state(nodes: int, txs: int, k: int = 8, latency: int = 0,
                   device="cuda", trace_rounds: int = 0, **kwargs
                   ) -> Tuple[av.AvalancheSimState, AvalancheConfig]:
    """``(state, cfg)`` of the flagship workload on `device`; `kwargs`
    pass to `flagship_config`.  With ``trace_every > 0`` the trace plane
    is attached for a `trace_rounds` horizon."""
    cfg = flagship_config(txs, k, latency, **kwargs)
    state = av.init(prng.key(_SIM_SEED, device), nodes, txs, cfg,
                    device=device)
    if cfg.trace_every > 0:
        state = av.with_trace(state, cfg, trace_rounds)
    return state, cfg


def fleet_flagship_state(fleet: int, nodes: int, txs: int, k: int = 8,
                         latency: int = 0, device="cuda", **kwargs
                         ) -> Tuple[av.AvalancheSimState, AvalancheConfig]:
    """``(state, cfg)``: `fleet` flagship states stacked on a leading
    ``[F]`` trial axis, trial i from ``prng.split(prng.key(0), fleet)[i]``
    — `benchmarks/workload.py:133-156`.  ``fleet == 1`` returns the
    flagship state unstacked, as the reference's does.  Each trial is
    built alone and written into preallocated stacked leaves, so the
    peak is the stack plus one trial (at 8 x 16384² a list of finished
    trials would hold the 19.3 GB stack twice)."""
    from go_avalanche_tpu_torch.parallel import sharded_fleet

    if fleet == 1:
        return flagship_state(nodes, txs, k, latency, device=device,
                              **kwargs)
    dev = av._device(device)
    cfg = flagship_config(txs, k, latency, **kwargs)
    keys = prng.split(prng.key(_SIM_SEED, dev), fleet)
    stack = None
    for i in range(fleet):
        one = av.init(keys[i], nodes, txs, cfg, device=dev)
        if stack is None:
            stack = sharded_fleet._map(
                lambda x: torch.empty((fleet,) + tuple(x.shape),
                                      dtype=x.dtype, device=x.device), one)
        sharded_fleet.write_trial(stack, i, one)
        del one
    return stack, cfg


def traffic_config(window: int, k: int = 8, rate: float = 24.0,
                   metrics_every: int = 0, trace_every: int = 0
                   ) -> AvalancheConfig:
    """The reference's `bench.py --arrival` config
    (`benchmarks/workload.py:159-177`): Poisson arrivals at `rate` with
    backpressure over the streaming backlog, gossip off, the poll cap
    over the window, the reference finalization score."""
    return AvalancheConfig(k=k, gossip=False,
                           max_element_poll=max(4096, window),
                           arrival_mode="poisson", arrival_rate=float(rate),
                           arrival_backpressure=(0.7, 0.95),
                           metrics_every=metrics_every,
                           trace_every=trace_every)


def traffic_backlog_state(nodes: int, txs: int, window: int, k: int = 8,
                          rate: float = 24.0, metrics_every: int = 0,
                          trace_every: int = 0, trace_rounds: int = 0,
                          device="cuda"
                          ) -> Tuple[backlog.BacklogSimState,
                                     AvalancheConfig]:
    """``(state, cfg)`` of the `--arrival` workload
    (`benchmarks/workload.py:180-202`): `txs` backlog entries scored from
    ``key(1)`` through a `window`-slot working set seeded with
    ``key(0)``."""
    cfg = traffic_config(window, k, rate, metrics_every, trace_every)
    scores = prng.randint(prng.key(_SCORE_SEED, device), (txs,), 0,
                          _SCORE_MAX)
    state = backlog.init(prng.key(_SIM_SEED, device), nodes, window,
                         backlog.make_backlog(scores), cfg, device=device)
    if cfg.trace_every > 0:
        state = backlog.with_trace(state, cfg, trace_rounds)
    return state, cfg


FAULT_STUDY_SHAPE = (512, 64)        # nodes, txs
FAULT_STUDY_TIMEOUT = 4              # timeout_rounds of every study


def fault_study_config(name: str, inflight_engine: str = "walk"
                       ) -> Tuple[AvalancheConfig, int]:
    """``(cfg, rounds)`` of a fault study: "measure" (a 50/50 partition
    over [5, 60), latency 1, 130 rounds), "cascading_outage" (clusters 0
    and 1 dark over [10, 30) and [20, 40) of 4, 70 rounds), "flaky_isp"
    (cluster 2 at RTT 3, others 1, spikes +2 over [12, 16) and [30, 34),
    60 rounds) or "eclipse" (a 12.5% split over [15, 45), 80 rounds);
    finalization score 48, one-second rounds, timeout 4, delivered by
    `inflight_engine`."""
    timing = dict(finalization_score=48, time_step_s=1.0,
                  request_timeout_s=float(FAULT_STUDY_TIMEOUT - 1),
                  inflight_engine=inflight_engine)
    if name == "measure":
        return AvalancheConfig(latency_mode="fixed", latency_rounds=1,
                               partition_spec=(5, 60, 0.5), **timing), 130
    if name == "cascading_outage":
        return AvalancheConfig(
            n_clusters=4, latency_mode="fixed", latency_rounds=1,
            fault_script=(("regional_outage", 10, 30, 0),
                          ("regional_outage", 20, 40, 1)), **timing), 70
    if name == "flaky_isp":
        rtt = tuple(tuple(3 if 2 in (i, j) and i != j else 1
                          for j in range(4)) for i in range(4))
        return AvalancheConfig(
            n_clusters=4, latency_mode="rtt", rtt_matrix=rtt,
            fault_script=(("latency_spike", 12, 16, 2),
                          ("latency_spike", 30, 34, 2)), **timing), 60
    if name == "eclipse":
        return AvalancheConfig(
            latency_mode="fixed", latency_rounds=1,
            fault_script=(("partition", 15, 45, 0.125),), **timing), 80
    raise ValueError(f"unknown fault study {name!r}")


def fault_study_state(name: str, inflight_engine: str = "walk",
                      device="cuda"
                      ) -> Tuple[av.AvalancheSimState, AvalancheConfig, int]:
    """``(state, cfg, rounds)`` of a fault study on `device`: contested
    per-node priors, seeded with ``key(0)``."""
    cfg, rounds = fault_study_config(name, inflight_engine)
    n, t = FAULT_STUDY_SHAPE
    state = av.init(prng.key(0, device), n, t, cfg,
                    init_pref=av.contested_init_pref(0, n, t, device),
                    device=device)
    return state, cfg, rounds


# The adaptive adversary's exactness cases: 256 nodes x 64 txs, 20%
# byzantine, seed 0, 40 rounds.  Sync cases run the avalanche round from
# contested priors under each policy (and "off", the control); async
# cases run under geometric latency 2 with the bench lane's timeout
# (`default_timeout_rounds(2)` = 6 rounds), the DAG case on 2-tx sets
# from its default priors.  Each is (model, config knobs); the knobs
# build the JAX package's config as well.
POLICY_SHAPE = (256, 64)             # nodes, txs
POLICY_ROUNDS = 40
_POLICY_ASYNC = dict(latency_mode="geometric", latency_rounds=2,
                     time_step_s=1.0,
                     request_timeout_s=float(default_timeout_rounds(2) - 1))
POLICY_CASES = {
    "off": ("avalanche", dict(byzantine_fraction=0.2)),
    "split_vote": ("avalanche", dict(byzantine_fraction=0.2,
                                     adversary_policy="split_vote")),
    "withhold_near_quorum": ("avalanche", dict(
        byzantine_fraction=0.2, adversary_policy="withhold_near_quorum")),
    "stake_eclipse": ("avalanche", dict(byzantine_fraction=0.2,
                                        adversary_policy="stake_eclipse",
                                        stake_mode="zipf")),
    "async_timing": ("avalanche", dict(byzantine_fraction=0.2,
                                       adversary_policy="timing",
                                       **_POLICY_ASYNC)),
    "async_withhold_near_quorum": ("avalanche", dict(
        byzantine_fraction=0.2, adversary_policy="withhold_near_quorum",
        **_POLICY_ASYNC)),
    "dag_async_split_vote": ("dag", dict(byzantine_fraction=0.2,
                                         adversary_policy="split_vote",
                                         **_POLICY_ASYNC)),
}


def policy_engines(name: str) -> Tuple[str, ...]:
    """The engines a policy case runs on: both ingest kernels for a sync
    case, the three delivery engines for an async one."""
    if POLICY_CASES[name][1].get("latency_mode", "none") == "none":
        return ("u8", "swar32")
    return ("walk", "walk_earlyout", "coalesced")


def policy_state(name: str, engine: str, device="cuda"):
    """``(model, state, cfg)`` of a policy case on `engine` (an ingest
    engine for a sync case, a delivery engine for an async one), seeded
    with ``key(0)``."""
    model, knobs = POLICY_CASES[name]
    knobs = dict(knobs)
    knobs["ingest_engine" if engine in ("u8", "swar32")
          else "inflight_engine"] = engine
    cfg = AvalancheConfig(**knobs)
    n, t = POLICY_SHAPE
    if model == "dag":
        return model, dag.init(prng.key(0, device), n,
                               torch.arange(t, dtype=torch.int32) // 2, cfg,
                               device=device), cfg
    return model, av.init(prng.key(0, device), n, t, cfg,
                          init_pref=av.contested_init_pref(0, n, t, device),
                          device=device), cfg


# The fleet's two chip points.  "atlas_hostile" is the most hostile point
# of `examples/adversary_atlas.py` at the study's defaults (snowball, 64
# nodes, 120 rounds, finalization 64, split_vote at byzantine 0.45, k 8,
# quorum 7, priors 50/50, seed 0) with the fleet cut from the study's 48
# trials to 16, to keep `chip_smoke.py` inside its time limit; "policy_grid" is one
# `run_phase_grid` of the avalanche model over the policy axis at byzantine
# 0.2, contested priors, 4 trials of 4096 x 1024, 30 rounds, finalization
# 32 (a 4096-wide window takes the ingest kernels' fast path).
FLEET_CASES = {
    "atlas_hostile": dict(
        model="snowball", grid=None,
        knobs=dict(finalization_score=64, byzantine_fraction=0.45,
                   adversary_policy="split_vote", k=8, quorum=7),
        kw=dict(fleet=16, n_nodes=64, n_rounds=120, yes_fraction=0.5,
                seed=0)),
    "policy_grid": dict(
        model="avalanche",
        grid={"adversary_policy": ["off", "split_vote",
                                   "withhold_near_quorum"]},
        knobs=dict(finalization_score=32, byzantine_fraction=0.2),
        kw=dict(fleet=4, n_nodes=4096, n_txs=1024, n_rounds=30,
                contested=True, seed=0)),
}


def dag_baseline_config(txs: int) -> AvalancheConfig:
    """The DAG baseline's config for a `txs`-wide network."""
    return AvalancheConfig(max_element_poll=max(4096, txs))


def dag_baseline_state(nodes: int, txs: int, device="cuda", **knobs
                       ) -> Tuple[dag.DagSimState, AvalancheConfig]:
    """``(state, cfg)`` of the DAG baseline on `device`; `knobs` replace
    config fields (the async lane's latency, say)."""
    cfg = dataclasses.replace(dag_baseline_config(txs), **knobs)
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


def config0_state(device="cuda") -> Tuple[av.AvalancheSimState,
                                          AvalancheConfig]:
    """``(state, cfg)`` of config 0: 100 x 100, the default config."""
    cfg = AvalancheConfig()
    return av.init(prng.key(0, device), 100, 100, cfg, device=device), cfg


def config1_state(quick: bool = False, device="cuda", **knobs
                  ) -> Tuple[snowball.SnowballState, AvalancheConfig]:
    """``(state, cfg)`` of config 1: Snowball, 1000 nodes (64 quick),
    yes_fraction 0.5; `knobs` set config fields."""
    cfg = AvalancheConfig(**knobs)
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


def config5_state(quick: bool = False, device="cuda", n_txs: int = None,
                  **knobs
                  ) -> Tuple[backlog.BacklogSimState, AvalancheConfig]:
    """``(state, cfg)`` of config 5 on `device`; `n_txs` cuts the backlog
    to its first `n_txs` scores of the same draw, `knobs` replace config
    fields."""
    n, b, w = config5_shape(quick)
    cfg = dataclasses.replace(config5_config(w), **knobs)
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
# `FAULT_STUDY_RECORDS`: the JAX package's own run of each fault study
# (`avalanche.run_scan` on the CPU, seed 0): the per-round ring and
# finality series and the final finalized fraction.  Every study path is
# integer, so the record holds on any backend; tests/test_torch_faults.py
# reproduces it from the JAX package.
FAULT_STUDY_RECORDS = {
    "measure": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
            0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 5, 1,
            2, 1, 0, 1, 0, 0, 1, 0, 2, 2, 3, 2, 5, 3, 2, 2, 3, 36, 104, 182,
            1077, 2957, 5788, 7375, 6555, 4166, 1427, 1032, 845, 369, 395, 360,
            61, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "deliveries": [
            0, 4096, 4096, 4096, 4096, 4096, 2094, 2066, 2049, 2030, 2052,
            2043, 2057, 2101, 2052, 2125, 2008, 2065, 2022, 2053, 2094, 2007,
            2074, 2072, 2030, 2088, 2003, 2035, 2016, 2085, 2064, 2090, 2070,
            2055, 2043, 2029, 2026, 1996, 2068, 2060, 2067, 2075, 2049, 2096,
            2070, 2026, 2086, 2010, 1961, 2049, 2046, 2042, 2030, 2057, 2016,
            2070, 2053, 2020, 2040, 2141, 2069, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 2002, 2030, 2047, 2066, 2044, 2053,
            2039, 1995, 2044, 1971, 2088, 2031, 2074, 2043, 2002, 2089, 2022,
            2024, 2066, 2008, 2093, 2061, 2080, 2011, 2032, 2006, 2026, 2041,
            2053, 2067, 2070, 2100, 2028, 2036, 2029, 2021, 2047, 2000, 2026,
            2070, 2010, 2086, 2135, 2047, 2050, 2054, 2066, 2039, 2080, 2026,
            2043, 2076, 2056, 1955, 2027, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "partition_blocked": [
            0, 0, 0, 0, 0, 2002, 2030, 2047, 2066, 2044, 2053, 2039, 1995,
            2044, 1971, 2088, 2031, 2074, 2043, 2002, 2089, 2022, 2024, 2066,
            2008, 2093, 2061, 2080, 2011, 2032, 2006, 2026, 2041, 2053, 2067,
            2070, 2100, 2028, 2036, 2029, 2021, 2047, 2000, 2026, 2070, 2010,
            2086, 2135, 2047, 2050, 2054, 2066, 2039, 2080, 2026, 2043, 2076,
            2056, 1955, 2027, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "ring_occupancy": [
            4096, 4096, 4096, 4096, 4096, 4096, 6098, 8128, 10175, 10239,
            10253, 10259, 10232, 10183, 10174, 10106, 10199, 10186, 10289,
            10244, 10215, 10230, 10209, 10231, 10208, 10194, 10263, 10258,
            10330, 10248, 10219, 10145, 10160, 10169, 10216, 10257, 10286,
            10333, 10294, 10260, 10189, 10182, 10193, 10164, 10169, 10192,
            10202, 10262, 10327, 10364, 10328, 10247, 10266, 10255, 10281,
            10241, 10245, 10241, 10271, 10183, 10134, 8078, 6123, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096
        ],
        "finalized_fraction": 1.0,
    },
    "cascading_outage": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 12, 212, 1489, 3488, 4799, 4484, 3370,
            2749, 2373, 1945, 1508, 1210, 1066, 889, 802, 596, 365, 352, 261,
            206, 174, 133, 84, 61, 47, 33, 26, 13, 9, 5, 3, 1, 1, 1, 0, 1, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0
        ],
        "deliveries": [
            0, 4065, 4068, 4074, 4070, 4072, 4071, 4071, 4069, 4063, 4070,
            3667, 3651, 3641, 3675, 3637, 3667, 3653, 3648, 3683, 3659, 3400,
            3389, 3387, 3363, 3412, 3369, 3372, 3388, 3395, 3320, 3665, 3643,
            3643, 3621, 3709, 3687, 3677, 3666, 3698, 3662, 4068, 4079, 4065,
            4076, 4067, 4069, 4060, 4073, 4064, 4068, 4069, 4071, 4069, 4071,
            4082, 4070, 4074, 4080, 4077, 4068, 4062, 4070, 4073, 4074, 4072,
            4071, 4074, 4061, 4064
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 401, 423, 433, 399, 436,
            403, 416, 417, 392, 422, 674, 684, 682, 708, 660, 703, 702, 685,
            672, 749, 402, 418, 418, 442, 368, 384, 386, 404, 380, 404, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0
        ],
        "partition_blocked": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 401, 423, 433, 399, 436, 403, 416,
            417, 392, 422, 674, 684, 682, 708, 660, 703, 702, 685, 672, 749,
            402, 418, 418, 442, 368, 384, 386, 404, 380, 404, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0
        ],
        "ring_occupancy": [
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4497, 4920, 5353, 5351, 5364, 5334, 5351, 5332, 5321, 5327, 5584,
            5876, 6136, 6170, 6146, 6167, 6161, 6186, 6155, 6202, 5919, 5665,
            5334, 5374, 5324, 5290, 5234, 5270, 5266, 5284, 4880, 4500, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096
        ],
        "finalized_fraction": 1.0,
    },
    "flaky_isp": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 8, 104, 963, 3056, 4678, 486, 434, 3607,
            2878, 5696, 4019, 1368, 1595, 1151, 791, 539, 380, 279, 224, 135,
            115, 105, 42, 0, 0, 23, 33, 36, 18, 2, 1, 0, 0, 0, 2, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "deliveries": [
            0, 3663, 3647, 4068, 4084, 4105, 4063, 4039, 4023, 4077, 4153,
            4024, 4048, 437, 404, 3645, 3646, 7303, 7299, 4055, 4087, 4097,
            4037, 4019, 4087, 4105, 4083, 4049, 4059, 4086, 4033, 412, 446,
            3685, 3637, 7302, 7329, 4055, 4066, 4083, 4075, 4062, 4072, 4067,
            4090, 4042, 4057, 4087, 4063, 4093, 4076, 4028, 4085, 4070, 4047,
            4084, 4079, 4047, 4117, 4093
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 429, 428, 447, 443,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 382, 424, 434, 405, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "partition_blocked": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "ring_occupancy": [
            4096, 4498, 4919, 4925, 4911, 4878, 4886, 4918, 4964, 4950, 4867,
            4911, 4937, 8596, 12288, 12717, 12716, 9031, 5324, 4901, 4895,
            4872, 4908, 4958, 4942, 4909, 4898, 4923, 4937, 4918, 4954, 8638,
            12288, 12670, 12712, 9028, 5303, 4906, 4910, 4905, 4896, 4902,
            4909, 4907, 4893, 4918, 4930, 4903, 4913, 4884, 4876, 4917, 4903,
            4902, 4926, 4924, 4915, 4942, 4905, 4889
        ],
        "finalized_fraction": 1.0,
    },
    "eclipse": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 1, 6, 99, 928, 3582, 7140, 7740, 4542, 2732,
            2008, 1627, 1181, 455, 109, 30, 10, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 77, 102, 85, 211, 91, 8, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0
        ],
        "deliveries": [
            0, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 3156, 3226, 3174, 3183, 3199, 3184,
            3167, 3191, 3176, 3192, 3197, 3189, 3192, 3220, 3188, 3195, 3156,
            3199, 3162, 3184, 3222, 3165, 3192, 3214, 3197, 3231, 3205, 3185,
            3197, 3190, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 940, 870,
            922, 913, 897, 912, 929, 905, 920, 904, 899, 907, 904, 876, 908,
            901, 940, 897, 934, 912, 874, 931, 904, 882, 899, 865, 891, 911,
            899, 906, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "partition_blocked": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 940, 870, 922, 913,
            897, 912, 929, 905, 920, 904, 899, 907, 904, 876, 908, 901, 940,
            897, 934, 912, 874, 931, 904, 882, 899, 865, 891, 911, 899, 906, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
        ],
        "ring_occupancy": [
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 5036, 5906, 6828, 6801, 6828, 6818,
            6834, 6842, 6850, 6825, 6819, 6806, 6806, 6783, 6784, 6781, 6845,
            6834, 6867, 6839, 6816, 6813, 6805, 6813, 6781, 6742, 6751, 6763,
            6797, 6812, 5901, 5002, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
            4096, 4096, 4096
        ],
        "finalized_fraction": 1.0,
    },
}


# `POLICY_RECORDS`: the JAX package's own run of each policy case on the
# CPU (`POLICY_CASES`, seed 0): per-round finalizations and votes applied
# (and expiries for the async cases), and the final finalized fraction.
# Each record is the result of
#     cfg = go_avalanche_tpu.config.AvalancheConfig(**POLICY_CASES[name][1])
#     avalanche.run_scan(avalanche.init(jax.random.key(0), 256, 64, cfg,
#                        init_pref=avalanche.contested_init_pref(0, 256, 64)),
#                        cfg, n_rounds=40)
# (the DAG case: dag.run_scan(dag.init(jax.random.key(0), 256,
# jnp.arange(64, dtype=jnp.int32) // 2, cfg), cfg, n_rounds=40)), with
# the fraction as numpy's float64 mean of `voterecord.has_finalized` over
# the final records.  Every policy path is integer, so the record holds
# on any backend; tests/test_torch_adversary_policies.py reproduces it
# from the JAX package.
POLICY_RECORDS = {
    "off": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            1, 5, 9, 8, 34, 55, 68, 110, 228, 293, 492, 569, 769, 777, 1128,
            1228, 1060, 1121
        ],
        "votes_applied": [
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131072,
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131072,
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131064,
            131024, 130952, 130888, 130616, 130176, 129632, 128752, 126928,
            124584, 120648, 116096, 109944, 103728, 94704, 84880, 76400
        ],
        "finalized_fraction": 0.48553466796875,
    },
    "split_vote": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 4, 3, 3, 6, 7, 14, 21
        ],
        "votes_applied": [
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131072,
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131072,
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131072,
            131072, 131072, 131072, 131072, 131072, 131072, 131072, 131064,
            131064, 131064, 131032, 131008, 130984, 130936, 130880, 130768
        ],
        "finalized_fraction": 0.00360107421875,
    },
    "withhold_near_quorum": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 2, 0, 11, 17, 21, 31, 47, 91, 203, 275, 340, 378, 591, 777,
            885, 941
        ],
        "votes_applied": [
            131072, 106752, 109952, 109376, 108608, 109568, 110144, 109440,
            110720, 109376, 109824, 107328, 108928, 108992, 108864, 108608,
            108800, 111488, 108224, 109952, 110912, 109504, 110336, 110720,
            110848, 109748, 109872, 109094, 111367, 108314, 110043, 109940,
            107581, 109909, 102089, 105629, 100855, 96967, 90945, 85098
        ],
        "finalized_fraction": 0.2813720703125,
    },
    "stake_eclipse": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 5, 44, 177, 380,
            839, 1225, 1532, 1866, 1764, 1618, 1398, 1175, 861, 775, 631, 462,
            389, 306, 206, 170, 109, 109, 107
        ],
        "votes_applied": [
            130496, 130304, 130368, 130432, 130752, 130944, 130624, 130432,
            130368, 130624, 130560, 130624, 130432, 130688, 130560, 130304,
            130880, 130872, 130576, 130352, 128939, 125576, 119206, 109543,
            96849, 82070, 68035, 55204, 44141, 34352, 27615, 21646, 16596,
            12592, 9799, 7163, 5512, 4414, 3607, 2671
        ],
        "finalized_fraction": 0.98565673828125,
    },
    "async_timing": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 17, 7, 9, 21
        ],
        "votes_applied": [
            35712, 61184, 73536, 84032, 88704, 124352, 118144, 121984, 124032,
            124736, 118528, 123328, 117120, 119936, 121856, 122560, 124096,
            120768, 120768, 122368, 122496, 123264, 125632, 120320, 124096,
            119360, 121280, 120960, 118720, 120192, 120704, 125440, 118016,
            125504, 120448, 125694, 118955, 124154, 118887, 122999
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 127, 145, 147, 146, 152, 154, 132, 148, 143, 157,
            138, 153, 152, 143, 137, 133, 132, 138, 157, 159, 141, 161, 143,
            137, 141, 142, 144, 155, 140, 144, 156, 144, 149, 148
        ],
        "finalized_fraction": 0.00341796875,
    },
    "async_withhold_near_quorum": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 5, 10, 13, 34, 11, 20
        ],
        "votes_applied": [
            43776, 74176, 85568, 91072, 93184, 102656, 95680, 96320, 98048,
            98880, 95104, 101248, 96064, 99968, 99776, 102272, 100480, 98304,
            97536, 99904, 99840, 99904, 103424, 97088, 101824, 98304, 99584,
            99520, 96832, 98112, 97595, 102711, 95547, 103165, 97070, 104003,
            96986, 101516, 98869, 99674
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 162, 179, 476, 555, 582, 547, 539, 543, 517, 507,
            460, 488, 503, 503, 482, 480, 488, 490, 505, 507, 487, 501, 485,
            487, 488, 486, 493, 504, 488, 512, 529, 473, 504, 458
        ],
        "finalized_fraction": 0.0057373046875,
    },
    "dag_async_split_vote": {
        "finalizations": [
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
            0, 0, 0, 0, 0, 0, 0, 0, 0, 64, 0, 64, 128, 384, 192, 320, 256, 320
        ],
        "votes_applied": [
            43776, 74304, 92096, 104704, 110848, 122176, 118464, 119744,
            120512, 121920, 116672, 119360, 116992, 120064, 120768, 122624,
            118976, 116608, 118720, 120448, 119872, 120000, 122432, 114304,
            122112, 120832, 118016, 118016, 116992, 118656, 117504, 123648,
            115136, 122048, 116992, 121536, 110784, 116544, 108608, 106368
        ],
        "expiries": [
            0, 0, 0, 0, 0, 0, 162, 177, 182, 187, 189, 187, 175, 184, 170, 190,
            171, 206, 189, 182, 172, 164, 167, 182, 203, 187, 176, 198, 169,
            178, 183, 178, 182, 198, 174, 181, 207, 181, 183, 183
        ],
        "finalized_fraction": 0.10546875,
    },
}


# `FLEET_RECORDS`: the JAX package's rows for `FLEET_CASES` on the CPU.
# With cfg = go_avalanche_tpu.config.AvalancheConfig(**case["knobs"]) for
# case = FLEET_CASES[name], "atlas_hostile" is
#     res = fleet.run_fleet("snowball", cfg, **case["kw"])
#     [{**res.summary(), "tag": obs.tag_from_config(cfg)}]
# and "policy_grid" the rows of
#     fleet.run_phase_grid("avalanche", cfg, case["grid"], **case["kw"])
# `chip_smoke.py` reproduces both on the card.
FLEET_RECORDS = {
    "atlas_hostile": [
        {
            "model": "snowball",
            "fleet": 16,
            "rounds": 120,
            "violations": 0,
            "p_violation": 0.0,
            "violation_ci": [0.0, 0.193613],
            "p_settled": 0.0,
            "settled_ci": [0.0, 0.193613],
            "stalls": 16,
            "p_stall": 1.0,
            "stall_ci": [0.806387, 1.0],
            "finality_mean": None,
            "finality_ci": None,
            "finalized_fraction_mean": 0.0,
            "tag": ", split_vote-adversary",
        },
    ],
    "policy_grid": [
        {
            "point": {
                "adversary_policy": "off",
            },
            "model": "avalanche",
            "fleet": 4,
            "rounds": 30,
            "violations": 4,
            "p_violation": 1.0,
            "violation_ci": [0.5101, 1.0],
            "p_settled": 0.0,
            "settled_ci": [0.0, 0.4899],
            "stalls": 0,
            "p_stall": 0.0,
            "stall_ci": [0.0, 0.4899],
            "finality_mean": None,
            "finality_ci": None,
            "finalized_fraction_mean": 0.950993,
            "tag": "",
        },
        {
            "point": {
                "adversary_policy": "split_vote",
            },
            "model": "avalanche",
            "fleet": 4,
            "rounds": 30,
            "violations": 4,
            "p_violation": 1.0,
            "violation_ci": [0.5101, 1.0],
            "p_settled": 0.0,
            "settled_ci": [0.0, 0.4899],
            "stalls": 0,
            "p_stall": 0.0,
            "stall_ci": [0.0, 0.4899],
            "finality_mean": None,
            "finality_ci": None,
            "finalized_fraction_mean": 0.00109,
            "tag": ", split_vote-adversary",
        },
        {
            "point": {
                "adversary_policy": "withhold_near_quorum",
            },
            "model": "avalanche",
            "fleet": 4,
            "rounds": 30,
            "violations": 0,
            "p_violation": 0.0,
            "violation_ci": [0.0, 0.4899],
            "p_settled": 0.0,
            "settled_ci": [0.0, 0.4899],
            "stalls": 0,
            "p_stall": 0.0,
            "stall_ci": [0.0, 0.4899],
            "finality_mean": None,
            "finality_ci": None,
            "finalized_fraction_mean": 0.797237,
            "tag": ", withhold_near_quorum-adversary",
        },
    ],
}


# `RECOVERY_RECORDS`: the JAX package's recovery verdict on each fault
# study, on the CPU: the study as `FAULT_STUDY_RECORDS` runs it, with
# ``trace_every=1`` and the trace plane attached for the study's rounds,
# then `go_avalanche_tpu.obs.check_recovery(cfg, final.trace)`; each
# report's `ok`, `windows` and `totals`.  tests/test_torch_obs.py and
# `chip_smoke.py` hold the port's reports to it.
RECOVERY_RECORDS = {
    "cascading_outage": {
        "ok": True,
        "windows": [
            {
                "baseline_occupancy": 4096,
                "blocked": 15067,
                "heal": 40,
                "recovery_round": 43,
                "recovery_rounds": 3,
                "start": 10
            }
        ],
        "totals": {
            "blocked_total": 15067,
            "deliveries_total": 265781,
            "expiries_total": 15067,
            "finalizations_total": 32768,
            "peak_occupancy": 6202,
            "rounds": 70,
            "strict_cut_accounting": True
        },
    },
    "eclipse": {
        "ok": True,
        "windows": [
            {
                "baseline_occupancy": 4096,
                "blocked": 27152,
                "heal": 45,
                "recovery_round": 48,
                "recovery_rounds": 3,
                "start": 15
            }
        ],
        "totals": {
            "blocked_total": 27152,
            "deliveries_total": 296432,
            "expiries_total": 27152,
            "finalizations_total": 32768,
            "peak_occupancy": 6867,
            "rounds": 80,
            "strict_cut_accounting": True
        },
    },
    "flaky_isp": {
        "ok": True,
        "windows": [],
        "totals": {
            "blocked_total": 0,
            "deliveries_total": 235974,
            "expiries_total": 3392,
            "finalizations_total": 32768,
            "peak_occupancy": 12717,
            "rounds": 60,
            "strict_cut_accounting": False
        },
    },
    "measure": {
        "ok": True,
        "windows": [
            {
                "baseline_occupancy": 4096,
                "blocked": 112385,
                "heal": 60,
                "recovery_round": 63,
                "recovery_rounds": 3,
                "start": 5
            }
        ],
        "totals": {
            "blocked_total": 112385,
            "deliveries_total": 415999,
            "expiries_total": 112385,
            "finalizations_total": 32768,
            "peak_occupancy": 10364,
            "rounds": 130,
            "strict_cut_accounting": True
        },
    },
}


# `FLEET_TRACE_RECORDS`: the JAX package's per-trial trace planes of two
# fleet points, on the CPU, each as the sha256 of its fleet-stacked JSONL
# (`trace_jsonl_digest` of `FleetResult.trace_records()`).  With
# ``trace_every=1`` added to the case's knobs: "atlas_hostile" is
#     fleet.run_fleet("snowball", cfg, **dict(case["kw"], fleet=8))
# and "policy_grid" the grid's split_vote point,
#     fleet.run_fleet("avalanche", point_config(cfg, point), **case["kw"]).
# `chip_smoke.py` holds the port's traces on the card to them.
FLEET_TRACE_RECORDS = {
    "atlas_hostile": {
        "fleet": 8, "point": None, "rows": 120,
        "sha256": ("aa025b36190088f22ce3c734efa553fb"
                   "ea0468289ee102e997e50b90db3a8b16"),
    },
    "policy_grid": {
        "fleet": 4, "point": {"adversary_policy": "split_vote"},
        "rows": 30,
        "sha256": ("01402751d959555369c1cf4d3c31a440"
                   "ecf5d02c3a49b3854d814f899fe983ac"),
    },
}


def trace_jsonl_digest(records) -> str:
    """sha256 of fleet-stacked trace records written as a `MetricsSink`
    with no tag writes them: one ``json.dumps(sort_keys=True)`` line
    each."""
    text = "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    return hashlib.sha256(text.encode()).hexdigest()


def mesh_flagship_state(nodes: int, txs: int, device="cuda", **knobs
                        ) -> Tuple[av.AvalancheSimState, AvalancheConfig]:
    """``(state, cfg)`` of the sharded drivers' case: the flagship config
    with 20% byzantine nodes (flipping every answer, so that the peer
    draws matter), seeded with ``key(0)`` on `device`; `knobs` replace
    config fields (the ingest engine)."""
    cfg = dataclasses.replace(flagship_config(txs), byzantine_fraction=0.2,
                              **knobs)
    return av.init(prng.key(0, device), nodes, txs, cfg, device=device), cfg


def leaf_digests(tree, prefix: str = "") -> Dict[str, str]:
    """sha256 of every array leaf of a numpy state tree (the layout of
    `convert.state_to_numpy` and its twins), keyed by its dotted field
    path; None leaves and int statics are skipped, a trace buffer gives
    its data and cursor.  A dict of numpy arrays (stacked telemetry)
    works too."""
    if tree is None or isinstance(tree, int):
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif hasattr(tree, "cursor"):
        items = (("data", tree.data), ("cursor", tree.cursor))
    else:
        arr = np.ascontiguousarray(np.asarray(tree))
        return {prefix: hashlib.sha256(
            f"{arr.dtype.str}{arr.shape}".encode() + arr.tobytes()
        ).hexdigest()}
    out = {}
    for name, leaf in items:
        out.update(leaf_digests(leaf, f"{prefix}.{name}" if prefix else name))
    return out


# The sharded drivers' chip cases (`chip_smoke.py` phase 13, part c).
SHARDED_CASES = {
    **{f"flagship_{a}x1": dict(model="avalanche", mesh=(a, 1), nodes=4096,
                               txs=4096, rounds=5) for a in (1, 2, 4)},
    **{f"dag_{a}x1": dict(model="dag", mesh=(a, 1), nodes=2048, txs=2048,
                          max_rounds=100) for a in (1, 2)},
}


# `SHARDED_RECORDS`: the JAX package's results for `SHARDED_CASES` on the
# CPU over 8 virtual devices (``--xla_force_host_platform_device_count=8``):
# for each case, with mesh = go_avalanche_tpu.parallel.mesh.make_mesh(
# a, b, devices=jax.devices()[:a * b]), the flagship cases run
#     cfg = AvalancheConfig(finalization_score=0x7FFE, k=8, gossip=False,
#                           max_element_poll=4096, byzantine_fraction=0.2)
#     state = avalanche.init(jax.random.key(0), nodes, txs, cfg)
#     final, tel = sharded.run_scan_sharded(
#         mesh, sharded.shard_state(state, mesh), cfg, n_rounds=rounds)
# and the DAG cases
#     cfg = AvalancheConfig(max_element_poll=4096)
#     state = dag.init(jax.random.key(0), nodes,
#                      jnp.arange(txs, dtype=jnp.int32) // 2, cfg)
#     final = sharded_dag.run_sharded_dag(
#         mesh, sharded_dag.shard_dag_state(state, mesh), cfg,
#         max_rounds=max_rounds)
# then carry `final` into the port's numpy layout
# (``convert.state_to_numpy(convert.state_from_numpy(leaves))``, the DAG's
# twins) and record `leaf_digests` of it and of the telemetry fields.
# `chip_smoke.py` reproduces every digest on the card.
SHARDED_RECORDS = {
    "flagship_1x1": {
        "rounds": 5,
        "leaves": {
            "records.votes":
                "eb179d6abbe839c3cd2222ca66b07b8e"
                "4796aa9328d2fa977cb4ab30384e4b65",
            "records.consider":
                "02f66cd7edba2012fa34d3b103b2a13e"
                "a034e11e79883c66fc7404c697ad78e0",
            "records.confidence":
                "2335641a5eab4fe5ec368e5fb3fb40a4"
                "1211a2e2e1d114d45686d9d11adfe9f2",
            "added":
                "e66c81718b6203a09f53a140230748a4"
                "e2400d61029dabe1e9f5152842c53954",
            "valid":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "score_rank":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order_inv":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "byzantine":
                "d34f8e743ed30a1584df244396d2a782"
                "a76ec57d98606fd16ddc42afcf65e9d0",
            "alive":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "latency_weight":
                "37ace4eb572c8139296e746e1403d57c"
                "134c9702a685839bdcc00f1acb36649d",
            "finalized_at":
                "a8b98be4a04781628ae94bfa54cfa896"
                "8f6a9176a16da2556a83cd6dda7e5eb6",
            "round":
                "f54e9bc2ff412fd4b7a9edeb3afdb6b2"
                "cfa139d6cb8d1c1afbabd6fa4725ec98",
            "key":
                "0074017b86fec763fe06bda0e0a1cb18"
                "fea8a43285f2e8bc284608113c9e3fb4",
        },
        "telemetry": {
            "polls":
                "fb1ad7b4e717b4711b58c16b70f30696"
                "070b19d0df1be1c49223e3098492a25a",
            "votes_applied":
                "8972c7d40aed70ce7e1652dd93731e86"
                "dfa2780bf6a7a8143abc13ce305d4fcb",
            "flips":
                "9fafa8fc9689d66d44de9f6c19e8290b"
                "86d1dd3bedf4994d9a3cf55c8c1eae6b",
            "finalizations":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "admissions":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "deliveries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "expiries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "ring_occupancy":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "partition_blocked":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "gossip_writes":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
        },
    },
    "flagship_2x1": {
        "rounds": 5,
        "leaves": {
            "records.votes":
                "0cb3eb2447eaaa12d170f4d5a6dad3e5"
                "a1effb28278b045a7889984c5cc2db30",
            "records.consider":
                "02f66cd7edba2012fa34d3b103b2a13e"
                "a034e11e79883c66fc7404c697ad78e0",
            "records.confidence":
                "75a9e1477ac8e3cd58a94a6935f41e88"
                "e8bca756196257f2b5ca61d0ffca110b",
            "added":
                "e66c81718b6203a09f53a140230748a4"
                "e2400d61029dabe1e9f5152842c53954",
            "valid":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "score_rank":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order_inv":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "byzantine":
                "d34f8e743ed30a1584df244396d2a782"
                "a76ec57d98606fd16ddc42afcf65e9d0",
            "alive":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "latency_weight":
                "37ace4eb572c8139296e746e1403d57c"
                "134c9702a685839bdcc00f1acb36649d",
            "finalized_at":
                "a8b98be4a04781628ae94bfa54cfa896"
                "8f6a9176a16da2556a83cd6dda7e5eb6",
            "round":
                "f54e9bc2ff412fd4b7a9edeb3afdb6b2"
                "cfa139d6cb8d1c1afbabd6fa4725ec98",
            "key":
                "0074017b86fec763fe06bda0e0a1cb18"
                "fea8a43285f2e8bc284608113c9e3fb4",
        },
        "telemetry": {
            "polls":
                "fb1ad7b4e717b4711b58c16b70f30696"
                "070b19d0df1be1c49223e3098492a25a",
            "votes_applied":
                "8972c7d40aed70ce7e1652dd93731e86"
                "dfa2780bf6a7a8143abc13ce305d4fcb",
            "flips":
                "eda3c5cda552610f1a532ae9a7c39017"
                "78f7b02d5d0922da5972ac05e7326445",
            "finalizations":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "admissions":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "deliveries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "expiries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "ring_occupancy":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "partition_blocked":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "gossip_writes":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
        },
    },
    "flagship_4x1": {
        "rounds": 5,
        "leaves": {
            "records.votes":
                "4ea3927dcda86ed21784e27f34e1a283"
                "264ebc332bd18ae9058aac7f02bb0e83",
            "records.consider":
                "02f66cd7edba2012fa34d3b103b2a13e"
                "a034e11e79883c66fc7404c697ad78e0",
            "records.confidence":
                "2dfd5154894939be6d17d061009222a6"
                "6c3aac17b7939bef99fb489d89ebaf82",
            "added":
                "e66c81718b6203a09f53a140230748a4"
                "e2400d61029dabe1e9f5152842c53954",
            "valid":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "score_rank":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "poll_order_inv":
                "d3cbc72b145c55e267a1f20f0f46d404"
                "d1428b3a4f25e9291db594f0c561ebcb",
            "byzantine":
                "d34f8e743ed30a1584df244396d2a782"
                "a76ec57d98606fd16ddc42afcf65e9d0",
            "alive":
                "4427f28501fba9286319abb2539b07a0"
                "573d7904b0703a9ec1a79fab391a7573",
            "latency_weight":
                "37ace4eb572c8139296e746e1403d57c"
                "134c9702a685839bdcc00f1acb36649d",
            "finalized_at":
                "a8b98be4a04781628ae94bfa54cfa896"
                "8f6a9176a16da2556a83cd6dda7e5eb6",
            "round":
                "f54e9bc2ff412fd4b7a9edeb3afdb6b2"
                "cfa139d6cb8d1c1afbabd6fa4725ec98",
            "key":
                "0074017b86fec763fe06bda0e0a1cb18"
                "fea8a43285f2e8bc284608113c9e3fb4",
        },
        "telemetry": {
            "polls":
                "fb1ad7b4e717b4711b58c16b70f30696"
                "070b19d0df1be1c49223e3098492a25a",
            "votes_applied":
                "8972c7d40aed70ce7e1652dd93731e86"
                "dfa2780bf6a7a8143abc13ce305d4fcb",
            "flips":
                "46a04ac7ca1a831815b761c638ab4ce4"
                "bbdb5beb531d243f62abf639ff8d7fb1",
            "finalizations":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "admissions":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "deliveries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "expiries":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "ring_occupancy":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "partition_blocked":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
            "gossip_writes":
                "57544fe0501b03451f39956c51e0a351"
                "c3f6a1aa748d1dfe007b783fa4968502",
        },
    },
    "dag_1x1": {
        "rounds": 17,
        "leaves": {
            "base.records.votes":
                "0c55d8617a75215474b0991cb7658c77"
                "74c81b8d0bfa3e291d855d260c889e17",
            "base.records.consider":
                "c048822e23a501e48ac522a57d9ff528"
                "b6af047266f9a45e1f836d46a60f582b",
            "base.records.confidence":
                "00abf03be9067afb852bdc9ec206f585"
                "ec5c37967234edbfb61a830f7d8f81e4",
            "base.added":
                "0f0720b1040cb9496a02d4572549491f"
                "ef41edc6094f7da266945816b4afcb8c",
            "base.valid":
                "287185b46a1cf489c485a460cdcc301a"
                "cbc624a52ada05821bc3940919ef53ed",
            "base.score_rank":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.poll_order":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.poll_order_inv":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.byzantine":
                "8a58e1b28e5f484d7047a23288b57981"
                "177ecb25f5e3694f94ec39373b00ea87",
            "base.alive":
                "287185b46a1cf489c485a460cdcc301a"
                "cbc624a52ada05821bc3940919ef53ed",
            "base.latency_weight":
                "a6d20c9e8f20560458786837ec7ffa27"
                "b0b49251ccb462b01b523aacc93f27b7",
            "base.finalized_at":
                "e51cf64a7bf1fdc8b223c83dbdedc5ac"
                "bab044deacf6a0ae9e6f0e1d234bcc31",
            "base.round":
                "51d80ee7746adfb6d78d5cab21beaa61"
                "6147f06818ed8f92c3c45f15e493b610",
            "base.key":
                "16202389cbbbc3e2e528cbf88a875519"
                "1cec1d346ef243d5861181635491e54b",
            "conflict_set":
                "a059bd6664f3063ef182c2c0f1c92ee7"
                "8d9eb436c97e714b7f5ada1d9b61963a",
        },
    },
    "dag_2x1": {
        "rounds": 17,
        "leaves": {
            "base.records.votes":
                "0c55d8617a75215474b0991cb7658c77"
                "74c81b8d0bfa3e291d855d260c889e17",
            "base.records.consider":
                "c048822e23a501e48ac522a57d9ff528"
                "b6af047266f9a45e1f836d46a60f582b",
            "base.records.confidence":
                "00abf03be9067afb852bdc9ec206f585"
                "ec5c37967234edbfb61a830f7d8f81e4",
            "base.added":
                "0f0720b1040cb9496a02d4572549491f"
                "ef41edc6094f7da266945816b4afcb8c",
            "base.valid":
                "287185b46a1cf489c485a460cdcc301a"
                "cbc624a52ada05821bc3940919ef53ed",
            "base.score_rank":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.poll_order":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.poll_order_inv":
                "45221433347b79f82c19e17345ad7e2b"
                "c47a35f46cc06580f2a53be61a4bb25b",
            "base.byzantine":
                "8a58e1b28e5f484d7047a23288b57981"
                "177ecb25f5e3694f94ec39373b00ea87",
            "base.alive":
                "287185b46a1cf489c485a460cdcc301a"
                "cbc624a52ada05821bc3940919ef53ed",
            "base.latency_weight":
                "a6d20c9e8f20560458786837ec7ffa27"
                "b0b49251ccb462b01b523aacc93f27b7",
            "base.finalized_at":
                "e51cf64a7bf1fdc8b223c83dbdedc5ac"
                "bab044deacf6a0ae9e6f0e1d234bcc31",
            "base.round":
                "51d80ee7746adfb6d78d5cab21beaa61"
                "6147f06818ed8f92c3c45f15e493b610",
            "base.key":
                "16202389cbbbc3e2e528cbf88a875519"
                "1cec1d346ef243d5861181635491e54b",
            "conflict_set":
                "a059bd6664f3063ef182c2c0f1c92ee7"
                "8d9eb436c97e714b7f5ada1d9b61963a",
        },
    },
}


# The streaming drivers' chip cases (`chip_smoke.py` phase 13, part i):
# each model at a small width, `STREAMING_SHARDED_ROUNDS` steps of its
# scan driver on meshes 1x1, 2x1 and 1x2, seeded with ``key(0)``.
STREAMING_SHARDED_MODELS = {
    "backlog": dict(nodes=512, window=256, txs=1024,
                    knobs=dict(byzantine_fraction=0.2)),
    "streaming_dag": dict(nodes=512, window_sets=128, sets=512, set_cap=2,
                          knobs=dict(byzantine_fraction=0.2)),
    "node_stream": dict(txs=256, knobs=dict(
        stake_mode="zipf", registry_nodes=4096, active_nodes=512,
        node_churn_rate=0.05, byzantine_fraction=0.2)),
}
STREAMING_SHARDED_ROUNDS = {"backlog": 30, "streaming_dag": 30,
                            "node_stream": 5}
STREAMING_SHARDED_CASES = {
    f"{model}_{a}x{b}": dict(model=model, mesh=(a, b),
                             rounds=STREAMING_SHARDED_ROUNDS[model])
    for model in STREAMING_SHARDED_MODELS for a, b in ((1, 1), (2, 1),
                                                       (1, 2))}


def streaming_sharded_state(model: str, device="cuda"):
    """``(state, cfg)`` of a `STREAMING_SHARDED_MODELS` entry on
    `device`."""
    from go_avalanche_tpu_torch.models import node_stream

    spec = STREAMING_SHARDED_MODELS[model]
    cfg = AvalancheConfig(**spec["knobs"])
    key = prng.key(0, device)
    if model == "backlog":
        queue = backlog.make_backlog(torch.arange(spec["txs"],
                                                  dtype=torch.int32))
        return backlog.init(key, spec["nodes"], spec["window"], queue, cfg,
                            device=device), cfg
    if model == "streaming_dag":
        n = spec["sets"] * spec["set_cap"]
        queue = streaming_dag.make_set_backlog(
            torch.arange(n, dtype=torch.int32).reshape(spec["sets"],
                                                       spec["set_cap"]))
        return streaming_dag.init(key, spec["nodes"], spec["window_sets"],
                                  queue, cfg, device=device), cfg
    return node_stream.init(key, spec["txs"], cfg, device=device), cfg


def numpy_tree(tel):
    """A (stacked) telemetry tree of nested NamedTuples of tensors, None
    slots kept, as nested dicts of numpy arrays (`leaf_digests`'
    input)."""
    if tel is None:
        return None
    if hasattr(tel, "_fields"):
        return {f: numpy_tree(getattr(tel, f)) for f in tel._fields}
    return tel.cpu().numpy()


def short_digests(tree) -> Dict[str, str]:
    """`leaf_digests` cut to 16 hex digits, without the node stream's
    float `resident_stake` (its float64 sum differs from the reference's
    float32 one in the last bits; ROADMAP.md Queue 3)."""
    return {k: v[:16] for k, v in leaf_digests(tree).items()
            if not k.endswith("resident_stake")}


# `STREAMING_SHARDED_RECORDS`: the JAX package's results for
# `STREAMING_SHARDED_CASES` on the CPU over 8 virtual devices: for each
# case, with mesh = go_avalanche_tpu.parallel.mesh.make_mesh(a, b,
# devices=jax.devices()[:a * b]) and the JAX package's twin of
# `streaming_sharded_state` (its `init` from ``jax.random.key(0)``, the
# same backlog scores and config), the scan driver
#     final, tel = sharded_backlog.run_scan_sharded_backlog(
#         mesh, sharded_backlog.shard_backlog_state(state, mesh), cfg,
#         n_rounds=rounds)
# (`sharded_streaming_dag.run_scan_sharded_streaming_dag`,
# `sharded_node_stream.run_scan_sharded_node_stream` for the others),
# then `final` carried into the port's numpy layout (`convert`'s
# ``*_to_numpy(*_from_numpy(leaves))``) and `short_digests` of it and of
# the stacked telemetry (nested by field).
STREAMING_SHARDED_RECORDS = {
    "backlog_1x1": {
        "leaves": {
            "sim.records.votes": "247f30eb8aa2a983",
            "sim.records.consider": "c623c888349d945b",
            "sim.records.confidence": "bdaea92cd1de9bf7",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "509268e99a84b4c2",
            "sim.poll_order": "509268e99a84b4c2",
            "sim.poll_order_inv": "509268e99a84b4c2",
            "sim.byzantine": "bb29100d3805f11c",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "acb5558ac27051d0",
            "sim.finalized_at": "28cecbacb65be723",
            "sim.round": "2f575888e01f5e58",
            "sim.key": "e7e8784880cc38a3",
            "slot_tx": "509268e99a84b4c2",
            "slot_admit_round": "cfac015c14cee3cf",
            "backlog.score": "c7d26e7f04fe6d48",
            "backlog.init_pref": "cb02dccaf1a4e48b",
            "backlog.valid": "cb02dccaf1a4e48b",
            "outputs.settled": "129bea5a03e512eb",
            "outputs.accepted": "129bea5a03e512eb",
            "outputs.accept_votes": "fe7f2a3bdee1fb6f",
            "outputs.settle_round": "9e91446cedada12b",
            "outputs.admit_round": "9e91446cedada12b",
            "next_idx": "7f8531a94e801213",
        },
        "telemetry": {
            "round.polls": "aa32b23c29b1ba06",
            "round.votes_applied": "efbb4fdf6023f964",
            "round.flips": "d5f50514515c21cd",
            "round.finalizations": "747c93ea9a044f88",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "282b700aaa37a7a1",
            "retired": "56a234aa955edaaf",
            "occupied": "190a146f02d07bfd",
            "backlog_left": "6b6494bcd044987e",
        },
    },
    "backlog_2x1": {
        "leaves": {
            "sim.records.votes": "bee409429e9eee3e",
            "sim.records.consider": "c623c888349d945b",
            "sim.records.confidence": "28511a9bafc56976",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "509268e99a84b4c2",
            "sim.poll_order": "509268e99a84b4c2",
            "sim.poll_order_inv": "509268e99a84b4c2",
            "sim.byzantine": "bb29100d3805f11c",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "acb5558ac27051d0",
            "sim.finalized_at": "5a3e0da50cfa785f",
            "sim.round": "2f575888e01f5e58",
            "sim.key": "e7e8784880cc38a3",
            "slot_tx": "509268e99a84b4c2",
            "slot_admit_round": "cfac015c14cee3cf",
            "backlog.score": "c7d26e7f04fe6d48",
            "backlog.init_pref": "cb02dccaf1a4e48b",
            "backlog.valid": "cb02dccaf1a4e48b",
            "outputs.settled": "129bea5a03e512eb",
            "outputs.accepted": "129bea5a03e512eb",
            "outputs.accept_votes": "fe7f2a3bdee1fb6f",
            "outputs.settle_round": "9e91446cedada12b",
            "outputs.admit_round": "9e91446cedada12b",
            "next_idx": "7f8531a94e801213",
        },
        "telemetry": {
            "round.polls": "faac95143e061315",
            "round.votes_applied": "7e08f79eef34d6e9",
            "round.flips": "8977a49baaa1939a",
            "round.finalizations": "97a57799afbc442c",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "e04a4a77746304f3",
            "retired": "56a234aa955edaaf",
            "occupied": "190a146f02d07bfd",
            "backlog_left": "6b6494bcd044987e",
        },
    },
    "backlog_1x2": {
        "leaves": {
            "sim.records.votes": "247f30eb8aa2a983",
            "sim.records.consider": "c623c888349d945b",
            "sim.records.confidence": "bdaea92cd1de9bf7",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "93156a07db9a8638",
            "sim.poll_order": "93156a07db9a8638",
            "sim.poll_order_inv": "93156a07db9a8638",
            "sim.byzantine": "bb29100d3805f11c",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "acb5558ac27051d0",
            "sim.finalized_at": "28cecbacb65be723",
            "sim.round": "2f575888e01f5e58",
            "sim.key": "e7e8784880cc38a3",
            "slot_tx": "509268e99a84b4c2",
            "slot_admit_round": "cfac015c14cee3cf",
            "backlog.score": "c7d26e7f04fe6d48",
            "backlog.init_pref": "cb02dccaf1a4e48b",
            "backlog.valid": "cb02dccaf1a4e48b",
            "outputs.settled": "129bea5a03e512eb",
            "outputs.accepted": "129bea5a03e512eb",
            "outputs.accept_votes": "fe7f2a3bdee1fb6f",
            "outputs.settle_round": "9e91446cedada12b",
            "outputs.admit_round": "9e91446cedada12b",
            "next_idx": "7f8531a94e801213",
        },
        "telemetry": {
            "round.polls": "aa32b23c29b1ba06",
            "round.votes_applied": "efbb4fdf6023f964",
            "round.flips": "d5f50514515c21cd",
            "round.finalizations": "747c93ea9a044f88",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "282b700aaa37a7a1",
            "retired": "56a234aa955edaaf",
            "occupied": "190a146f02d07bfd",
            "backlog_left": "6b6494bcd044987e",
        },
    },
    "streaming_dag_1x1": {
        "leaves": {
            "dag.base.records.votes": "fc5cf972719cf9db",
            "dag.base.records.consider": "c623c888349d945b",
            "dag.base.records.confidence": "05d49debb21b4c7f",
            "dag.base.added": "b3d24a31ac3b8eee",
            "dag.base.valid": "ddd4feab53353d08",
            "dag.base.score_rank": "f73940e1d6b7d4cc",
            "dag.base.poll_order": "f73940e1d6b7d4cc",
            "dag.base.poll_order_inv": "f73940e1d6b7d4cc",
            "dag.base.byzantine": "bb29100d3805f11c",
            "dag.base.alive": "bfeba188e703ab45",
            "dag.base.latency_weight": "acb5558ac27051d0",
            "dag.base.finalized_at": "28cecbacb65be723",
            "dag.base.round": "2f575888e01f5e58",
            "dag.base.key": "e7e8784880cc38a3",
            "dag.conflict_set": "753e2ea3c34c5290",
            "slot_set": "6e2afde7862b5863",
            "slot_admit_round": "c3ff5a79580a67bf",
            "backlog.score": "ff3f4c810f4150c5",
            "backlog.init_pref": "64398e1320e1ceff",
            "backlog.valid": "23ba96b6bad8a596",
            "outputs.settled": "0da1ff6c735c9f3f",
            "outputs.accepted": "0da1ff6c735c9f3f",
            "outputs.accept_votes": "659d56cec3610481",
            "outputs.settle_round": "d8611f9979b5c493",
            "outputs.admit_round": "d8611f9979b5c493",
            "next_idx": "a93bd38f7bdf975a",
        },
        "telemetry": {
            "round.polls": "aa32b23c29b1ba06",
            "round.votes_applied": "efbb4fdf6023f964",
            "round.flips": "d5f50514515c21cd",
            "round.finalizations": "747c93ea9a044f88",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "56a234aa955edaaf",
            "retired_sets": "56a234aa955edaaf",
            "occupied_sets": "c9d8516d3ad46d48",
            "backlog_left": "4defc29560e47db7",
        },
    },
    "streaming_dag_2x1": {
        "leaves": {
            "dag.base.records.votes": "476f518f987e2e40",
            "dag.base.records.consider": "c623c888349d945b",
            "dag.base.records.confidence": "f5108b18e43dce4c",
            "dag.base.added": "b3d24a31ac3b8eee",
            "dag.base.valid": "ddd4feab53353d08",
            "dag.base.score_rank": "f73940e1d6b7d4cc",
            "dag.base.poll_order": "f73940e1d6b7d4cc",
            "dag.base.poll_order_inv": "f73940e1d6b7d4cc",
            "dag.base.byzantine": "bb29100d3805f11c",
            "dag.base.alive": "bfeba188e703ab45",
            "dag.base.latency_weight": "acb5558ac27051d0",
            "dag.base.finalized_at": "5a3e0da50cfa785f",
            "dag.base.round": "2f575888e01f5e58",
            "dag.base.key": "e7e8784880cc38a3",
            "dag.conflict_set": "753e2ea3c34c5290",
            "slot_set": "6e2afde7862b5863",
            "slot_admit_round": "c3ff5a79580a67bf",
            "backlog.score": "ff3f4c810f4150c5",
            "backlog.init_pref": "64398e1320e1ceff",
            "backlog.valid": "23ba96b6bad8a596",
            "outputs.settled": "0da1ff6c735c9f3f",
            "outputs.accepted": "0da1ff6c735c9f3f",
            "outputs.accept_votes": "659d56cec3610481",
            "outputs.settle_round": "d8611f9979b5c493",
            "outputs.admit_round": "d8611f9979b5c493",
            "next_idx": "a93bd38f7bdf975a",
        },
        "telemetry": {
            "round.polls": "faac95143e061315",
            "round.votes_applied": "7e08f79eef34d6e9",
            "round.flips": "8977a49baaa1939a",
            "round.finalizations": "97a57799afbc442c",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "56a234aa955edaaf",
            "retired_sets": "56a234aa955edaaf",
            "occupied_sets": "c9d8516d3ad46d48",
            "backlog_left": "4defc29560e47db7",
        },
    },
    "streaming_dag_1x2": {
        "leaves": {
            "dag.base.records.votes": "fc5cf972719cf9db",
            "dag.base.records.consider": "c623c888349d945b",
            "dag.base.records.confidence": "05d49debb21b4c7f",
            "dag.base.added": "b3d24a31ac3b8eee",
            "dag.base.valid": "ddd4feab53353d08",
            "dag.base.score_rank": "624e01dbc8d34758",
            "dag.base.poll_order": "624e01dbc8d34758",
            "dag.base.poll_order_inv": "624e01dbc8d34758",
            "dag.base.byzantine": "bb29100d3805f11c",
            "dag.base.alive": "bfeba188e703ab45",
            "dag.base.latency_weight": "acb5558ac27051d0",
            "dag.base.finalized_at": "28cecbacb65be723",
            "dag.base.round": "2f575888e01f5e58",
            "dag.base.key": "e7e8784880cc38a3",
            "dag.conflict_set": "753e2ea3c34c5290",
            "slot_set": "6e2afde7862b5863",
            "slot_admit_round": "c3ff5a79580a67bf",
            "backlog.score": "ff3f4c810f4150c5",
            "backlog.init_pref": "64398e1320e1ceff",
            "backlog.valid": "23ba96b6bad8a596",
            "outputs.settled": "0da1ff6c735c9f3f",
            "outputs.accepted": "0da1ff6c735c9f3f",
            "outputs.accept_votes": "659d56cec3610481",
            "outputs.settle_round": "d8611f9979b5c493",
            "outputs.admit_round": "d8611f9979b5c493",
            "next_idx": "a93bd38f7bdf975a",
        },
        "telemetry": {
            "round.polls": "aa32b23c29b1ba06",
            "round.votes_applied": "efbb4fdf6023f964",
            "round.flips": "d5f50514515c21cd",
            "round.finalizations": "747c93ea9a044f88",
            "round.admissions": "56a234aa955edaaf",
            "round.deliveries": "56a234aa955edaaf",
            "round.expiries": "56a234aa955edaaf",
            "round.ring_occupancy": "56a234aa955edaaf",
            "round.partition_blocked": "56a234aa955edaaf",
            "round.gossip_writes": "56a234aa955edaaf",
            "retired_sets": "56a234aa955edaaf",
            "occupied_sets": "c9d8516d3ad46d48",
            "backlog_left": "4defc29560e47db7",
        },
    },
    "node_stream_1x1": {
        "leaves": {
            "sim.records.votes": "3894140c68f5bc33",
            "sim.records.consider": "451aadf49dfab05b",
            "sim.records.confidence": "9e9b51fad7f8e1c8",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "509268e99a84b4c2",
            "sim.poll_order": "509268e99a84b4c2",
            "sim.poll_order_inv": "509268e99a84b4c2",
            "sim.byzantine": "6de98419dbef0199",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "62f6ba914682e86d",
            "sim.finalized_at": "2a4356c95e7e1431",
            "sim.round": "f54e9bc2ff412fd4",
            "sim.key": "0074017b86fec763",
            "slot_node": "0ea026aa278dc976",
            "resident": "93a898e58db181c9",
            "stake": "4f5c47f863a13c02",
            "init_pref": "ddd4feab53353d08",
            "churn_key": "766a22efaa8b6ad5",
            "churned_in": "5771a0bf44864d57",
            "churned_out": "5771a0bf44864d57",
        },
        "telemetry": {
            "round.polls": "0f838c738e05774f",
            "round.votes_applied": "989e47558d1bf4e9",
            "round.flips": "67d19bc6e862cd4a",
            "round.finalizations": "57544fe0501b0345",
            "round.admissions": "57544fe0501b0345",
            "round.deliveries": "57544fe0501b0345",
            "round.expiries": "57544fe0501b0345",
            "round.ring_occupancy": "57544fe0501b0345",
            "round.partition_blocked": "57544fe0501b0345",
            "round.gossip_writes": "ecad52d2a234ebcb",
            "departed": "a178a42fb0fdf41b",
        },
    },
    "node_stream_2x1": {
        "leaves": {
            "sim.records.votes": "2071164c6e31a665",
            "sim.records.consider": "c1d154174dcdbf50",
            "sim.records.confidence": "fbf6545309a24ff1",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "509268e99a84b4c2",
            "sim.poll_order": "509268e99a84b4c2",
            "sim.poll_order_inv": "509268e99a84b4c2",
            "sim.byzantine": "6de98419dbef0199",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "62f6ba914682e86d",
            "sim.finalized_at": "2a4356c95e7e1431",
            "sim.round": "f54e9bc2ff412fd4",
            "sim.key": "0074017b86fec763",
            "slot_node": "0ea026aa278dc976",
            "resident": "93a898e58db181c9",
            "stake": "4f5c47f863a13c02",
            "init_pref": "ddd4feab53353d08",
            "churn_key": "766a22efaa8b6ad5",
            "churned_in": "5771a0bf44864d57",
            "churned_out": "5771a0bf44864d57",
        },
        "telemetry": {
            "round.polls": "0f838c738e05774f",
            "round.votes_applied": "e498d08ac5f1966d",
            "round.flips": "0d04cbc6bf16122b",
            "round.finalizations": "57544fe0501b0345",
            "round.admissions": "57544fe0501b0345",
            "round.deliveries": "57544fe0501b0345",
            "round.expiries": "57544fe0501b0345",
            "round.ring_occupancy": "57544fe0501b0345",
            "round.partition_blocked": "57544fe0501b0345",
            "round.gossip_writes": "d0c0688106909be3",
            "departed": "a178a42fb0fdf41b",
        },
    },
    "node_stream_1x2": {
        "leaves": {
            "sim.records.votes": "3894140c68f5bc33",
            "sim.records.consider": "451aadf49dfab05b",
            "sim.records.confidence": "9e9b51fad7f8e1c8",
            "sim.added": "b3d24a31ac3b8eee",
            "sim.valid": "ddd4feab53353d08",
            "sim.score_rank": "509268e99a84b4c2",
            "sim.poll_order": "509268e99a84b4c2",
            "sim.poll_order_inv": "509268e99a84b4c2",
            "sim.byzantine": "6de98419dbef0199",
            "sim.alive": "bfeba188e703ab45",
            "sim.latency_weight": "62f6ba914682e86d",
            "sim.finalized_at": "2a4356c95e7e1431",
            "sim.round": "f54e9bc2ff412fd4",
            "sim.key": "0074017b86fec763",
            "slot_node": "0ea026aa278dc976",
            "resident": "93a898e58db181c9",
            "stake": "4f5c47f863a13c02",
            "init_pref": "ddd4feab53353d08",
            "churn_key": "766a22efaa8b6ad5",
            "churned_in": "5771a0bf44864d57",
            "churned_out": "5771a0bf44864d57",
        },
        "telemetry": {
            "round.polls": "0f838c738e05774f",
            "round.votes_applied": "989e47558d1bf4e9",
            "round.flips": "67d19bc6e862cd4a",
            "round.finalizations": "57544fe0501b0345",
            "round.admissions": "57544fe0501b0345",
            "round.deliveries": "57544fe0501b0345",
            "round.expiries": "57544fe0501b0345",
            "round.ring_occupancy": "57544fe0501b0345",
            "round.partition_blocked": "57544fe0501b0345",
            "round.gossip_writes": "ecad52d2a234ebcb",
            "departed": "a178a42fb0fdf41b",
        },
    },
}
