"""Monte-Carlo fleet — `go_avalanche_tpu/fleet.py`.

"Quantifying Liveness and Safety of Avalanche's Snowball"
(arXiv:2409.02217) and "An Analysis of Avalanche Consensus"
(arXiv:2401.02811) give failure probabilities as functions of (k,
quorum, byzantine fraction, adversary); `run_fleet` turns one config
point into such an estimate.  It runs `fleet` independent trials, each
init from its own key, `n_rounds` of `round_step` and an outcome
reduction on the device, and reduces the per-trial vectors to Wilson
confidence intervals on the host.

The trial axis is an explicit loop.  The reference vmaps the whole sim
over its keys; the port's kernels are reached through ctypes, which
`torch.func.vmap` cannot batch, and a loop over the same per-trial keys
(``prng.split(prng.key(seed), fleet)``) gives the same bits trial for
trial, because the reference pins its vmapped fleet to stacked single
runs.

What a trial reports (`TrialOutcome`):

  * safety violation, among HONEST nodes only: snowball quorum
    divergence, an avalanche tx finalized accepted by one honest node
    and rejected by another, a DAG conflict set with two txs finalized
    accepted somewhere among honest nodes;
  * settled and the finality round (the round the last honest record
    finalized, -1 while unsettled), and the honest finalized fraction
    (float32, as the reference's compiled program computes it: the
    count over the honest count, times the float32 reciprocal of a
    static width);
  * the stall verdict (`liveness_stalled`);
  * the realized stochastic fault windows, and the backlog model's
    finality-latency percentiles with its traffic plane on.

`run_phase_grid` sweeps a validated axis grid (`phase_points`), one fleet
per cartesian point, one summary row per point tagged with the port's
copy of the reference's engine tag (`obs.tags.config_tag`).

With `cfg.trace_every > 0` every trial carries its own trace plane
(`obs/trace.py`); the trials' ``[S, M]`` buffers stack into one
``[F, S, M]`` buffer with an ``[F]`` cursor (`FleetResult.trace`,
decoded by `FleetResult.trace_records`), the reference's vmapped layout.
`cfg.metrics_every` must be 0 here, as in the reference.  Out of scope,
refused with `NotImplementedError` naming its ROADMAP.md Queue 1 item: a
trial-sharded `mesh` (item 15).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch.config import (ADVERSARY_POLICIES,
                                           AdversaryStrategy, AvalancheConfig)
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models.backlog import stack_tree
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.obs.sink import _flatten_telemetry
from go_avalanche_tpu_torch.ops import voterecord as vr

FLEET_MODELS = ("snowball", "avalanche", "dag", "backlog")


def wilson_interval(successes: int, trials: int,
                    z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion; (lo, hi).  It
    stays informative at 0 and at every trial: 0 successes gives a
    non-zero upper bound, any success a positive lower bound."""
    if trials <= 0:
        raise ValueError(f"wilson_interval needs trials >= 1, got {trials}")
    if not (0 <= successes <= trials):
        raise ValueError(f"successes {successes} outside [0, {trials}]")
    p = successes / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2 * trials)) / denom
    half = (z * math.sqrt(p * (1 - p) / trials + z2 / (4 * trials * trials))
            / denom)
    return max(0.0, center - half), min(1.0, center + half)


# --------------------------------------------------------------------------
# Safety and liveness detectors (final-state reductions on the device).


def snowball_safety_violated(state, cfg: AvalancheConfig) -> torch.Tensor:
    """Quorum divergence: two HONEST nodes finalized opposite colors."""
    fin = vr.has_finalized(state.records.confidence, cfg)
    acc = vr.is_accepted(state.records.confidence)
    honest_fin = fin & ~state.byzantine
    return (honest_fin & acc).any() & (honest_fin & ~acc).any()


def avalanche_safety_violated(state, cfg: AvalancheConfig) -> torch.Tensor:
    """Some tx finalized ACCEPTED by one honest node and REJECTED by
    another."""
    fin = vr.has_finalized(state.records.confidence, cfg)
    acc = vr.is_accepted(state.records.confidence)
    honest = ~state.byzantine[:, None]
    yes = (fin & acc & honest).any(dim=0)
    no = (fin & ~acc & honest).any(dim=0)
    return (yes & no).any()


def dag_safety_violated(state, cfg: AvalancheConfig) -> torch.Tensor:
    """Two txs of one conflict set finalized ACCEPTED somewhere among
    honest nodes (the committed double-spend; across nodes too, so the
    nodes are OR-ed before counting per set)."""
    from go_avalanche_tpu_torch.models import dag as dag_model

    base = state.base
    fin_acc = (vr.has_finalized(base.records.confidence, cfg)
               & vr.is_accepted(base.records.confidence))
    committed_t = (fin_acc & ~base.byzantine[:, None]).any(dim=0)   # [T]
    if state.set_size is not None:
        per_set = committed_t.reshape(-1, state.set_size).sum(dim=1)
    else:
        per_set = dag_model._segment(committed_t[None, :].to(torch.int32),
                                     state.conflict_set, state.n_sets,
                                     "sum")[0]
    return (per_set >= 2).any()


def liveness_stalled(finalized: torch.Tensor, byzantine: torch.Tensor,
                     alive: torch.Tensor) -> torch.Tensor:
    """The stall verdict: live honest nodes hold a majority, yet no
    honest record (any polarity) finalized.  `finalized` is ``[N]`` or
    ``[N, T]``; byzantine finalizations are not progress, and a network
    the adversary and churn overwhelmed has no liveness to violate."""
    honest = ~byzantine
    majority = (honest & alive).sum() * 2 > byzantine.shape[0]
    fin_rows = finalized if finalized.ndim == 1 else finalized.any(dim=1)
    return majority & ~(fin_rows & honest).any()


class TrialOutcome(NamedTuple):
    """One trial's reduction (device scalars)."""

    violation: torch.Tensor           # bool — safety violated at the horizon
    settled: torch.Tensor             # bool — every honest record/set final
    finality_round: torch.Tensor      # int32 — round the LAST honest
                                      #   record finalized; -1 if unsettled
    finalized_fraction: torch.Tensor  # float32 — honest records finalized
    stalled: torch.Tensor             # bool — `liveness_stalled`
    cut_start: Optional[torch.Tensor] = None   # int32 [Ec] realized
    cut_end: Optional[torch.Tensor] = None     #   stochastic cuts and
    cut_split: Optional[torch.Tensor] = None   #   their node splits
    spike_start: Optional[torch.Tensor] = None  # int32 [Es] realized
    spike_end: Optional[torch.Tensor] = None    #   stochastic spikes
    spike_extra: Optional[torch.Tensor] = None  #   and extra rounds
    lat_p50: Optional[torch.Tensor] = None   # int32 — finality-latency
    lat_p99: Optional[torch.Tensor] = None   #   percentiles (backlog
    lat_p999: Optional[torch.Tensor] = None  #   with arrivals on)
    arrived: Optional[torch.Tensor] = None   # int32 — units arrived
    region_start: Optional[torch.Tensor] = None    # int32 [Er] realized
    region_end: Optional[torch.Tensor] = None      #   regional outages and
    region_cluster: Optional[torch.Tensor] = None  #   their clusters


def _fault_realizations(fault_params) -> Dict:
    """TrialOutcome fields of the trial's realized stochastic fault
    schedule (`ops/inflight.draw_fault_params`); {} without one."""
    if fault_params is None:
        return {}
    return dict(cut_start=fault_params.cut_start,
                cut_end=fault_params.cut_end,
                cut_split=fault_params.cut_split,
                spike_start=fault_params.spike_start,
                spike_end=fault_params.spike_end,
                spike_extra=fault_params.spike_extra,
                region_start=fault_params.region_start,
                region_end=fault_params.region_end,
                region_cluster=fault_params.region_cluster)


def _fraction(count: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``count / total`` as the reference's float32 true divide of two
    int32 sums."""
    return count.to(torch.float32) / total.to(torch.float32)


def _per(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x / width`` for a static `width` as the reference's compiled
    program computes it: XLA rewrites a division by a constant into a
    product with the constant's float32 reciprocal."""
    return x * torch.reciprocal(torch.tensor(float(width),
                                             dtype=torch.float32,
                                             device=x.device))


def _finality_round(settled, stamped) -> torch.Tensor:
    return torch.where(settled, stamped.max(), -1).to(torch.int32)


def _outcome_snowball(state, cfg: AvalancheConfig) -> TrialOutcome:
    fin = vr.has_finalized(state.records.confidence, cfg)
    honest = ~state.byzantine
    settled = (fin | ~honest).all()
    stamped = torch.where(honest & fin, state.finalized_at, -1)
    return TrialOutcome(
        violation=snowball_safety_violated(state, cfg),
        settled=settled,
        finality_round=_finality_round(settled, stamped),
        finalized_fraction=_fraction((fin & honest).sum(), honest.sum()),
        stalled=liveness_stalled(fin, state.byzantine, state.alive),
        **_fault_realizations(state.fault_params))


def _outcome_avalanche(state, cfg: AvalancheConfig) -> TrialOutcome:
    fin = vr.has_finalized(state.records.confidence, cfg)
    honest = ~state.byzantine[:, None]
    settled = (fin | ~honest).all()
    stamped = torch.where(honest & fin, state.finalized_at, -1)
    return TrialOutcome(
        violation=avalanche_safety_violated(state, cfg),
        settled=settled,
        finality_round=_finality_round(settled, stamped),
        finalized_fraction=_per(_fraction((fin & honest).sum(),
                                          honest.sum()), fin.shape[1]),
        stalled=liveness_stalled(fin, state.byzantine, state.alive),
        **_fault_realizations(state.fault_params))


def _outcome_dag(state, cfg: AvalancheConfig) -> TrialOutcome:
    from go_avalanche_tpu_torch.models import dag as dag_model

    base = state.base
    fin_acc = (vr.has_finalized(base.records.confidence, cfg)
               & vr.is_accepted(base.records.confidence))
    honest = ~base.byzantine[:, None]
    if state.set_size is not None:
        resolved = dag_model.set_any_fixed(fin_acc, state.set_size)
        n_sets_f = fin_acc.shape[1] // state.set_size
    else:
        set_done = dag_model._segment(fin_acc.to(torch.uint8),
                                      state.conflict_set, state.n_sets,
                                      "amax")
        resolved = set_done[:, state.conflict_set.long()] > 0
        n_sets_f = state.n_sets
    settled = (resolved | ~honest).all()
    stamped = torch.where(honest & fin_acc, base.finalized_at, -1)
    # resolved is per (node, tx); the fraction counts (honest node, set)
    # pairs with a committed winner.
    if state.set_size is not None:
        n = resolved.shape[0]
        per_set = resolved.reshape(n, n_sets_f, state.set_size).any(dim=2)
    else:
        per_set = dag_model._segment(resolved.to(torch.uint8),
                                     state.conflict_set, state.n_sets,
                                     "amax") > 0
    honest_rows = ~base.byzantine
    return TrialOutcome(
        violation=dag_safety_violated(state, cfg),
        settled=settled,
        finality_round=_finality_round(settled, stamped),
        finalized_fraction=_per(_fraction(
            (per_set & honest_rows[:, None]).sum(), honest_rows.sum()),
            n_sets_f),
        # Finalization of either polarity is progress; a stalled DAG
        # finalizes neither.
        stalled=liveness_stalled(
            vr.has_finalized(base.records.confidence, cfg),
            base.byzantine, base.alive),
        **_fault_realizations(base.fault_params))


def _outcome_backlog(state, cfg: AvalancheConfig) -> TrialOutcome:
    """Did the whole backlog drain within the horizon, when did the last
    tx settle, and, with the traffic plane on, its finality-latency
    percentiles.  Safety is the avalanche detector on the live window."""
    from go_avalanche_tpu_torch import traffic as tf

    out = state.outputs
    settled = out.settled.all()
    lat = {}
    if state.traffic is not None:
        (p50n, p50d), (p99n, p99d), (p999n, p999d) = tf.PERCENTILES
        hist = state.traffic.lat_hist
        lat = dict(lat_p50=tf.percentile_from_hist(hist, p50n, p50d),
                   lat_p99=tf.percentile_from_hist(hist, p99n, p99d),
                   lat_p999=tf.percentile_from_hist(hist, p999n, p999d),
                   arrived=state.traffic.arrived_idx)
    return TrialOutcome(
        violation=avalanche_safety_violated(state.sim, cfg),
        settled=settled,
        finality_round=_finality_round(settled, out.settle_round),
        finalized_fraction=_per(out.settled.to(torch.float32).sum(),
                                out.settled.shape[0]),
        # A harvested settled tx is progress even after its slot
        # recycled, so the stream-level stall gates on both planes.
        stalled=(liveness_stalled(
            vr.has_finalized(state.sim.records.confidence, cfg),
            state.sim.byzantine, state.sim.alive)
            & ~out.settled.any()),
        **_fault_realizations(state.sim.fault_params),
        **lat)


# --------------------------------------------------------------------------
# The trial: init -> n_rounds of round_step -> outcome, on the device.


def _trial_fn(model: str, cfg: AvalancheConfig, n_nodes: int, n_txs: int,
              n_rounds: int, conflict_size: int, yes_fraction: float,
              contested: bool, window: int, device: torch.device):
    """``key -> (TrialOutcome, telemetry [R], trace [S, M] | None)``: one
    trial's init from its key (with its trace plane when
    `cfg.trace_every > 0`), `n_rounds` rounds and the outcome reduction,
    all on `device`."""

    def trial(key):
        if model == "snowball":
            from go_avalanche_tpu_torch.models import snowball as sb

            state = sb.with_trace(
                sb.init(key, n_nodes, cfg, yes_fraction=yes_fraction,
                        device=device), cfg, n_rounds)
            step, outcome = sb.round_step, _outcome_snowball
            trace_of = lambda s: s.trace                    # noqa: E731
        elif model == "avalanche":
            init_pref = (av.contested_init_pref_from_key(key, n_nodes, n_txs)
                         if contested else None)
            state = av.with_trace(
                av.init(key, n_nodes, n_txs, cfg, init_pref=init_pref,
                        device=device), cfg, n_rounds)
            step, outcome = av.round_step, _outcome_avalanche
            trace_of = lambda s: s.trace                    # noqa: E731
        elif model == "backlog":
            from go_avalanche_tpu_torch.models import backlog as bl

            # The backlog (arrival order) is shared across trials; only
            # the sim and traffic key vary.  A final harvest records the
            # last window's outcomes, as `bl.run` does.
            state = bl.with_trace(bl.init(key, n_nodes, window,
                                          bl.make_backlog(torch.arange(
                                              n_txs, dtype=torch.int32,
                                              device=device)),
                                          cfg, device=device),
                                  cfg, n_rounds)
            step = bl.step

            def outcome(final, c):
                final, _ = bl._retire_and_refill(final, c, refill=False)
                return _outcome_backlog(final, c)
            trace_of = lambda s: s.sim.trace                # noqa: E731
        else:
            from go_avalanche_tpu_torch.models import dag as dag_model

            state = dag_model.with_trace(dag_model.init(
                key, n_nodes,
                torch.arange(n_txs, dtype=torch.int32,
                             device=device) // conflict_size,
                cfg, n_sets=n_txs // conflict_size, set_size=conflict_size,
                device=device), cfg, n_rounds)
            step, outcome = dag_model.round_step, _outcome_dag
            trace_of = lambda s: s.base.trace               # noqa: E731
        rows = []
        for _ in range(n_rounds):
            state, tel = step(state, cfg)
            rows.append(tel)
        return outcome(state, cfg), stack_tree(rows), trace_of(state)

    return trial


@dataclasses.dataclass
class FleetResult:
    """Host-side reduction of one fleet: per-trial vectors plus the
    Wilson-CI estimates a phase diagram plots."""

    model: str
    fleet: int
    rounds: int
    violations: np.ndarray          # bool [F]
    settled: np.ndarray             # bool [F]
    finality_round: np.ndarray      # int32 [F]; -1 where unsettled
    finalized_fraction: np.ndarray  # float32 [F]
    stalled: np.ndarray             # bool [F] — liveness_stalled verdicts
    telemetry: object               # stacked telemetry tree, numpy [F, R]
    cut_windows: Optional[np.ndarray]  # int32 [F, Ec, 2] realized
                                    #   stochastic [start, end) windows
    cut_split: Optional[np.ndarray] = None  # int32 [F, Ec]
    spike_windows: Optional[np.ndarray] = None   # int32 [F, Es, 3]
                                    #   (start, end, extra)
    region_windows: Optional[np.ndarray] = None  # int32 [F, Er, 3]
                                    #   (start, end, cluster)
    lat_percentiles: Optional[np.ndarray] = None  # int32 [F, 3]
                                    #   (p50, p99, p999), backlog traffic
    arrived: Optional[np.ndarray] = None  # int32 [F] units arrived
    trace: Optional[obs_trace.TraceBuffer] = None  # [F, S, M] per-trial
                                    #   trace plane on the host, with
                                    #   cfg.trace_every > 0; else None
    p_violation: float = 0.0
    violation_ci: Tuple[float, float] = (0.0, 0.0)
    p_settled: float = 0.0
    settled_ci: Tuple[float, float] = (0.0, 0.0)
    p_stall: float = 0.0
    stall_ci: Tuple[float, float] = (0.0, 0.0)
    finality_mean: Optional[float] = None   # over settled trials
    finality_ci: Optional[Tuple[float, float]] = None

    def summary(self) -> Dict:
        """The phase-diagram row body, the reference's keys and
        rounding."""
        row = {
            "model": self.model,
            "fleet": self.fleet,
            "rounds": self.rounds,
            "violations": int(self.violations.sum()),
            "p_violation": round(self.p_violation, 6),
            "violation_ci": [round(x, 6) for x in self.violation_ci],
            "p_settled": round(self.p_settled, 6),
            "settled_ci": [round(x, 6) for x in self.settled_ci],
            "stalls": int(self.stalled.sum()),
            "p_stall": round(self.p_stall, 6),
            "stall_ci": [round(x, 6) for x in self.stall_ci],
            "finality_mean": (None if self.finality_mean is None
                              else round(self.finality_mean, 3)),
            "finality_ci": (None if self.finality_ci is None else
                            [round(x, 3) for x in self.finality_ci]),
            "finalized_fraction_mean": round(
                float(self.finalized_fraction.mean()), 6),
        }
        if self.lat_percentiles is not None:
            # Trials that settled nothing carry the -1 empty-histogram
            # sentinel and stay out of the latency reduction; lat_trials
            # says how many counted.
            lp = self.lat_percentiles
            valid = lp[:, 0] >= 0
            row["lat_trials"] = int(valid.sum())
            if valid.any():
                lv = lp[valid]
                row.update({
                    "lat_p50_mean": round(float(lv[:, 0].mean()), 3),
                    "lat_p99_mean": round(float(lv[:, 1].mean()), 3),
                    "lat_p999_mean": round(float(lv[:, 2].mean()), 3),
                    "lat_p99_max": int(lv[:, 1].max()),
                })
            else:
                row.update({"lat_p50_mean": None, "lat_p99_mean": None,
                            "lat_p999_mean": None, "lat_p99_max": None})
            row["arrived_mean"] = round(float(self.arrived.mean()), 3)
        return row

    def trace_records(self) -> List[Dict]:
        """The fleet's per-trial trace plane decoded to fleet-stacked
        records (per-round dicts whose counters are per-trial lists, the
        format `obs.check_recovery` gives per-trial verdicts on), ordered
        by round."""
        if self.trace is None:
            raise ValueError(
                "this fleet ran without the trace plane — set "
                "cfg.trace_every > 0 to capture per-trial round-by-"
                "round traces (obs/trace.py)")
        return obs_trace.fleet_trace_records(self.trace)

    def realizations(self) -> Dict:
        """JSON-ready per-trial stochastic fault realizations: ``{"cut":
        [[[start, end, split], ...] per trial], "spike": [...],
        "region": [...]}``; {} when the script schedules none."""
        out: Dict = {}
        if self.cut_windows is not None and self.cut_windows.shape[1]:
            cuts = np.concatenate(
                [self.cut_windows, self.cut_split[:, :, None]], axis=2)
            out["cut"] = cuts.astype(int).tolist()
        if self.spike_windows is not None and self.spike_windows.shape[1]:
            out["spike"] = self.spike_windows.astype(int).tolist()
        if (self.region_windows is not None
                and self.region_windows.shape[1]):
            out["region"] = self.region_windows.astype(int).tolist()
        return out


def _host(outcomes: List[TrialOutcome], name: str) -> Optional[np.ndarray]:
    """The per-trial field `name` stacked to ``[F, ...]`` on the host;
    None when the trials do not carry it."""
    leaves = [getattr(o, name) for o in outcomes]
    if leaves[0] is None:
        return None
    return torch.stack(leaves).cpu().numpy()


def run_fleet(
    model: str,
    cfg: AvalancheConfig,
    fleet: int,
    n_nodes: int,
    n_txs: int = 64,
    n_rounds: int = 100,
    seed: int = 0,
    conflict_size: int = 2,
    yes_fraction: float = 0.5,
    contested: bool = True,
    window: int = 64,
    mesh=None,
    device="cuda",
) -> FleetResult:
    """Run `fleet` independent trials of one config point on `device`
    (the card unless the caller asks for the CPU) and reduce them to
    Wilson-CI estimates.

    Trial i's key is ``prng.split(prng.key(seed), fleet)[i]``, so a
    trial is deterministic in (config, seed, fleet) and equals the
    reference's trial i.  `contested` (avalanche only) draws per-node
    50/50 priors from each trial's key; `yes_fraction` is the snowball
    prior; `window` (backlog only) is the working-set slot count."""
    if model not in FLEET_MODELS:
        raise ValueError(f"fleet models are {', '.join(FLEET_MODELS)}, "
                         f"got {model!r}")
    if cfg.arrivals_enabled() and model != "backlog":
        raise ValueError(
            f"the live-traffic arrival plane only threads through the "
            f"backlog fleet model; with model {model!r} the arrival "
            f"config is inert and every trial would be mislabeled "
            f"'{cfg.arrival_mode}-arrival'")
    if cfg.arrival_mode == "external":
        raise ValueError(
            "arrival_mode 'external' has no push path inside the "
            "vmapped fleet program (arrivals come only from "
            "traffic.push_arrivals) — every trial would run an empty "
            "stream and report nothing settled; use a schedule mode "
            "for fleet offered-load sweeps")
    if fleet < 1:
        raise ValueError(f"fleet must be >= 1, got {fleet}")
    if cfg.stake_mode != "off" and model == "snowball":
        raise ValueError(
            "the snowball model samples peers uniformly (no "
            "latency_weight plane), so a stake config is inert there "
            "and every trial would be mislabeled "
            f"'{cfg.stake_mode}-stake' — use the avalanche/dag/backlog "
            "models for stake-weighted committee fleets")
    if cfg.registry_nodes > 0:
        raise ValueError(
            "the node registry (cfg.registry_nodes) is the node-stream "
            "scheduler's axis (models/node_stream), which no fleet "
            "model runs — av.init deliberately skips the stake fold "
            "under the registry, so every trial would draw UNIFORM "
            f"peers while tagged 'registry{cfg.registry_nodes}/"
            f"{cfg.active_nodes}'; a fleet node_stream model is the "
            "open ROADMAP follow-up (million-node axis, next steps)")
    if cfg.metrics_every > 0:
        raise ValueError(
            "the in-graph metrics tap (cfg.metrics_every > 0) cannot "
            "run under the fleet vmap — an io_callback has no per-trial "
            "identity there; phase rows stream host-side through the "
            "obs sink instead")
    if model == "dag" and n_txs % conflict_size:
        raise ValueError(f"n_txs ({n_txs}) must divide by conflict_size "
                         f"({conflict_size})")
    if mesh is not None:
        raise NotImplementedError(
            "run_fleet(mesh=...): the trial-sharded fleet is not ported "
            "yet (ROADMAP.md Queue 1, item 15, the sharded fleet); "
            "leave mesh at None")
    dev = av._device(device)
    keys = prng.split(prng.key(seed, dev), fleet)
    trial = _trial_fn(model, cfg, int(n_nodes), int(n_txs), int(n_rounds),
                      int(conflict_size), float(yes_fraction),
                      bool(contested), int(window), dev)
    outcomes, tels, traces = [], [], []
    for i in range(fleet):
        outcome, tel, trace = trial(keys[i])
        outcomes.append(outcome)
        tels.append(tel)
        traces.append(trace)
    violations = _host(outcomes, "violation")
    settled = _host(outcomes, "settled")
    stalled = _host(outcomes, "stalled")
    finality = _host(outcomes, "finality_round")
    frac = _host(outcomes, "finalized_fraction")
    cut_windows = cut_split = spike_windows = region_windows = None
    if outcomes[0].cut_start is not None:
        cut_windows = np.stack([_host(outcomes, "cut_start"),
                                _host(outcomes, "cut_end")], axis=-1)
        cut_split = _host(outcomes, "cut_split")
        spike_windows = np.stack([_host(outcomes, "spike_start"),
                                  _host(outcomes, "spike_end"),
                                  _host(outcomes, "spike_extra")], axis=-1)
        region_windows = np.stack([_host(outcomes, "region_start"),
                                   _host(outcomes, "region_end"),
                                   _host(outcomes, "region_cluster")],
                                  axis=-1)
    lat_percentiles = arrived = None
    if outcomes[0].lat_p50 is not None:
        lat_percentiles = np.stack([_host(outcomes, "lat_p50"),
                                    _host(outcomes, "lat_p99"),
                                    _host(outcomes, "lat_p999")], axis=-1)
        arrived = _host(outcomes, "arrived")

    res = FleetResult(
        model=model, fleet=fleet, rounds=n_rounds,
        violations=violations, settled=settled, finality_round=finality,
        finalized_fraction=frac, stalled=stalled,
        telemetry=convert._np_tree(stack_tree(tels)),
        cut_windows=cut_windows, cut_split=cut_split,
        spike_windows=spike_windows, region_windows=region_windows,
        lat_percentiles=lat_percentiles, arrived=arrived,
        trace=(None if traces[0] is None else obs_trace.to_host(
            obs_trace.stack_fleet(traces))),
        p_violation=float(violations.mean()),
        violation_ci=wilson_interval(int(violations.sum()), fleet),
        p_settled=float(settled.mean()),
        settled_ci=wilson_interval(int(settled.sum()), fleet),
        p_stall=float(stalled.mean()),
        stall_ci=wilson_interval(int(stalled.sum()), fleet),
    )
    if settled.any():
        fr = finality[settled].astype(np.float64)
        res.finality_mean = float(fr.mean())
        half = (float(1.96 * fr.std(ddof=1) / math.sqrt(fr.size))
                if fr.size > 1 else 0.0)
        res.finality_ci = (res.finality_mean - half,
                           res.finality_mean + half)
    return res


def fleet_trace_records(telemetry, fleet: int) -> List[Dict]:
    """A fleet's stacked telemetry (numpy ``[F, R]`` leaves, as
    `FleetResult.telemetry` holds them) as fleet-stacked trace records:
    one dict per round whose counter values are per-trial lists."""
    flat = _flatten_telemetry(convert._np_tree(telemetry), {})
    n_rounds = int(next(iter(flat.values())).shape[1])
    return [{"round": r,
             **{k: [int(v[i, r]) for i in range(fleet)]
                for k, v in flat.items()}}
            for r in range(n_rounds)]


# --------------------------------------------------------------------------
# Phase grids: one fleet per cartesian point of config axes.

# Axis name -> coercion: the papers' (k, quorum, byzantine fraction,
# adversary) axes plus the fault / latency / load / stake knobs.
_GRID_AXES = {
    "k": int,
    "quorum": int,
    "window": int,
    "alpha": float,
    "finalization_score": int,
    "byzantine_fraction": float,
    "flip_probability": float,
    "drop_probability": float,
    "churn_probability": float,
    "latency_rounds": int,
    "adversary_strategy": str,
    "adversary_policy": str,
    "arrival_rate": float,
    "stake_zipf_s": float,
}


def phase_points(grid: Dict) -> List[Dict]:
    """Validate a phase-grid spec ``{axis: [value, ...], ...}`` and
    expand it to the cartesian list of config-override points; entries
    are numeric, strings only for `adversary_strategy` and
    `adversary_policy`.  Raises `ValueError` naming the axis and index."""
    if not isinstance(grid, dict) or not grid:
        raise ValueError("a phase grid is a non-empty JSON object "
                         "{axis: [values...]}")
    axes, levels = [], []
    for axis, values in grid.items():
        if axis not in _GRID_AXES:
            raise ValueError(
                f"unknown phase-grid axis {axis!r}; sweepable axes: "
                f"{', '.join(sorted(_GRID_AXES))}")
        if not isinstance(values, (list, tuple)) or not values:
            raise ValueError(
                f"phase-grid axis {axis!r} needs a non-empty list of "
                f"values, got {values!r}")
        coerce = _GRID_AXES[axis]
        coerced = []
        for i, v in enumerate(values):
            if coerce is str:
                if not isinstance(v, str):
                    raise ValueError(
                        f"phase-grid {axis}[{i}] must be a "
                        f"{'policy' if axis == 'adversary_policy' else 'strategy'}"
                        f" name, got {v!r}")
                if axis == "adversary_policy":
                    if v not in ADVERSARY_POLICIES:
                        raise ValueError(
                            f"phase-grid {axis}[{i}]: unknown adversary "
                            f"policy {v!r}; policies: "
                            f"{', '.join(ADVERSARY_POLICIES)}")
                    coerced.append(v)
                else:
                    coerced.append(AdversaryStrategy(v).value)
            else:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"phase-grid {axis}[{i}] must be numeric, "
                        f"got {v!r}")
                if coerce is int and int(v) != v:
                    # A truncated 8.5 would measure and label the k=8
                    # point: rejected, not rounded.
                    raise ValueError(
                        f"phase-grid {axis}[{i}] must be an integer, "
                        f"got {v!r}")
                coerced.append(coerce(v))
        axes.append(axis)
        levels.append(coerced)
    return [dict(zip(axes, combo))
            for combo in itertools.product(*levels)]


def check_adversary_grid(grid: Dict, *, byz_base: float,
                         strategy_base: str, flip_base: float,
                         policy_base: str, async_base: bool,
                         stake_base: str = "off",
                         margin_base: int = 1) -> None:
    """The grid-level refusals of inert adversary combinations, before
    the first point runs: a cartesian product combines every value of
    one axis with every value of the others, so a combination that some
    point's config would reject is refused upfront."""
    byz = grid.get("byzantine_fraction", [byz_base])
    policies = grid.get("adversary_policy", [policy_base])
    strategies = grid.get("adversary_strategy", [strategy_base])
    flips = grid.get("flip_probability", [flip_base])
    knobs = []
    if any(p != "off" for p in policies):
        knobs.append("adversary_policy")
    if any(st != AdversaryStrategy.FLIP.value for st in strategies):
        knobs.append("adversary_strategy")
    if any(f != 1.0 for f in flips):
        knobs.append("flip_probability")
    if knobs and any(b == 0.0 for b in byz):
        raise ValueError(
            f"the grid combines byzantine_fraction == 0 points with "
            f"{'/'.join(knobs)} set: with no byzantine nodes every "
            f"adversary knob is inert, so those points would reject at "
            f"construction — sweep byzantine_fraction over non-zero "
            f"values (the 2409.02217 phase boundary starts above 0), "
            f"or drop the adversary axes")
    if any(p == "timing" for p in policies) and not async_base:
        raise ValueError(
            "an adversary_policy 'timing' point needs the base "
            "config's async engine (a latency_mode or a scheduled "
            "cut/spike): the policy delays lies through the in-flight "
            "latency plane, which no phase axis can turn on")
    if any(p == "stake_eclipse" for p in policies) and stake_base == "off":
        raise ValueError(
            "an adversary_policy 'stake_eclipse' point needs the base "
            "config's stake_mode set (the eclipse set derives from the "
            "stake plane, which no phase axis can turn on)")
    if (margin_base != 1
            and any(p != "withhold_near_quorum" for p in policies)):
        raise ValueError(
            "the base config's adversary_margin is non-default but the "
            "grid includes adversary_policy points other than "
            "'withhold_near_quorum' — those points would reject the "
            "margin as inert at construction")
    if (any(p == "split_vote" for p in policies)
            and any(st != AdversaryStrategy.FLIP.value
                    for st in strategies)):
        raise ValueError(
            "the grid combines adversary_policy 'split_vote' points "
            "with a non-default adversary_strategy: split_vote "
            "OVERRIDES the lie content, so those points would reject "
            "the strategy as silently ignored at construction")


def point_config(base_cfg: AvalancheConfig, point: Dict) -> AvalancheConfig:
    """`base_cfg` with one phase point's overrides applied (validated by
    the config's own `__post_init__`)."""
    overrides = dict(point)
    if "adversary_strategy" in overrides:
        overrides["adversary_strategy"] = AdversaryStrategy(
            overrides["adversary_strategy"])
    return dataclasses.replace(base_cfg, **overrides)


def run_phase_grid(
    model: str,
    base_cfg: AvalancheConfig,
    grid: Dict,
    fleet: int,
    n_nodes: int,
    n_txs: int = 64,
    n_rounds: int = 100,
    seed: int = 0,
    conflict_size: int = 2,
    yes_fraction: float = 0.5,
    contested: bool = True,
    window: int = 64,
    sink=None,
    mesh=None,
    device="cuda",
) -> List[Dict]:
    """Sweep a phase grid: one `run_fleet` per cartesian point on
    `device`, returning one summary row per point (its `point`, the
    fleet estimates, the realized stochastic fault schedules when there
    are any, and the point config's tag) and handing each row to
    `sink.write` as it lands, when a sink is given."""
    from go_avalanche_tpu_torch.obs.tags import config_tag

    points = phase_points(grid)
    if (base_cfg.latency_mode == "none"
            and any("latency_rounds" in p for p in points)):
        raise ValueError(
            "a latency_rounds phase axis needs the base config's "
            "latency_mode set (it is 'none', under which the knob is "
            "inert — every point would measure the same program)")
    if any("arrival_rate" in p for p in points):
        if not base_cfg.arrivals_enabled():
            raise ValueError(
                "an arrival_rate phase axis needs the base config's "
                "arrival_mode set (it is 'off', under which the knob is "
                "inert — offered-load sweeps need a live-traffic "
                "schedule)")
        if model != "backlog":
            raise ValueError(
                f"an arrival_rate phase axis needs the backlog fleet "
                f"model (the traffic plane is not threaded through "
                f"{model!r} — every point would measure the same "
                f"program)")
    check_adversary_grid(
        grid, byz_base=base_cfg.byzantine_fraction,
        strategy_base=base_cfg.adversary_strategy.value,
        flip_base=base_cfg.flip_probability,
        policy_base=base_cfg.adversary_policy,
        async_base=base_cfg.async_queries(),
        stake_base=base_cfg.stake_mode,
        margin_base=base_cfg.adversary_margin)
    if (base_cfg.stake_mode != "zipf"
            and any("stake_zipf_s" in p for p in points)):
        raise ValueError(
            "a stake_zipf_s phase axis needs the base config's "
            "stake_mode set to 'zipf' (the exponent is only read "
            "there — every point would otherwise reject or measure "
            "the same program)")
    rows = []
    for point in points:
        cfg = point_config(base_cfg, point)
        # The reference guards each point against recompiling its
        # fleet program more than once; the port compiles nothing per
        # point, so there is nothing to guard here.
        res = run_fleet(model, cfg, fleet, n_nodes, n_txs=n_txs,
                        n_rounds=n_rounds, seed=seed,
                        conflict_size=conflict_size,
                        yes_fraction=yes_fraction, contested=contested,
                        window=window, mesh=mesh, device=device)
        row = {"point": point, **res.summary(), "tag": config_tag(cfg)}
        realized = res.realizations()
        if realized:
            row["realizations"] = realized
        rows.append(row)
        if sink is not None:
            sink.write(row)
    return rows
