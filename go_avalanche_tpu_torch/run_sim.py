"""Sweepable simulation runner CLI — the port's `go_avalanche_tpu/run_sim.py`.

Every protocol constant and fault knob of `AvalancheConfig` is a flag,
any model family can be selected, and results are emitted as JSON for
sweep harnesses; the flags, defaults, refusals and the result dict are
the reference's, key for key.  The port adds one flag, ``--device``
(``cuda``, the default, or ``cpu``), and reports the torch device type
as ``backend``; ``--trace DIR`` writes a `torch.profiler` trace there.

    python -m go_avalanche_tpu_torch.run_sim --model avalanche --nodes 1024 \\
        --txs 256 --byzantine 0.1 --json
    python -m go_avalanche_tpu_torch.run_sim --model dag --txs 64 \\
        --conflict-size 4 --device cpu

Models: `slush` / `snowflake` — the paper's simpler family members
(models/family); `snowball` — [nodes] single-decree with the reference's
windowed record; `avalanche` — [nodes, txs] multi-target with gossip;
`dag` — conflict-set double-spend resolution; `backlog` — `--txs` pending
txs streamed through a `--slots` working-set window; `streaming_dag` —
`--txs` pending txs in `--conflict-size` conflict sets streamed through a
`--slots`-set window; `node_stream` — a `--registry-nodes` population
streamed through an `--active-nodes` window.

``--mesh A,B`` runs the sharded drivers (`parallel/`) for `avalanche`,
`dag`, `backlog`, `streaming_dag` and `node_stream` over A*B ranks, and
with ``--fleet`` lays the trial axis over them; start the ranks with
``torchrun --nproc-per-node A*B -m go_avalanche_tpu_torch.run_sim ...``
(``--backend gloo`` when they share one card).  ``--mesh 1,1`` runs in
one process.  Only rank 0 prints the result and writes the sinks.
``--report-memory`` prints the run's memory ledger and analytic
footprint (`obs/resources.py`) to stderr before the run.  ``--audit``
runs one round of the run's program under the contract audit
(`analysis/audit.py`) first and exits 1 on a failure; ``--fleet-shape
auto`` picks or validates ``--fleet`` against the device's knee table
(`obs/knee.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import (
    ADVERSARY_POLICIES,
    AdversaryStrategy,
    AvalancheConfig,
    VoteMode,
    fault_script_from_json,
)
from go_avalanche_tpu_torch.models.avalanche import _device
from go_avalanche_tpu_torch.utils import metrics, tracing

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _parse_rtt_matrix(spec: str):
    """`--rtt-matrix` SPEC -> tuple-of-tuples: inline ``'1,3;3,1'`` rows
    or a path to a JSON file holding a list of lists.  Structural errors
    raise `ValueError` (funnelled into `parser.error`); squareness /
    topology-match / entry-range checks live in `AvalancheConfig`."""
    if os.path.exists(spec) or spec.endswith(".json"):
        with open(spec) as fh:
            data = json.load(fh)
        if (not isinstance(data, list)
                or not all(isinstance(r, list) for r in data)):
            raise ValueError(
                f"{spec} must hold a JSON list of lists (one row per "
                f"querier cluster)")
        if not all(isinstance(x, (int, float))
                   for row in data for x in row):
            raise ValueError(
                f"{spec}: matrix entries must be numbers (latencies "
                f"in rounds)")
        return tuple(map(tuple, data))
    try:
        return tuple(tuple(int(x) for x in row.split(","))
                     for row in spec.split(";"))
    except ValueError:
        raise ValueError(
            f"inline matrix rows are ';'-separated integer lists "
            f"(e.g. '1,3;3,1'), got {spec!r}")


def _async_on(args: argparse.Namespace) -> bool:
    """Will this flag set turn the in-flight engine on?  The one
    parser-level spelling of `cfg.async_queries()`'s derivation, shared
    by `build_config` and the `--phase-grid` adversary check."""
    script = getattr(args, "fault_script_events", None)
    return (args.latency_mode != "none" or args.partition is not None
            or any(e and e[0] != "churn_burst" for e in script or ()))


def build_config(args: argparse.Namespace) -> AvalancheConfig:
    """The config the parsed flags select.  `--timeout-rounds R` maps to
    ``(time_step_s=1.0, request_timeout_s=R-1)`` when the async engine is
    on, so ``cfg.timeout_rounds() == R``; the seconds fields stay at the
    reference defaults otherwise."""
    script = getattr(args, "fault_script_events", None)
    timing = {}
    if _async_on(args):
        if args.timeout_rounds < 1:
            raise SystemExit("--timeout-rounds must be >= 1 (a query "
                             "needs at least one round to be answerable)")
        timing = dict(time_step_s=1.0,
                      request_timeout_s=float(args.timeout_rounds - 1))
    partition = None
    if args.partition is not None:
        try:
            start_s, end_s, frac_s = args.partition.split(",")
            partition = (int(start_s), int(end_s), float(frac_s))
        except ValueError:
            raise SystemExit(f"--partition must be START,END,FRAC "
                             f"(e.g. 50,150,0.5), got {args.partition!r}")
    return AvalancheConfig(
        finalization_score=args.finalization_score,
        max_element_poll=args.max_element_poll,
        arrival_mode=getattr(args, "arrival_mode", "off"),
        arrival_rate=getattr(args, "arrival_rate", 0.0),
        arrival_period=getattr(args, "arrival_period", 0),
        arrival_burst_factor=getattr(args, "arrival_burst_factor", 1.0),
        arrival_duty=getattr(args, "arrival_duty", 0.5),
        arrival_depth=getattr(args, "arrival_depth", 0.0),
        arrival_backpressure=getattr(args, "arrival_backpressure_parsed",
                                     None),
        latency_mode=args.latency_mode,
        latency_rounds=args.latency_rounds,
        partition_spec=partition,
        fault_script=script,
        rtt_matrix=getattr(args, "rtt_matrix_parsed", None),
        **timing,
        window=args.window,
        quorum=args.quorum,
        k=args.k,
        alpha=args.alpha,
        vote_mode=VoteMode(args.vote_mode),
        gossip=not args.no_gossip,
        weighted_sampling=args.weighted,
        sample_with_replacement=not args.distinct_peers,
        n_clusters=args.clusters,
        cluster_locality=args.cluster_locality,
        byzantine_fraction=args.byzantine,
        flip_probability=args.flip_probability,
        adversary_strategy=AdversaryStrategy(args.adversary),
        adversary_policy=getattr(args, "adversary_policy", "off"),
        adversary_margin=getattr(args, "adversary_margin", 1),
        drop_probability=args.drop,
        churn_probability=args.churn,
        skip_absent_votes=args.skip_absent_votes,
        stream_retire_cap=getattr(args, "stream_retire_cap", None),
        stake_mode=getattr(args, "stake_mode", "off"),
        stake_zipf_s=getattr(args, "stake_zipf_s", 1.0),
        stake_weights=getattr(args, "stake_weights_parsed", None),
        registry_nodes=getattr(args, "registry_nodes", 0),
        active_nodes=getattr(args, "active_nodes", 0),
        node_churn_rate=getattr(args, "node_churn_rate", 0.0),
        arrival_cluster_weights=getattr(
            args, "arrival_cluster_weights_parsed", None),
        ingest_engine=getattr(args, "ingest_engine", "u8"),
        round_engine=getattr(args, "round_engine", "phased"),
        inflight_engine=getattr(args, "inflight_engine", "walk"),
        metrics_every=(getattr(args, "metrics_every", 0)
                       if getattr(args, "metrics", None) else 0),
        trace_every=getattr(args, "trace_every", 0),
    )


def _watchdog_run(state, cfg: AvalancheConfig, max_rounds: int,
                  round_step, settled) -> tuple:
    """`--check-invariants` driver: one round at a time with the host
    invariant watchdog (`obs/watchdog.py`) between rounds.  Returns
    ``(final_state, checks_run)``; raises `obs.InvariantViolation` on
    the first violated invariant."""
    from go_avalanche_tpu_torch import obs

    wd = obs.Watchdog(cfg)
    wd.check(state)
    for _ in range(max_rounds):
        if bool(settled(state, cfg)):
            break
        state = round_step(state, cfg)[0]
        wd.check(state)
    return state, wd.checks


def _key(args):
    return prng.key(args.seed, args.device_resolved)


def _parse_mesh(mesh_arg: str):
    """`--mesh N,T` -> a (nodes, txs) mesh over the running ranks."""
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    n_shards, t_shards = (int(x) for x in mesh_arg.split(","))
    return make_mesh(n_node_shards=n_shards, n_tx_shards=t_shards)


def _report_memory(args, cfg: AvalancheConfig, state, step,
                   driver: str = None) -> None:
    """`--report-memory`: the memory ledger of one round of `state`
    under `step` (`obs/resources.memory_record`, on the card) and the
    analytic per-plane footprint of the run's state
    (`obs/resources.footprint`), printed to stderr by rank 0 before the
    run; stdout keeps the one-result contract.  Under `--mesh` the
    footprint is per rank, from `specs_of` of the sharded `driver`
    module (`parallel/<driver>.py`); under `--fleet`
    it is one trial's, beside the reference's stacked layout of F
    trials.  On the CPU there is no device ledger: the footprint only.
    Reporting only — the assertions live in `chip_smoke.py`."""
    if not (args.report_memory and args.lead):
        return
    import importlib
    import sys

    from go_avalanche_tpu_torch.obs import resources
    from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS

    out = sys.stderr
    specs = mesh = None
    if args.fleet is not None:
        scope = f"fleet{args.fleet}, one trial at a time"
    elif args.mesh:
        mesh = dict(zip((NODES_AXIS, TXS_AXIS),
                        (int(x) for x in args.mesh.split(","))))
        specs = importlib.import_module(
            f"go_avalanche_tpu_torch.parallel.{driver}").specs_of(state)
        scope = "per rank (sharded planes divide by their mesh axes)"
    else:
        scope = "single device"
    print(f"memory report [{args.model}, {scope}]:", file=out)
    fp = resources.footprint(state, specs, mesh)
    if args.device_resolved.type != "cuda":
        print("  no device ledger on the CPU: the analytic footprint "
              "only", file=out)
    elif mesh is None:
        rec = resources.memory_record(lambda s: step(s, cfg)[0], state)
        for key in ("argument_bytes", "output_bytes", "shared_bytes",
                    "temp_bytes", "live_bytes", "live_peak_bytes"):
            print(f"  {key:>22}: {rec[key]:>15,}", file=out)
        failures = resources.check_memory(rec, fp["total_bytes"],
                                          what=args.model)
        print("  check_memory: " + ("; ".join(failures) or "clean"),
              file=out)
    ref = resources.footprint(state, specs, mesh, dtypes="reference")
    print(f"  analytic state footprint: {fp['total_bytes']:,} B across "
          f"{len(fp['planes'])} planes ({ref['total_bytes']:,} B in the "
          f"reference's dtypes)", file=out)
    if args.fleet is not None:
        print(f"  the reference's stacked layout, {args.fleet} x one "
              f"trial: {args.fleet * ref['total_bytes']:,} B", file=out)
    top = sorted(fp["planes"].items(), key=lambda kv: -kv[1])[:5]
    for path, nbytes in top:
        print(f"    {path:>24}: {nbytes:>15,}", file=out)


def _audit_failed(args, failures) -> None:
    """Print the audit's verdict to stderr (rank 0; stdout keeps the
    one-result contract) and exit 1 on a failure."""
    import sys

    if failures:
        if args.lead:
            print("AUDIT FAILURES:\n  " + "\n  ".join(failures),
                  file=sys.stderr)
        raise SystemExit(1)
    if args.lead:
        print(f"audit ok: {args.model} program passes its contracts "
              f"(callbacks/dtype/collectives/donation)", file=sys.stderr)


def _before_run(args, cfg: AvalancheConfig, state, step,
                driver: str = None) -> None:
    """`--audit`, then `--report-memory`, of the state the runner built
    under its `step`.  The audit runs one round on a copy of the state
    (`analysis/audit.audit_run_sim`); under `--mesh` the sharded
    `driver`'s step on this rank's block, every rank taking part."""
    if args.audit:
        from go_avalanche_tpu_torch.analysis import audit

        if args.mesh and driver is not None:
            mesh = _parse_mesh(args.mesh)
            place, make_step = audit.placement(driver)
            failures = audit.audit_run_sim(args, cfg, place(state, mesh),
                                           make_step(mesh, cfg), driver,
                                           mesh)
        else:
            failures = audit.audit_run_sim(args, cfg, state, step)
        _audit_failed(args, failures)
    _report_memory(args, cfg, state, step, driver)


def run_snowball(args, cfg: AvalancheConfig) -> Dict:
    from go_avalanche_tpu_torch.models import snowball as sb
    from go_avalanche_tpu_torch.ops import voterecord as vr

    dev = args.device_resolved
    state = sb.init(_key(args), args.nodes, cfg,
                    yes_fraction=args.yes_fraction, device=dev)
    state = sb.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, sb.round_step)
    out = {}
    if args.check_invariants:
        def settled(s, cfg):
            return ~(~vr.has_finalized(s.records.confidence, cfg)
                     & s.alive).any()

        state, out["invariant_checks"] = _watchdog_run(
            state, cfg, args.max_rounds, sb.round_step, settled)
    else:
        state = sb.run(state, cfg, args.max_rounds, device=dev)
    out.update(_emit_trace(args, cfg, state.trace))
    fin = _np(vr.has_finalized(state.records.confidence, cfg))
    pref = _np(vr.is_accepted(state.records.confidence))
    return {
        "rounds": int(state.round),
        "finalized_fraction": float(fin.mean()),
        "yes_fraction": float(pref[fin].mean()) if fin.any() else None,
        **out,
    }


def _maybe_restore(path, state, device):
    """Resume `--chunk` runs: restore from `--checkpoint` if it exists."""
    if path and os.path.exists(path):
        from go_avalanche_tpu_torch.utils.checkpoint import (
            restore_checkpoint)
        return restore_checkpoint(path, state, device=device)
    return state


def _emit_trace(args, cfg: AvalancheConfig, buf, fleet: bool = False
                ) -> Dict:
    """Decode a finished run's trace plane (obs/trace.py) and stream it
    to its sink: `--trace-out` when given (its own file + manifest),
    else the active `--metrics` sink.  Fleet buffers decode to the
    fleet-stacked record format.  Returns the result keys to merge ({}
    when the run carried no trace)."""
    if buf is None:
        return {}
    from go_avalanche_tpu_torch import obs
    from go_avalanche_tpu_torch.obs import trace as obs_trace
    from go_avalanche_tpu_torch.obs.sink import active_sink

    def _write(sink) -> int:
        if fleet:
            wrote = 0
            for rec in obs_trace.fleet_trace_records(buf):
                sink.write(rec)
                wrote += 1
            return wrote
        return obs_trace.write_trace(sink, buf)

    if not args.lead:
        return {}
    if args.trace_out:
        with obs.metrics_sink(args.trace_out,
                              tag=obs.config_tag(cfg)) as sink:
            wrote = _write(sink)
        obs.write_manifest(args.trace_out, cfg, extra={
            "model": args.model,
            "workload": {"nodes": args.nodes, "txs": args.txs,
                         "max_rounds": args.max_rounds,
                         "seed": args.seed},
        })
        return {"trace_records": wrote, "trace_file": args.trace_out}
    sink = active_sink()
    if sink is None:
        return {}
    return {"trace_records": _write(sink)}


def run_avalanche(args, cfg: AvalancheConfig) -> Dict:
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.ops import voterecord as vr

    dev = args.device_resolved
    init_pref = (av.contested_init_pref(args.seed, args.nodes, args.txs,
                                        device=dev)
                 if args.contested else None)
    state = av.init(_key(args), args.nodes, args.txs, cfg,
                    init_pref=init_pref, device=dev)
    state = av.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, av.round_step, "sharded")
    extra = {}
    if args.mesh:
        from go_avalanche_tpu_torch.parallel import sharded

        mesh = _parse_mesh(args.mesh)
        state = sharded.run_sharded(mesh, sharded.shard_state(state, mesh),
                                    cfg, max_rounds=args.max_rounds,
                                    donate=args.donate)
        state = sharded.gather_state(state, mesh)
    elif args.check_invariants:
        state, extra["invariant_checks"] = _watchdog_run(
            state, cfg, args.max_rounds, av.round_step, av.all_settled)
    else:
        state = av.run(state, cfg, args.max_rounds, device=dev)
    extra.update(_emit_trace(args, cfg, state.trace))
    fin = _np(vr.has_finalized(state.records.confidence, cfg))
    out = {
        "rounds": int(state.round),
        "finalized_fraction": float(fin.mean()),
        "nodes_fully_finalized": int(fin.all(axis=1).sum()),
        **extra,
    }
    out.update({f"finality_{k}": v for k, v in
                metrics.rounds_to_finality(state.finalized_at).items()})
    return out


def run_dag(args, cfg: AvalancheConfig) -> Dict:
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import voterecord as vr

    dev = args.device_resolved
    conflict_set = torch.div(torch.arange(args.txs, dtype=torch.int32),
                             args.conflict_size, rounding_mode="floor")
    state = dag.init(_key(args), args.nodes, conflict_set, cfg, device=dev)
    state = dag.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, dag.round_step, "sharded_dag")
    extra = {}
    if args.mesh:
        from go_avalanche_tpu_torch.parallel import sharded_dag

        mesh = _parse_mesh(args.mesh)
        state = sharded_dag.run_sharded_dag(
            mesh, sharded_dag.shard_dag_state(state, mesh), cfg,
            max_rounds=args.max_rounds, donate=args.donate)
        state = sharded_dag.gather_dag_state(state, mesh)
    elif args.check_invariants:
        state, extra["invariant_checks"] = _watchdog_run(
            state, cfg, args.max_rounds, dag.round_step, dag.settled)
    else:
        state = dag.run(state, cfg, args.max_rounds, device=dev)
    extra.update(_emit_trace(args, cfg, state.base.trace))
    conf = state.base.records.confidence
    fin_acc = _np(vr.has_finalized(conf, cfg) & vr.is_accepted(conf))
    cs = _np(conflict_set)
    n_sets = int(cs.max()) + 1
    # Every (node, set) must have exactly one finalized-accepted winner.
    winners_per_set = np.zeros((args.nodes, n_sets), np.int64)
    for s in range(n_sets):
        winners_per_set[:, s] = fin_acc[:, cs == s].sum(axis=1)
    return {
        "rounds": int(state.base.round),
        "sets_resolved_fraction": float((winners_per_set == 1).mean()),
        "conflict_sets": n_sets,
        **extra,
    }


def run_slush(args, cfg: AvalancheConfig) -> Dict:
    from go_avalanche_tpu_torch.models import family as fam

    dev = args.device_resolved
    state = fam.slush_init(_key(args), args.nodes, cfg,
                           yes_fraction=args.yes_fraction, device=dev)
    _before_run(args, cfg, state, fam.slush_round)
    final, _ = fam.slush_run(state, cfg, args.max_rounds, device=dev)
    colors = _np(final.color)
    return {
        "rounds": int(final.round),
        "yes_fraction_final": float(colors.mean()),
        "converged": bool(colors.mean() > 0.95 or colors.mean() < 0.05),
    }


def run_snowflake(args, cfg: AvalancheConfig) -> Dict:
    from go_avalanche_tpu_torch.models import family as fam

    dev = args.device_resolved
    state = fam.snowflake_init(_key(args), args.nodes, cfg,
                               yes_fraction=args.yes_fraction, device=dev)
    _before_run(args, cfg, state, fam.snowflake_round)
    final = fam.snowflake_run(state, cfg, args.max_rounds, device=dev)
    acc = _np(final.accepted_at)
    colors = _np(final.color)
    done = acc >= 0
    return {
        "rounds": int(final.round),
        "accepted_fraction": float(done.mean()),
        "yes_fraction_final": float(colors[done].mean())
        if done.any() else None,
        "accept_round_median": float(np.median(acc[done]))
        if done.any() else None,
    }


def run_streaming_dag(args, cfg: AvalancheConfig) -> Dict:
    """Streaming conflict-set run: `--txs` pending txs in conflict sets of
    `--conflict-size`, streamed through a `--slots`-set window
    (models/streaming_dag)."""
    from go_avalanche_tpu_torch import sync
    from go_avalanche_tpu_torch import traffic as tf
    from go_avalanche_tpu_torch.models import streaming_dag as sdg

    dev = args.device_resolved
    c = args.conflict_size
    if args.txs % c:
        raise SystemExit(f"--txs ({args.txs}) must divide by "
                         f"--conflict-size ({c})")
    n_sets = args.txs // c
    backlog = sdg.make_set_backlog(
        torch.arange(args.txs, dtype=torch.int32).reshape(n_sets, c))
    state = sdg.init(_key(args), args.nodes, args.slots, backlog, cfg,
                     device=dev)
    state = sdg.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, sdg.step, "sharded_streaming_dag")
    if args.mesh:
        from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd

        mesh = _parse_mesh(args.mesh)
        final = ssd.run_sharded_streaming_dag(
            mesh, ssd.shard_streaming_dag_state(state, mesh), cfg,
            max_rounds=args.max_rounds, donate=args.donate)
        final = ssd.gather_streaming_dag_state(final, mesh)
    elif args.chunk:
        # Host-chunked dispatch (the same final state as one run), and
        # --checkpoint resumes a killed run from the last saved boundary.
        state = _maybe_restore(args.checkpoint, state, dev)
        final = sdg.run_chunked(state, cfg, max_rounds=args.max_rounds,
                                chunk=args.chunk,
                                checkpoint_path=args.checkpoint,
                                device=dev)
        if args.checkpoint and sync.read(sdg.drained(final, cfg)):
            # Drained: remove the checkpoint so rerunning the same command
            # starts a fresh simulation instead of resuming (and at once
            # "finishing") the completed one.  A max_rounds-capped run
            # keeps its checkpoint: resuming that is the point.
            try:
                os.remove(args.checkpoint)
            except FileNotFoundError:
                pass
    else:
        final = sdg.run(state, cfg, args.max_rounds, device=dev)
    return {
        "rounds": int(final.dag.base.round),
        "window_sets": args.slots,
        "conflict_sets": n_sets,
        **sdg.resolution_summary(final),
        **tf.latency_percentiles(final.traffic),
        **_emit_trace(args, cfg, final.dag.base.trace),
    }


def run_backlog(args, cfg: AvalancheConfig) -> Dict:
    """Streaming working-set run: `--txs` pending txs through a `--slots`
    working-set window (models/backlog)."""
    from go_avalanche_tpu_torch import traffic as tf
    from go_avalanche_tpu_torch.models import backlog as bl

    dev = args.device_resolved
    b = bl.make_backlog(torch.arange(args.txs, dtype=torch.int32))
    state = bl.init(_key(args), args.nodes, args.slots, b, cfg, device=dev)
    state = bl.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, bl.step, "sharded_backlog")
    if args.mesh:
        from go_avalanche_tpu_torch.parallel import sharded_backlog

        mesh = _parse_mesh(args.mesh)
        final = sharded_backlog.run_sharded_backlog(
            mesh, sharded_backlog.shard_backlog_state(state, mesh), cfg,
            max_rounds=args.max_rounds, donate=args.donate)
        final = sharded_backlog.gather_backlog_state(final, mesh)
    else:
        final = bl.run(state, cfg, args.max_rounds, device=dev)
    trace_extra = _emit_trace(args, cfg, final.sim.trace)
    settled = _np(final.outputs.settled)
    latency = (_np(final.outputs.settle_round)
               - _np(final.outputs.admit_round))[settled]
    return {
        "rounds": int(final.sim.round),
        "slots": args.slots,
        "settled_fraction": float(settled.mean()),
        "accepted_fraction": float(_np(final.outputs.accepted)[settled]
                                   .mean())
        if settled.any() else None,
        "settle_latency_median": float(np.median(latency))
        if settled.any() else None,
        **tf.latency_percentiles(final.traffic),
        **trace_extra,
    }


def run_node_stream(args, cfg: AvalancheConfig) -> Dict:
    """Node-axis streaming run: a `--registry-nodes` population of which
    `--active-nodes` rows are resident in the dense window at a time
    (models/node_stream)."""
    from go_avalanche_tpu_torch.models import node_stream as ns

    dev = args.device_resolved
    state = ns.init(_key(args), args.txs, cfg, device=dev)
    state = ns.with_trace(state, cfg, args.max_rounds)
    _before_run(args, cfg, state, ns.step, "sharded_node_stream")
    if args.mesh:
        from go_avalanche_tpu_torch.parallel import sharded_node_stream as sns

        mesh = _parse_mesh(args.mesh)
        final, _ = sns.run_scan_sharded_node_stream(
            mesh, sns.shard_node_stream_state(state, mesh), cfg,
            n_rounds=args.max_rounds, donate=args.donate)
        final = sns.gather_node_stream_state(final, mesh)
    else:
        final, _ = ns.run_scan(state, cfg, args.max_rounds, device=dev)
    return {
        # Overrides the generic "nodes" key (--nodes is unread here —
        # the window height is --active-nodes).
        "nodes": cfg.active_nodes,
        "rounds": int(final.sim.round),
        "registry_nodes": cfg.registry_nodes,
        "active_nodes": cfg.active_nodes,
        **ns.window_summary(final, cfg),
        **_emit_trace(args, cfg, final.sim.trace),
    }


def run_fleet_mode(args, cfg: AvalancheConfig) -> Dict:
    """`--fleet` driver: one Monte-Carlo fleet per config point
    (`fleet.py`), Wilson-CI estimates out; with `--phase-grid`, one fleet
    per cartesian point.  Phase rows stream to the active `--metrics`
    sink as phase-diagram JSONL."""
    from go_avalanche_tpu_torch import fleet as fl
    from go_avalanche_tpu_torch import obs
    from go_avalanche_tpu_torch.obs.sink import active_sink

    sink = active_sink()
    mesh = args.fleet_mesh
    mesh_extra = ({"fleet_mesh": args.mesh, "fleet_devices": mesh.size}
                  if mesh is not None else {})
    common = dict(fleet=args.fleet, n_nodes=args.nodes, n_txs=args.txs,
                  n_rounds=args.max_rounds, seed=args.seed,
                  conflict_size=args.conflict_size,
                  yes_fraction=args.yes_fraction,
                  contested=args.contested,
                  window=args.slots, mesh=mesh,
                  device=args.device_resolved)
    if args.audit:
        from go_avalanche_tpu_torch.analysis import audit

        _audit_failed(args, audit.audit_run_sim(args, cfg))
    if args.report_memory and args.lead:
        key = prng.split(prng.key(args.seed, args.device_resolved),
                         args.fleet)[0]
        state, step, _, _ = fl.trial_init(
            args.model, cfg, args.nodes, args.txs, args.max_rounds,
            args.conflict_size, args.yes_fraction, args.contested,
            args.slots, args.device_resolved)(key)
        _report_memory(args, cfg, state, step)
        del state
    if args.phase_grid_parsed is not None:
        rows = fl.run_phase_grid(args.model, cfg,
                                 args.phase_grid_parsed, sink=sink,
                                 **common)
        return {"fleet": args.fleet, "phase_points": len(rows),
                "grid_rows": rows, **mesh_extra}
    res = fl.run_fleet(args.model, cfg, **common)
    row = res.summary()
    row.update(mesh_extra)
    realized = res.realizations()
    if realized:
        row["realizations"] = realized
    if sink is not None:
        sink.write({**row, "point": {}, "tag": obs.config_tag(cfg)})
    if res.trace is not None:
        # Per-trial round-by-round traces: fleet-stacked rows to the
        # trace sink — --trace-out when given, else the phase-row sink
        # (rows are distinguishable by their `round` key).
        row.update(_emit_trace(args, cfg, res.trace, fleet=True))
    return row


def parse_args(argv=None):
    """``(args, cfg)``: the parsed and validated flags and the config
    they select (with the fleet's tap off), refusing bad combinations
    through `parser.error` as the reference does."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model",
                        choices=["slush", "snowflake", "snowball",
                                 "avalanche", "dag", "backlog",
                                 "streaming_dag", "node_stream"],
                        default="avalanche")
    parser.add_argument("--nodes", type=int, default=256)
    parser.add_argument("--txs", type=int, default=64)
    parser.add_argument("--max-rounds", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="torch device the simulation runs on (the "
                             "card unless asked for the CPU; no silent "
                             "fallback)")
    # protocol constants (reference parity defaults)
    parser.add_argument("--finalization-score", type=int, default=128)
    parser.add_argument("--max-element-poll", type=int, default=4096)
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--quorum", type=int, default=7)
    parser.add_argument("--k", type=int, default=8)
    parser.add_argument("--alpha", type=float, default=0.8)
    parser.add_argument("--vote-mode", choices=["sequential", "majority"],
                        default="sequential")
    # simulator knobs
    parser.add_argument("--no-gossip", action="store_true")
    parser.add_argument("--weighted", action="store_true",
                        help="latency-weighted peer sampling")
    parser.add_argument("--distinct-peers", action="store_true",
                        help="sample k DISTINCT peers per node per round "
                             "(without replacement; the protocol's real "
                             "query semantics)")
    parser.add_argument("--clusters", type=int, default=1,
                        help="clustered topology: nodes in this many "
                             "contiguous clusters; draws prefer the own "
                             "cluster (1 = off; models: avalanche, dag, "
                             "backlog, streaming_dag — like --weighted)")
    parser.add_argument("--cluster-locality", type=float, default=0.8,
                        help="P(a draw lands in the drawing node's own "
                             "cluster)")
    # stake subsystem (go_avalanche_tpu/stake.py)
    parser.add_argument("--stake-mode",
                        choices=["off", "uniform", "zipf", "explicit"],
                        default="off",
                        help="per-node stake distribution "
                             "(cfg.stake_mode): peer draws become "
                             "stake-weighted COMMITTEE draws — "
                             "'uniform' equal stake, 'zipf' node i "
                             "holds 1/(i+1)^s with s = --stake-zipf-s "
                             "(id 0 richest), 'explicit' the "
                             "--stake-weights vector.  With "
                             "--clusters > 1 the draw runs the "
                             "two-level hierarchical sampler "
                             "(bit-identical to the flat CDF).  "
                             "Models with a peer-draw dispatch only "
                             "(avalanche, dag, backlog, "
                             "streaming_dag, node_stream); 'off' = "
                             "the weightless pre-stake path")
    parser.add_argument("--stake-zipf-s", type=float, default=1.0,
                        help="zipf exponent for --stake-mode zipf "
                             "(> 0; larger = more concentrated stake)")
    parser.add_argument("--stake-weights", type=str, default=None,
                        metavar="W1,W2,...",
                        help="--stake-mode explicit: the per-node "
                             "stake vector (comma-separated positive "
                             "numbers; one per node — or per REGISTRY "
                             "entry with --registry-nodes)")
    parser.add_argument("--registry-nodes", type=int, default=0,
                        metavar="R",
                        help="node-axis streaming scheduler "
                             "(models/node_stream, --model "
                             "node_stream): the full node-registry "
                             "size, of which only --active-nodes rows "
                             "are resident in the dense window at a "
                             "time — the nodes >> HBM regime.  Needs "
                             "a --stake-mode (the working set is "
                             "drawn stake-proportionally)")
    parser.add_argument("--active-nodes", type=int, default=0,
                        metavar="W",
                        help="node_stream: active working-set rows "
                             "(the dense window height; "
                             "< --registry-nodes)")
    parser.add_argument("--node-churn-rate", type=float, default=0.0,
                        help="node_stream: P(an active row rotates "
                             "out, per round); departures retire "
                             "their vote records, arrivals are drawn "
                             "stake-proportionally from the "
                             "non-resident registry")
    parser.add_argument("--yes-fraction", type=float, default=1.0,
                        help="slush/snowflake/snowball: initial "
                             "yes-preference fraction")
    parser.add_argument("--contested", action="store_true",
                        help="avalanche: per-NODE 50/50 initial preferences "
                             "(the network must actually converge per tx)")
    parser.add_argument("--conflict-size", type=int, default=2,
                        help="dag: txs per conflict set")
    parser.add_argument("--slots", type=int, default=64,
                        help="backlog: active working-set slots; "
                             "streaming_dag: active working-set SETS")
    # live-traffic service mode (go_avalanche_tpu/traffic.py)
    parser.add_argument("--arrival-mode",
                        choices=["off", "poisson", "bursty", "diurnal",
                                 "external"],
                        default="off",
                        help="live-traffic arrival schedule (streaming "
                             "models backlog/streaming_dag, dense, "
                             "--mesh, or --fleet backlog): instead of "
                             "draining a fully pre-seeded backlog, "
                             "admission units (txs / conflict sets) "
                             "ARRIVE per round — 'poisson' at "
                             "--arrival-rate, 'bursty' with a "
                             "--arrival-burst-factor peak for the "
                             "first --arrival-duty of every "
                             "--arrival-period rounds, 'diurnal' on a "
                             "--arrival-depth sinusoid, 'external' "
                             "(arrivals pushed via the Connector "
                             "SIM_SUBMIT message only).  Finality "
                             "latency (arrival round -> settle round) "
                             "is recorded in-graph with p50/p99/p999 "
                             "percentiles (docs/observability.md).  "
                             "'off' = the seed drain path, statically "
                             "absent from every compiled program")
    parser.add_argument("--arrival-rate", type=float, default=0.0,
                        help="mean admission units per round (the "
                             "offered load); > 0 for every schedule "
                             "except off/external")
    parser.add_argument("--arrival-period", type=int, default=0,
                        help="bursty/diurnal: modulation cycle length "
                             "in rounds (>= 2)")
    parser.add_argument("--arrival-burst-factor", type=float, default=1.0,
                        help="bursty: peak rate multiplier (> 1) during "
                             "the duty window")
    parser.add_argument("--arrival-duty", type=float, default=0.5,
                        help="bursty: fraction of each period at the "
                             "peak, in (0, 1)")
    parser.add_argument("--arrival-depth", type=float, default=0.0,
                        help="diurnal: sinusoid modulation depth in "
                             "[0, 1]")
    parser.add_argument("--arrival-cluster-weights", type=str,
                        default=None, metavar="W1,W2,...",
                        help="per-cluster arrival skew (hot regions): "
                             "one positive rate multiplier per "
                             "cluster (--clusters entries) — the "
                             "admission order splits into contiguous "
                             "region blocks (the clustered topology's "
                             "own cluster_of partition) and each "
                             "block's arrivals draw at rate x its "
                             "region weight.  Needs --clusters > 1 "
                             "and an in-graph schedule mode")
    parser.add_argument("--arrival-backpressure", type=str, default=None,
                        metavar="LO,HI",
                        help="closed-loop admission control: working-set "
                             "occupancy fractions — full scheduled rate "
                             "below LO, fully throttled above HI, "
                             "linear in between (0 <= LO < HI <= 1); "
                             "occupancy is the backpressure signal "
                             "(examples/capacity_planning.py)")
    # fault model
    parser.add_argument("--byzantine", type=float, default=0.0)
    parser.add_argument("--flip-probability", type=float, default=1.0)
    parser.add_argument("--adversary",
                        choices=[s.value for s in AdversaryStrategy],
                        default=AdversaryStrategy.FLIP.value,
                        help="what a lying byzantine peer answers")
    parser.add_argument("--adversary-policy",
                        choices=list(ADVERSARY_POLICIES),
                        default="off",
                        help="adaptive adversary policy "
                             "(cfg.adversary_policy, ops/adversary.py): "
                             "a jit-static attack kind that reads the "
                             "CURRENT network state each round — "
                             "'split_vote' lies vote the HONEST "
                             "population's minority color (the arXiv "
                             "2401.02811 stall attack; overrides "
                             "--adversary's lie content), "
                             "'withhold_near_quorum' lying draws go "
                             "silent when the querier is within "
                             "--adversary-margin window votes of the "
                             "conclusive quorum (async configs expire "
                             "them through the timeout machinery), "
                             "'stake_eclipse' concentrates lies on the "
                             "top-stake honest queriers (needs "
                             "--stake-mode), 'timing' delays lies to "
                             "land just before --timeout-rounds (needs "
                             "an async --latency-mode).  Composes with "
                             "--byzantine/--flip-probability; 'off' = "
                             "the static strategies only, statically "
                             "absent from every compiled program")
    parser.add_argument("--adversary-margin", type=int, default=1,
                        help="withhold_near_quorum: window votes short "
                             "of the conclusive quorum at which a "
                             "querier counts as near-quorum (>= quorum "
                             "- margin)")
    parser.add_argument("--drop", type=float, default=0.0)
    parser.add_argument("--churn", type=float, default=0.0)
    parser.add_argument("--latency-mode",
                        choices=["none", "fixed", "geometric", "weighted",
                                 "rtt"],
                        default="none",
                        help="async query lifecycle (ops/inflight.py): "
                             "per-(querier, draw) response latency in "
                             "rounds — 'fixed' = always "
                             "--latency-rounds, 'geometric' = iid with "
                             "that mean, 'weighted' = coupled to the "
                             "latency_weight plane (nearest peer 0, "
                             "farthest --latency-rounds; snowball has "
                             "no such plane, so 'weighted' there "
                             "degenerates to latency 0 — use "
                             "fixed/geometric), 'rtt' = topology-"
                             "coupled from the --rtt-matrix cluster-"
                             "pair matrix (needs --clusters > 1).  "
                             "'none' = the synchronous ideal.  Works "
                             "with every model; sequential vote mode "
                             "only")
    parser.add_argument("--latency-rounds", type=int, default=0,
                        help="latency parameter (see --latency-mode); "
                             "draws beyond --timeout-rounds expire "
                             "unanswered")
    parser.add_argument("--partition", type=str, default=None,
                        metavar="START,END,FRAC",
                        help="network partition: for rounds [START, END) "
                             "split the nodes at FRAC (cluster-aligned "
                             "with --clusters); cross-partition queries "
                             "TIME OUT (expire unanswered) rather than "
                             "silently vanishing, then the partition "
                             "heals.  Turns on the async engine even "
                             "with --latency-mode none")
    parser.add_argument("--fault-script", type=str, default=None,
                        metavar="PATH.json",
                        help="scheduled fault-script engine "
                             "(cfg.fault_script): a JSON list of timed "
                             "events — partition / regional_outage / "
                             "latency_spike / churn_burst, tuple or "
                             "object spelling (see docs/observability.md "
                             "for the schema; examples/fault_scenarios.py "
                             "for worked scenarios).  Windows are "
                             "END-EXCLUSIVE rounds; composes with "
                             "--partition (the one-event sugar).  "
                             "Malformed, out-of-range or overlapping "
                             "events are rejected HERE at the parser, "
                             "never in the worker.  Works with every "
                             "model")
    parser.add_argument("--rtt-matrix", type=str, default=None,
                        metavar="SPEC",
                        help="cluster-pair RTT matrix for --latency-mode "
                             "rtt (cfg.rtt_matrix): 'C x C' latencies in "
                             "rounds, either inline rows "
                             "('1,3;3,1' — rows ';'-separated) or a "
                             "path to a JSON file holding a list of "
                             "lists.  Row i column j = latency of a "
                             "query from cluster i to cluster j; "
                             "entries >= --timeout-rounds never deliver. "
                             "Needs --clusters == C")
    parser.add_argument("--timeout-rounds", type=int, default=8,
                        help="async modes: rounds before an outstanding "
                             "query expires unanswered (the in-flight "
                             "ring depth; maps onto request_timeout_s / "
                             "time_step_s — host Processor reaping "
                             "parity).  Expiry flows into "
                             "--skip-absent-votes exactly like drops")
    parser.add_argument("--skip-absent-votes", action="store_true",
                        help="reference-HOST non-response semantics: a "
                             "dead/dropped peer registers NOTHING instead "
                             "of a window-shifting neutral (see RESULTS.md "
                             "churn study; linear vs ~a^7 availability "
                             "cost)")
    parser.add_argument("--fleet", type=int, default=None, metavar="F",
                        help="Monte-Carlo fleet mode (go_avalanche_tpu/"
                             "fleet.py): vmap F whole sims — init, "
                             "--max-rounds rounds, in-graph safety/"
                             "finality reduction — over a batched seed "
                             "axis as ONE compiled program, and report "
                             "P(safety violation) / P(settled) / "
                             "E(finality round) with Wilson confidence "
                             "intervals.  Models: snowball, avalanche, "
                             "dag, backlog (backlog streams --txs "
                             "through a --slots window per trial and, "
                             "with --arrival-*, reports per-trial "
                             "finality-latency percentiles — the "
                             "offered-load capacity diagram).  With "
                             "--metrics, streams phase-diagram JSONL "
                             "rows (one per config point) instead of "
                             "per-round telemetry")
    parser.add_argument("--phase-grid", type=str, default=None,
                        metavar="JSON",
                        help="with --fleet: sweep a config-axis grid — "
                             "inline JSON or a path to a JSON file, "
                             "e.g. '{\"byzantine_fraction\": [0.0, 0.2, "
                             "0.4], \"k\": [8, 16]}' — one fleet per "
                             "cartesian point (re-jit per point), one "
                             "summary row each.  Sweepable axes: k, "
                             "quorum, window, alpha, finalization_"
                             "score, byzantine_fraction, flip_"
                             "probability, drop_probability, churn_"
                             "probability, latency_rounds, adversary_"
                             "strategy.  Malformed grids (non-numeric "
                             "entries, unknown axes) are rejected HERE "
                             "at the parser")
    parser.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                        help="with --mesh under torchrun: the process "
                             "group's backend (default NCCL on CUDA, one "
                             "card per rank; gloo on the CPU).  Ranks "
                             "sharing one card need 'gloo'")
    parser.add_argument("--mesh", type=str, default=None, metavar="N,T",
                        help="run the sharded backend over an "
                             "(n node shards, t tx shards) device mesh "
                             "(models: avalanche, dag, backlog).  With "
                             "--fleet the axes read (A, B) TRIAL "
                             "shards instead (parallel/"
                             "sharded_fleet.py): the Monte-Carlo trial "
                             "axis is laid over A*B devices — each "
                             "runs F/(A*B) whole sims in one compiled "
                             "program per config point, bit-identical "
                             "to the dense fleet on the same seeds — "
                             "so F must divide by A*B")
    parser.add_argument("--fleet-shape", choices=("auto",), default=None,
                        help="knee-table-driven fleet sizing "
                             "(obs/knee.py, the [F, N, T] memory-knee "
                             "table of the device profile of --device: "
                             "the card's own memory on CUDA): without "
                             "--fleet, "
                             "PICKS F — the deepest trials-per-device "
                             "row whose largest safe N=T square still "
                             "fits --nodes/--txs, times the --mesh "
                             "device count; with --fleet, VALIDATES it "
                             "— a shape above the knee is rejected "
                             "here with the table row cited")
    parser.add_argument("--donate", action="store_true",
                        help="with --mesh: donate the sharded state into "
                             "the while-loop drivers so the [N, T] planes "
                             "update in place instead of double-buffering "
                             "in HBM.  Opt-in until a hardware soak "
                             "confirms no shard_map aliasing surprises "
                             "(ROADMAP); the single-chip avalanche path "
                             "already donates unconditionally")
    parser.add_argument("--ingest-engine", choices=["u8", "swar32"],
                        default="u8",
                        help="RegisterVotes ingest engine "
                             "(cfg.ingest_engine): 'u8' = per-vote uint8 "
                             "window updates (reference), 'swar32' = 4 tx "
                             "columns lane-packed per uint32 word with the "
                             "closed-form confidence fold (ops/swar.py). "
                             "Bit-exact either way")
    parser.add_argument("--round-engine",
                        choices=["phased", "megakernel"],
                        default="phased",
                        help="whole-round execution engine for the dense "
                             "avalanche round (cfg.round_engine): "
                             "'phased' = the per-phase chain "
                             "(reference), 'megakernel' = ONE Pallas "
                             "program fusing the exchange gather, the "
                             "SWAR window ingest, and the closed-form "
                             "confidence fold (ops/megakernel.py).  "
                             "Bit-exact either way; --model avalanche "
                             "synchronous rounds only — async/in-flight "
                             "knobs, adaptive adversary policies, and "
                             "the other models reject it as inert")
    parser.add_argument("--inflight-engine",
                        choices=["walk", "walk_earlyout", "coalesced"],
                        default="walk",
                        help="async delivery engine (cfg.inflight_engine; "
                             "any model, active only with --latency-mode/"
                             "--partition): 'walk' = the per-age "
                             "fori_loop (reference), 'walk_earlyout' = "
                             "walk + per-age lax.cond skip of inert "
                             "ages, 'coalesced' = one-pass ring drain "
                             "(whole-ring masks, active ages compacted "
                             "oldest-first, bit-packed ring poll "
                             "masks; cost tracks deliveries, not ring "
                             "depth).  Bit-exact all three ways")
    parser.add_argument("--chunk", type=int, default=0, metavar="ROUNDS",
                        help="streaming_dag: dispatch the run in host-driven "
                             "chunks of this many rounds (0 = one device "
                             "dispatch). Bit-identical results; long runs "
                             "survive runtime dispatch watchdogs")
    parser.add_argument("--checkpoint", type=str, default=None,
                        metavar="PATH",
                        help="streaming_dag with --chunk: save state here "
                             "at chunk boundaries and resume from it if it "
                             "exists")
    parser.add_argument("--stream-retire-cap", type=int, default=None,
                        metavar="SETS",
                        help="streaming_dag: cap set-slots retired+refilled "
                             "per round and rewrite only their window "
                             "columns.  Free above ~2-4x the settle rate "
                             "W/L and 1.3-1.5x faster on TPU at mid-sized "
                             "node counts (RESULTS.md retire-cap tradeoff; "
                             "PERF_NOTES r05 A/B).  Default: dense rewrite")
    # output / tooling
    parser.add_argument("--audit", action="store_true",
                        help="run the contract audit "
                             "(go_avalanche_tpu_torch/analysis/audit.py) "
                             "on the EXACT program these flags select "
                             "before executing it: one round on a copy "
                             "of the state under recorders — host "
                             "reads and taps, kernel launches, dtype "
                             "budget, collectives (--mesh: the "
                             "driver's DECLARED_COLLECTIVES manifest), "
                             "donation.  --fleet audits the program "
                             "fleet.compiled_fleet_program gives the "
                             "run.  Exits 1 with the contract failures "
                             "instead of running")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON line instead of key=value text")
    parser.add_argument("--trace", type=str, default=None,
                        help="write a torch.profiler trace to this "
                             "directory")
    parser.add_argument("--metrics", type=str, default=None, metavar="PATH",
                        help="stream per-round telemetry to this JSONL file "
                             "through the in-graph metrics tap "
                             "(go_avalanche_tpu/obs: one unordered "
                             "io_callback per emitted round inside the "
                             "compiled loop — the flight recorder) and "
                             "write a run manifest next to it "
                             "(PATH.manifest.json).  Models whose round "
                             "body carries the tap: snowball, avalanche, "
                             "dag, backlog, streaming_dag (the streaming "
                             "schedulers emit their FULL scheduler "
                             "record — inner round + retire/occupancy + "
                             "traffic fields — one line per round).  "
                             "Sharded runs stream host-side "
                             "instead (obs.MetricsSink.write_stacked — "
                             "see examples/fault_scenarios.py), so "
                             "--metrics excludes --mesh")
    parser.add_argument("--metrics-every", type=int, default=0,
                        metavar="N",
                        help="emit every N-th round (cfg.metrics_every); "
                             "defaults to 1 when --metrics is given, 0 "
                             "(tap statically absent — every hlo_pin "
                             "hash unchanged) otherwise")
    parser.add_argument("--trace-every", type=int, default=0,
                        metavar="N",
                        help="on-device trace plane (cfg.trace_every, "
                             "obs/trace.py): every N-th round the "
                             "round/scheduler step writes its telemetry "
                             "row into an [S, M] buffer carried in the "
                             "sim state — one dynamic_update_slice, no "
                             "io_callback, so it works with --mesh "
                             "(replicated plane) and --fleet (per-trial "
                             "[F, S, M] traces).  Decoded host-side "
                             "after the run to the same JSONL schema "
                             "as --metrics-every, into --trace-out if "
                             "given, else the --metrics sink.  0 "
                             "(default) = statically absent (every "
                             "hlo_pin hash unchanged)")
    parser.add_argument("--trace-out", type=str, default=None,
                        metavar="PATH",
                        help="with --trace-every: decode the trace "
                             "plane to this JSONL file (+ manifest) "
                             "instead of the --metrics sink.  REQUIRED "
                             "when --metrics-every is also nonzero — "
                             "each tap writes one line per round, and "
                             "an interleaved mix in one file would "
                             "carry duplicate rounds under one "
                             "manifest")
    parser.add_argument("--report-memory", action="store_true",
                        help="resource report (obs/resources.py): "
                             "print the memory ledger of one round of "
                             "the state these flags build (allocated "
                             "state, round peak, live bytes after it; "
                             "on the card only) and the analytic "
                             "per-plane state footprint to stderr, "
                             "then run.  Rejected with --phase-grid / "
                             "--check-invariants / --chunk, as the "
                             "reference's")
    parser.add_argument("--check-invariants", action="store_true",
                        help="debug mode (obs/watchdog.py): step the sim "
                             "one jitted round at a time and assert the "
                             "structural invariants on the host between "
                             "rounds — confidence counter caps, window "
                             "bit hygiene, ring ages/depth, packed-plane "
                             "padding, finalized-count monotonicity.  "
                             "Raises InvariantViolation with offender "
                             "indices on the first failure.  Models: "
                             "snowball, avalanche, dag (dense; the "
                             "streaming schedulers legitimately reset "
                             "refilled columns)")
    args = parser.parse_args(argv)
    # --audit / --report-memory validation: everything parser-level.
    # Both take ONE program; flag combinations with no single-program
    # meaning are rejected here, with the reference's messages.
    if args.audit or args.report_memory:
        what, verb = (("--audit", "audit") if args.audit
                      else ("--report-memory", "analyze"))
        if args.phase_grid is not None:
            parser.error(
                f"{what} with --phase-grid would compile twice per "
                f"point: every grid point re-jits its own fleet "
                f"program, so {verb}ing the sweep means lowering the "
                f"whole grid before the sweep compiles it again — "
                f"{verb} a single --fleet point (one program, lowered "
                f"once, compiled once) instead")
        if args.check_invariants:
            parser.error(f"{what} lowers the one fused program the run "
                         f"executes; --check-invariants dispatches "
                         f"per-round jits — there is no single program "
                         f"to {verb}")
        if args.chunk:
            parser.error(f"{what} lowers the one fused program the run "
                         f"executes; --chunk dispatches host-driven "
                         f"chunks — {verb} the unchunked spelling")
    args.device_resolved = _device(args.device)
    if args.mesh and "WORLD_SIZE" in os.environ:
        # Started by torchrun: join its process group, each rank on its
        # own card (or the shared one, under gloo).
        from go_avalanche_tpu_torch.parallel import runtime

        runtime.initialize_runtime("env://", device=args.device,
                                   backend=args.backend)
    if args.mesh:
        from go_avalanche_tpu_torch.parallel.runtime import rank_device

        args.device_resolved = rank_device(args.device_resolved)
    from go_avalanche_tpu_torch.parallel.mesh import world

    args.lead = world()[1] == 0

    # Adversary-knob validation: mirror the config's inert-knob
    # rejections at the parser (the PR 5 rule — the _validate_adversary
    # messages would otherwise surface only at build_config below; these
    # name the flags).
    if args.byzantine == 0.0:
        inert = [flag for flag, bad in (
            ("--flip-probability", args.flip_probability != 1.0),
            ("--adversary", args.adversary
             != AdversaryStrategy.FLIP.value),
            ("--adversary-policy", args.adversary_policy != "off"),
            ("--adversary-margin", args.adversary_margin != 1),
        ) if bad]
        if inert:
            parser.error(
                f"{'/'.join(inert)} set with --byzantine 0: with no "
                f"byzantine nodes every adversary knob is inert and "
                f"would mislabel the run as attacked — set "
                f"--byzantine > 0")
    if (args.adversary_policy != "off"
            and args.model in ("slush", "snowflake")):
        parser.error(
            f"--adversary-policy needs a round body carrying the "
            f"policy context (models snowball/avalanche/dag/backlog/"
            f"streaming_dag/node_stream); the family models "
            f"(slush/snowflake) predate it — got {args.model}")

    # Round-engine validation: the megakernel fuses the dense avalanche
    # SYNCHRONOUS round only (ops/megakernel.py).  Mirror the config's
    # _validate_round_engine rejections at the parser (the PR 5 rule)
    # so the flags are named instead of the config fields.
    if getattr(args, "round_engine", "phased") != "phased":
        if args.model != "avalanche":
            parser.error(
                f"--round-engine megakernel is wired for --model "
                f"avalanche (the dense synchronous round); {args.model} "
                f"keeps the phased path — the knob would be inert")
        if args.latency_mode != "none" or args.partition:
            parser.error(
                "--round-engine megakernel covers the synchronous "
                "round only; --latency-mode/--partition deliver votes "
                "ACROSS rounds through the in-flight ring, outside the "
                "one fused program — run the async lanes on the "
                "phased engine")
        if args.inflight_engine != "walk":
            parser.error(
                "--inflight-engine selects the async ring's delivery "
                "engine; --round-engine megakernel never builds the "
                "ring — the knob would be silently inert")
        if args.skip_absent_votes:
            parser.error(
                "--skip-absent-votes selects the MAJORITY-threshold "
                "ingest; the megakernel fuses the SEQUENTIAL window "
                "ingest — run the majority A/B on the phased engine")
        if args.vote_mode != VoteMode.SEQUENTIAL.value:
            parser.error(
                f"--round-engine megakernel fuses the SEQUENTIAL "
                f"window ingest; --vote-mode {args.vote_mode} keeps "
                f"the phased path")
        if args.adversary_policy != "off":
            parser.error(
                "--adversary-policy reads per-round context planes the "
                "fused program does not thread; run the adaptive-"
                "adversary lanes on the phased engine")
        if (args.byzantine > 0
                and args.adversary == AdversaryStrategy.EQUIVOCATE.value):
            parser.error(
                "--adversary equivocate draws per-draw coin streams "
                "the fused program cannot replay in-kernel; run it on "
                "the phased engine")
        if args.mesh:
            parser.error(
                "--round-engine megakernel is the single-device dense "
                "lane; the --mesh drivers keep the phased path "
                "(parallel/sharded.py rejects the knob)")
        if args.fleet is not None or args.fleet_shape is not None:
            parser.error(
                "--round-engine megakernel is the single-sim dense "
                "lane; the fleet drivers keep the phased path")
        if args.txs % 32:
            parser.error(
                f"--round-engine megakernel needs --txs divisible by "
                f"32 (whole bit-packed preference words), got "
                f"{args.txs}")

    # Fleet-mode validation: everything parser-level (the PR 5 rule).
    args.phase_grid_parsed = None
    args.fleet_mesh = None
    if args.fleet_shape is not None:
        # Knee-table fleet sizing (obs/knee.py): the profile of the run's
        # device, then PICK F (no --fleet: the deepest trials-per-device
        # row whose knee fits --nodes/--txs, times the mesh's device
        # count) or VALIDATE --fleet (a shape above the knee is refused
        # here with the table row cited).
        from go_avalanche_tpu_torch.obs.knee import select_fleet_shape

        mesh_devices = 1
        if args.mesh:
            try:
                a_s, b_s = args.mesh.split(",")
                mesh_devices = int(a_s) * int(b_s)
            except ValueError:
                parser.error(f"--mesh must be A,B shards, got "
                             f"{args.mesh!r}")
        try:
            sel = select_fleet_shape(args.device_resolved.type,
                                     mesh_devices, args.nodes, args.txs,
                                     fleet=args.fleet)
        except ValueError as e:
            parser.error(str(e))
        if args.fleet is None:
            args.fleet = sel["fleet"]
    if args.fleet is not None:
        if args.fleet < 1:
            parser.error(f"--fleet must be >= 1 trials, got {args.fleet}")
        if args.model not in ("snowball", "avalanche", "dag", "backlog"):
            parser.error(f"--fleet supports models snowball/avalanche/"
                         f"dag/backlog, not {args.model}")
        if args.mesh:
            # --mesh A,B lays the trial axis over A*B ranks, each
            # running F/(A*B) whole sims (parallel/sharded_fleet.py).
            from go_avalanche_tpu_torch.parallel import sharded_fleet

            try:
                a_s, b_s = args.mesh.split(",")
                args.fleet_mesh = sharded_fleet.make_fleet_mesh(
                    int(a_s), int(b_s))
                sharded_fleet.check_fleet_divisible(args.fleet,
                                                    args.fleet_mesh)
            except ValueError as e:
                parser.error(f"--fleet x --mesh: {e}")
            if args.donate:
                parser.error(
                    "--donate tunes the sharded single-sim drivers; "
                    "the sharded fleet driver's input is the per-trial "
                    "key plane (nothing worth donating — the bench "
                    "lane's state-scan program donates instead)")
        if args.check_invariants:
            parser.error("--check-invariants steps ONE sim on the host; "
                         "it has no per-trial identity under --fleet")
        if args.model == "dag" and args.txs % args.conflict_size:
            parser.error(f"--fleet dag needs --txs ({args.txs}) divisible "
                         f"by --conflict-size ({args.conflict_size})")
    if args.phase_grid is not None:
        if args.fleet is None:
            parser.error("--phase-grid requires --fleet (a grid point "
                         "IS a fleet)")
        from go_avalanche_tpu_torch.fleet import phase_points

        try:
            if os.path.exists(args.phase_grid):
                with open(args.phase_grid) as fh:
                    grid = json.load(fh)
            else:
                grid = json.loads(args.phase_grid)
        except (OSError, json.JSONDecodeError) as e:
            parser.error(f"--phase-grid: {e}")
        try:
            phase_points(grid)   # full validation; points re-expand later
        except (ValueError, TypeError) as e:
            parser.error(f"--phase-grid: {e}")
        if "latency_rounds" in grid and args.latency_mode == "none":
            parser.error("--phase-grid sweeps latency_rounds but "
                         "--latency-mode is 'none', under which the "
                         "knob is inert — every point would measure "
                         "the same program")
        if "stake_zipf_s" in grid and args.stake_mode != "zipf":
            parser.error("--phase-grid sweeps stake_zipf_s but "
                         "--stake-mode is not 'zipf' (the exponent is "
                         "only read there) — stake-concentration "
                         "sweeps need the zipf distribution")
        if "arrival_rate" in grid:
            if args.arrival_mode == "off":
                parser.error("--phase-grid sweeps arrival_rate but "
                             "--arrival-mode is 'off', under which the "
                             "knob is inert — offered-load sweeps need "
                             "a live-traffic schedule")
            if args.model != "backlog":
                parser.error("an arrival_rate phase axis needs "
                             "--model backlog (the fleet's streaming "
                             "model with the traffic plane)")
        args.phase_grid_parsed = grid

    if args.arrival_mode != "off" and args.model not in ("backlog",
                                                         "streaming_dag"):
        parser.error(f"--arrival-* is a streaming-scheduler axis "
                     f"(models backlog/streaming_dag — they admit from "
                     f"a backlog as slots retire), not {args.model}")
    if args.arrival_mode == "external":
        parser.error("--arrival-mode external has no push path in "
                     "run_sim (arrivals come only from "
                     "traffic.push_arrivals — the Connector SIM_SUBMIT "
                     "message): the stream would stay empty for "
                     "--max-rounds.  Use a schedule mode here, or "
                     "drive an external stream through "
                     "connector.client.sim_submit")
    # Stake / node-registry validation: everything parser-level (the
    # PR 5 rule — a bad stake config must die here, not in the worker).
    args.stake_weights_parsed = None
    if args.stake_weights is not None:
        try:
            args.stake_weights_parsed = tuple(
                float(x) for x in args.stake_weights.split(","))
        except ValueError:
            parser.error(f"--stake-weights must be comma-separated "
                         f"numbers, got {args.stake_weights!r}")
    if args.stake_mode != "off" and args.model in ("slush", "snowflake",
                                                   "snowball"):
        parser.error(f"--stake-mode is a peer-draw-dispatch axis "
                     f"(models avalanche/dag/backlog/streaming_dag/"
                     f"node_stream); the {args.model} model samples "
                     f"uniformly, so a stake config would be silently "
                     f"inert there")
    if args.model == "node_stream":
        if args.registry_nodes <= 0 or args.active_nodes <= 0:
            parser.error("--model node_stream streams --active-nodes "
                         "resident rows out of a --registry-nodes "
                         "population — both must be set (> 0)")
    elif args.registry_nodes or args.active_nodes or args.node_churn_rate:
        parser.error("--registry-nodes/--active-nodes/"
                     "--node-churn-rate are node-stream scheduler axes "
                     "(--model node_stream); with other models they "
                     "would be silently inert")
    args.arrival_cluster_weights_parsed = None
    if args.arrival_cluster_weights is not None:
        try:
            args.arrival_cluster_weights_parsed = tuple(
                float(x) for x in args.arrival_cluster_weights.split(","))
        except ValueError:
            parser.error(f"--arrival-cluster-weights must be "
                         f"comma-separated numbers, got "
                         f"{args.arrival_cluster_weights!r}")
    args.arrival_backpressure_parsed = None
    if args.arrival_backpressure is not None:
        try:
            lo_s, hi_s = args.arrival_backpressure.split(",")
            args.arrival_backpressure_parsed = (float(lo_s), float(hi_s))
        except ValueError:
            parser.error(f"--arrival-backpressure must be LO,HI "
                         f"occupancy fractions (e.g. 0.7,0.9), got "
                         f"{args.arrival_backpressure!r}")

    if (args.mesh and args.fleet is None
            and args.model not in ("avalanche", "dag", "backlog",
                                   "streaming_dag", "node_stream")):
        # Under --fleet the mesh shards the trial axis and every trial
        # runs the dense per-trial program, so every fleet model
        # composes; the single-sim restriction applies without --fleet.
        parser.error(f"--mesh supports models avalanche/dag/backlog/"
                     f"streaming_dag/node_stream, not {args.model}")
    if args.donate and not args.mesh:
        parser.error("--donate is a --mesh option (the single-chip "
                     "avalanche path already donates unconditionally)")
    if args.chunk and args.model != "streaming_dag":
        parser.error("--chunk is a streaming_dag option")
    if args.chunk < 0:
        parser.error("--chunk must be >= 0 (0, the default, disables "
                     "chunking)")
    if args.chunk and args.mesh:
        parser.error("--chunk and --mesh are mutually exclusive (the "
                     "sharded backend has its own dispatch loop)")
    if args.checkpoint and not args.chunk:
        parser.error("--checkpoint requires --chunk")
    if args.check_invariants:
        if args.model not in ("snowball", "avalanche", "dag"):
            parser.error(f"--check-invariants supports models snowball/"
                         f"avalanche/dag, not {args.model}")
        if args.mesh:
            parser.error("--check-invariants is a dense debug mode (the "
                         "sharded while-loop drivers never surface "
                         "intermediate states to the host)")
    # Trace-plane validation (the PR 5 rule: everything parser-level).
    if args.trace_every < 0:
        parser.error("--trace-every must be >= 0 (0 disables the "
                     "on-device trace plane)")
    if args.trace_every:
        if args.model in ("slush", "snowflake"):
            parser.error(f"--trace-every needs a round body carrying "
                         f"the trace plane; the family models "
                         f"(slush/snowflake) predate it — got "
                         f"{args.model}")
        if args.trace_every > args.max_rounds:
            parser.error(f"--trace-every ({args.trace_every}) exceeds "
                         f"--max-rounds ({args.max_rounds}): only round "
                         f"0 would ever be sampled — the stride is "
                         f"inert at this horizon (mirrors "
                         f"obs.trace.alloc)")
        if not (args.metrics or args.trace_out):
            parser.error("--trace-every needs a sink for the decoded "
                         "trace: --metrics PATH (shared) or --trace-out "
                         "PATH (its own file)")
        if args.phase_grid is not None:
            parser.error("--trace-every x --phase-grid is not supported: "
                         "every grid point would decode its own "
                         "[F, S, M] trace into one file with repeating "
                         "rounds — trace single --fleet points instead")
    elif args.trace_out:
        parser.error("--trace-out requires --trace-every (without the "
                     "trace plane there is nothing to decode)")
    if args.metrics:
        if args.model in ("slush", "snowflake"):
            parser.error(f"--metrics needs a round body carrying the "
                         f"in-graph tap; the family models "
                         f"(slush/snowflake) predate it — got "
                         f"{args.model}")
        if (args.mesh and args.fleet is None
                and (args.metrics_every or not args.trace_every)):
            # Fleet runs stream phase rows host-side whatever the mesh,
            # so the sharded-driver tap restriction applies only
            # without --fleet.
            parser.error("--metrics is the dense in-graph tap; sharded "
                         "drivers stream stacked telemetry host-side "
                         "(obs.MetricsSink.write_stacked) — or use "
                         "--trace-every: the trace plane is replicated "
                         "and legal under shard_map")
        if args.metrics_every == 0 and (args.trace_every == 0
                                        or args.trace_out):
            # The historic default: a sink implies the callback tap at
            # stride 1.  With the trace plane selected AND no
            # --trace-out, the --metrics sink serves the decoded trace
            # instead and the callback stays off; with --trace-out the
            # trace has its own file, so a bare --metrics keeps its
            # callback meaning (never an opened-but-empty sink).
            args.metrics_every = 1
        if args.metrics_every and args.trace_every and not args.trace_out:
            parser.error("--metrics-every and --trace-every are two "
                         "taps, one JSONL line per round EACH — an "
                         "interleaved mix in one file would carry "
                         "duplicate rounds under one manifest; give "
                         "the trace plane its own sink with "
                         "--trace-out")
    elif args.metrics_every:
        parser.error("--metrics-every requires --metrics (without a sink "
                     "the tap's records are dropped)")
    # Fault-script / RTT-matrix files parse HERE and the whole config
    # validates HERE: a malformed scenario must die at the parser with
    # the validator's message, never as a worker traceback (the PR 5
    # --metrics-every rule).
    args.fault_script_events = None
    if args.fault_script:
        try:
            with open(args.fault_script) as fh:
                data = json.load(fh)
            args.fault_script_events = fault_script_from_json(data)
        except OSError as e:
            parser.error(f"--fault-script: {e}")
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            parser.error(f"--fault-script {args.fault_script}: {e}")
    args.rtt_matrix_parsed = None
    if args.rtt_matrix:
        try:
            args.rtt_matrix_parsed = _parse_rtt_matrix(args.rtt_matrix)
        except (OSError, json.JSONDecodeError, ValueError, TypeError) as e:
            parser.error(f"--rtt-matrix: {e}")
    if args.phase_grid_parsed is not None:
        # Adversary-axis inert combinations (the fleet's one spelling,
        # fleet.check_adversary_grid) die HERE, not mid-sweep.  Sits
        # after the fault-script parse: the timing-policy check reads
        # `_async_on` (build_config's own derivation).
        from go_avalanche_tpu_torch.fleet import check_adversary_grid

        try:
            check_adversary_grid(
                args.phase_grid_parsed, byz_base=args.byzantine,
                strategy_base=args.adversary,
                flip_base=args.flip_probability,
                policy_base=args.adversary_policy,
                async_base=_async_on(args),
                stake_base=args.stake_mode,
                margin_base=args.adversary_margin)
        except ValueError as e:
            parser.error(f"--phase-grid: {e}")
    try:
        cfg = build_config(args)
    except (ValueError, TypeError) as e:
        # validation arithmetic on a non-numeric JSON value (e.g. a
        # null event field) raises TypeError, not ValueError
        parser.error(str(e))
    if args.fleet is not None:
        # The in-graph tap has no per-trial identity under the fleet
        # vmap; a --metrics sink receives PHASE ROWS host-side instead
        # (each row carries its own point tag, so the sink opens
        # untagged).
        import dataclasses

        cfg = dataclasses.replace(cfg, metrics_every=0)
    return args, cfg


def main(argv=None) -> Dict:
    """Run the flags' simulation, print its result (one JSON line with
    ``--json``; rank 0 only under ``--mesh``) and return the result
    dict."""
    args, cfg = parse_args(argv)
    if args.fleet is not None:
        runner = run_fleet_mode
    else:
        runner = {"slush": run_slush, "snowflake": run_snowflake,
                  "snowball": run_snowball, "avalanche": run_avalanche,
                  "dag": run_dag, "backlog": run_backlog,
                  "streaming_dag": run_streaming_dag,
                  "node_stream": run_node_stream}[args.model]

    ctx = (tracing.trace(args.trace, args.device_resolved) if args.trace
           else contextlib.nullcontext())
    if args.metrics and args.lead:
        from go_avalanche_tpu_torch import obs

        sink_ctx = obs.metrics_sink(
            args.metrics,
            tag="" if args.fleet is not None else obs.config_tag(cfg))
    else:
        sink_ctx = contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx, sink_ctx as sink:
        result = runner(args, cfg)
    extra = {}
    if sink is not None:
        # The sink context drained in-flight callbacks and closed on
        # exit; records_written is final here.
        obs.write_manifest(args.metrics, cfg, extra={
            "model": args.model,
            "workload": {"nodes": args.nodes, "txs": args.txs,
                         "max_rounds": args.max_rounds,
                         "seed": args.seed,
                         **({"fleet": args.fleet}
                            if args.fleet is not None else {})},
            "tag": obs.config_tag(cfg),
        })
        extra = {"metrics_records": sink.records_written,
                 "metrics_file": str(sink.path)}
    result = {
        "model": args.model,
        "nodes": args.nodes,
        "txs": args.txs
        if args.model not in ("snowball", "slush", "snowflake") else 1,
        "backend": args.device_resolved.type,
        **result,
        **extra,
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }
    if not args.lead:
        return result
    if args.json:
        print(json.dumps(result))
    else:
        print(" ".join(f"{k}={v}" for k, v in result.items()))
    return result


def cli(argv=None) -> int:
    """Console-script entry point: results go to stdout, exit status 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
