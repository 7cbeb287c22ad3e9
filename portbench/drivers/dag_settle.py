"""Closed loop of conflict-DAG simulations run to settlement, back to
back, as `models/dag.run` runs one: `dag.init`, then `dag.round_step`
with `dag.settled` read after every round, in one host read that also
carries the round's `polls`.

Simulation i takes the key drawn from ``(seed, i)``; simulation 0 warms
up every shape before the window.  The window opens before simulation
1's `init` (users pay it) and closes when the simulation running at the
deadline has settled, so it holds whole simulations.  A traced run first runs `trace.sims`
simulations untraced, then the same simulations (the same keys, so the
same device work) under `torch.profiler`: the first stretch gives the
wall time of that work at its own pace, which `idle_share` holds the
traced device time against, since the profiler slows the host-paced
round by about half.

The check: `check.sims` simulations of the window, drawn from the seed
(reservoir sampling), are run again by the plain reference from their
keys, and every plane of the final state and every counter of every
round must be equal.
"""

from __future__ import annotations

import random

import torch

from portbench import harness, roofline, tracing
from portbench.stats import round_notes
from portbench.compare import (Check, mismatched, rows_to_host,
                               telemetry_mismatches)
from portbench.reference import dag as ref_dag

# Spans whose device time the per-layer metrics read.
SPANS = ("poll_mask", "sample_peers", "gather_prefs", "ingest_votes")


class Port:
    """The program under test: `go_avalanche_tpu_torch.models.dag`."""

    def __init__(self, fields: dict, device):
        from go_avalanche_tpu_torch.models import dag
        self.dag = dag
        self.device = device
        self.cfg = harness.program_config(fields)

    def init(self, words, n, conflict_set):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        return self.dag.init(key, n, conflict_set, self.cfg,
                             device=self.device)

    def round(self, state):
        state, tel = self.dag.round_step(state, self.cfg)
        return state, tel._asdict()

    def settled(self, state):
        return self.dag.settled(state, self.cfg)

    @staticmethod
    def leaves(state) -> dict:
        b = state.base
        return {"votes": b.records.votes, "consider": b.records.consider,
                "confidence": b.records.confidence, "added": b.added,
                "valid": b.valid, "score_rank": b.score_rank,
                "poll_order": b.poll_order,
                "poll_order_inv": b.poll_order_inv,
                "byzantine": b.byzantine, "alive": b.alive,
                "latency_weight": b.latency_weight,
                "finalized_at": b.finalized_at, "round": b.round,
                "key": b.key, "conflict_set": state.conflict_set}


class Reference:
    """The plain reference in the program's place (the control: run it
    with another `vote_mode`)."""

    def __init__(self, fields: dict, device, c: int, **changes):
        self.cfg = {**fields, **changes}
        self.device = device
        self.c = c

    def init(self, words, n, conflict_set):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        return ref_dag.init_settle(key, n, conflict_set.shape[0], self.c,
                                   self.cfg)

    def round(self, state):
        return ref_dag.round_step(state, self.cfg, self.c)

    def settled(self, state):
        return torch.tensor(ref_dag.settled(state, self.cfg, self.c),
                            device=self.device)

    @staticmethod
    def leaves(state) -> dict:
        return state


def read_round(flag, polls) -> tuple:
    """The round's one host read: the settled flag and the polls, as
    Python values (a count never wraps)."""
    vals = torch.stack([flag.to(torch.int64),
                        polls.to(torch.int64)]).tolist()
    return bool(vals[0]), int(vals[1])


def simulate(program, words, n, conflict_set, max_rounds, run, stats,
             keep: bool, traced: bool):
    """One simulation to settlement; appends to `stats`.  Returns
    ``(final state or None, telemetry rows or None, settled)``."""
    clock = run.clock
    with harness.span("portbench.init", traced):
        if traced:
            harness.synchronize(run.device)
            t0 = clock()
        state = program.init(words, n, conflict_set)
        if traced:
            harness.synchronize(run.device)
            stats["init_ms"].append((clock() - t0) * 1e3)
    rows = [] if keep else None
    done = False
    rounds = 0
    while not done and rounds < max_rounds:
        t0 = clock()
        with harness.span("portbench.round", traced):
            state, tel = program.round(state)
            flag = program.settled(state)
        t_enq = clock()
        with harness.span("portbench.read", traced):
            done, polls = read_round(flag, tel["polls"])
        dt = clock() - t0
        rounds += 1
        stats["round_s"].append(dt)
        stats["enqueue_s"].append(t_enq - t0)
        stats["polls"].append(polls)
        if keep:
            rows.append(tel)
    snapshot = None
    if keep:
        snapshot = {k: v.clone() for k, v in program.leaves(state).items()}
    return snapshot, rows, done


def run(run: harness.Run, program=None) -> harness.Outcome:
    n, t, c = run.shape["nodes"], run.shape["txs"], run.shape["set_size"]
    params, tp = run.cell.params, run.cell.traffic
    max_rounds = tp["max_rounds"]
    k = run.fields["k"]
    dev = run.device
    program = program or Port(run.fields, dev)
    # The conflict-set map: contiguous sets of c members.
    conflict_set = torch.arange(t, dtype=torch.int32, device=dev) // c

    stats = {"round_s": [], "polls": [], "init_ms": [], "enqueue_s": []}
    simulate(program, harness.key_words(run.seed, 0), n, conflict_set,
             max_rounds, run, stats, keep=False, traced=False)
    harness.synchronize(dev)
    run.mark("warmup")
    run.after_setup()
    for v in stats.values():
        v.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    rng = random.Random(run.seed)
    t_open = run.clock()
    setup_s = t_open - run.t_start
    pace_s = None
    if run.trace:
        # The traced simulations once untraced: their wall time at pace.
        for sim in range(1, params["trace"]["sims"] + 1):
            simulate(program, harness.key_words(run.seed, sim), n,
                     conflict_set, max_rounds, run, stats, keep=False,
                     traced=False)
        harness.synchronize(dev)
        pace_s = run.clock() - t_open
        for v in stats.values():
            v.clear()
    sample_size = params["check"]["sims"]
    kept = []          # (sim index, snapshot, rows)
    sims = failed = 0
    prof = None
    if run.trace:
        prof = harness.profiler(dev)
        prof.__enter__()
        t_open = run.clock()
    while True:
        sims += 1
        slot = _reservoir_slot(rng, sims, sample_size, len(kept))
        snap, rows, done = simulate(
            program, harness.key_words(run.seed, sims), n, conflict_set,
            max_rounds, run, stats, keep=slot is not None,
            traced=run.trace)
        failed += not done
        if slot is not None:
            entry = (sims, snap, rows)
            if slot == len(kept):
                kept.append(entry)
            else:
                kept[slot] = entry
        elapsed = run.clock() - t_open
        if (sims >= params["trace"]["sims"] if run.trace
                else elapsed >= run.seconds):
            break
    harness.synchronize(dev)
    window_s = run.clock() - t_open
    slice_ = None
    if prof is not None:
        prof.__exit__(None, None, None)
        slice_ = tracing.reduce(
            prof, SPANS, roofline.INGEST_KERNELS,
            tracing.TraceSlice(rounds=len(stats["round_s"]),
                               polls=list(stats["polls"]), nodes=n,
                               records=n * t, card=run.card,
                               window_s=window_s, pace_s=pace_s,
                               init_ms=list(stats["init_ms"])))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = run.clock()
    checks = check(run, kept, conflict_set, max_rounds, failed)
    check_s = run.clock() - t_check
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, round_s=stats["round_s"],
        counters={"votes": k * sum(stats["polls"]), "simulations": sims},
        attempted=sims, failed=failed, memory_peak_bytes=peak,
        checks=checks, trace=slice_,
        notes={"checked_simulations": [i for i, _, _ in kept],
               "check_s": check_s, "pace_s": pace_s,
               **round_notes(stats["round_s"], stats["enqueue_s"]),
               "outside_rounds_s": window_s - sum(stats["round_s"])})


def _reservoir_slot(rng, m, size, held):
    """Where simulation number `m` (from 1) goes in a reservoir of `size`
    holding `held`: a slot index, or None (not kept)."""
    if held < size:
        return held
    j = rng.randrange(m)
    return j if j < size else None


def check(run: harness.Run, kept, conflict_set, max_rounds,
          failed) -> dict:
    """Each kept simulation against the plain reference's run of it."""
    n, t, c = run.shape["nodes"], run.shape["txs"], run.shape["set_size"]
    ref_cfg = dict(run.fields)
    ref_dag.check_config(ref_cfg)
    state_bad = tel_bad = 0
    for index, snap, rows in kept:
        key = torch.tensor(harness.key_words(run.seed, index),
                           dtype=torch.int64, device=run.device)
        ref_state, ref_rows = ref_dag.run_settle(key, n, t, c, ref_cfg,
                                                 max_rounds)
        state_bad += sum(mismatched(snap, ref_state).values())
        tel_bad += telemetry_mismatches(rows_to_host(rows),
                                        rows_to_host(ref_rows))
        del ref_state, ref_rows
    return {"state_mismatch": Check(state_bad, 0),
            "telemetry_mismatch": Check(tel_bad, 0),
            "unsettled_simulations": Check(failed, 0),
            "simulations_checked": Check(len(kept), 1, at_least=True)}
