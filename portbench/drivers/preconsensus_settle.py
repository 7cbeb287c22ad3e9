"""Closed loop of flat pre-consensus simulations run to settlement, back
to back, as `models/avalanche.run` runs one: `avalanche.init` from a
50/50 split (`contested_init_pref_from_key`), then
`avalanche.round_step` with `avalanche.all_settled` read after every
round, in one host read that also carries the round's `polls`.

Simulation i takes the key drawn from ``(seed, i)``; simulation 0 warms
up every shape before the window.  The window opens before simulation
1's `init` (users pay for the priors' draw and the fresh planes) and
closes when the simulation running at the deadline has settled, so it
holds whole simulations.  A traced run first runs `trace.sims`
simulations untraced, then the same simulations under `torch.profiler`
(the wall time of the first stretch is `pace_s`), as
`drivers/dag_settle.py` does; the trace reads the megakernel by its
symbol.

The check: `check.sims` simulations of the window, drawn from the seed
(reservoir sampling), are run again by the plain reference
(`reference/avalanche.py`) from their keys, and every plane of the final
state and every counter of every round must be equal.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from portbench import harness, roofline_megakernel, tracing
from portbench.compare import (Check, mismatched, rows_to_host,
                               telemetry_mismatches)
from portbench.drivers.dag_settle import _reservoir_slot, simulate
from portbench.reference import avalanche as ref_av
from portbench.stats import round_notes

# Spans whose device time the per-layer metrics read.
SPANS = ("poll_mask", "sample_peers", "gather_prefs", "fused_round",
         "finality")


@dataclass
class FlatTraceSlice(tracing.TraceSlice):
    """A traced window of the flat round: the `TraceSlice` with the
    round's k, which the megakernel's bytes depend on."""

    k: int = 0


class Port:
    """The program under test: `go_avalanche_tpu_torch.models.avalanche`."""

    def __init__(self, fields: dict, device):
        from go_avalanche_tpu_torch.models import avalanche
        self.av = avalanche
        self.device = device
        self.cfg = harness.program_config(fields)

    def init(self, words, n, t):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        prior = self.av.contested_init_pref_from_key(key, n, t)
        return self.av.init(key, n, t, self.cfg, init_pref=prior,
                            device=self.device)

    def round(self, state):
        state, tel = self.av.round_step(state, self.cfg)
        return state, tel._asdict()

    def settled(self, state):
        return self.av.all_settled(state, self.cfg)

    @staticmethod
    def leaves(state) -> dict:
        return {"votes": state.records.votes,
                "consider": state.records.consider,
                "confidence": state.records.confidence,
                "added": state.added, "valid": state.valid,
                "score_rank": state.score_rank,
                "poll_order": state.poll_order,
                "poll_order_inv": state.poll_order_inv,
                "byzantine": state.byzantine, "alive": state.alive,
                "latency_weight": state.latency_weight,
                "finalized_at": state.finalized_at, "round": state.round,
                "key": state.key}


class Reference:
    """The plain reference in the program's place (the control: run it
    with another `vote_mode`).  `c` is the configuration's set size, 1:
    every tx is its own decision."""

    def __init__(self, fields: dict, device, c: int = 1, **changes):
        if c != 1:
            raise ValueError(f"the flat round has one-tx sets, not {c}")
        self.cfg = {**fields, **changes}
        self.device = device

    def init(self, words, n, t):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        return ref_av.init_settle(key, n, t, self.cfg)

    def round(self, state):
        return ref_av.round_step(state, self.cfg)

    def settled(self, state):
        return torch.tensor(ref_av.settled(state, self.cfg),
                            device=self.device)

    @staticmethod
    def leaves(state) -> dict:
        return state


def run(run: harness.Run, program=None) -> harness.Outcome:
    n, t = run.shape["nodes"], run.shape["txs"]
    if run.shape["set_size"] != 1:
        raise ValueError("the flat round runs one-tx sets (set_size 1)")
    params, tp = run.cell.params, run.cell.traffic
    max_rounds = tp["max_rounds"]
    k = run.fields["k"]
    dev = run.device
    program = program or Port(run.fields, dev)

    stats = {"round_s": [], "polls": [], "init_ms": [], "enqueue_s": []}
    simulate(program, harness.key_words(run.seed, 0), n, t, max_rounds,
             run, stats, keep=False, traced=False)
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
            simulate(program, harness.key_words(run.seed, sim), n, t,
                     max_rounds, run, stats, keep=False, traced=False)
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
            program, harness.key_words(run.seed, sims), n, t, max_rounds,
            run, stats, keep=slot is not None, traced=run.trace)
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
            prof, SPANS, (roofline_megakernel.KERNEL,),
            FlatTraceSlice(rounds=len(stats["round_s"]),
                           polls=list(stats["polls"]), nodes=n,
                           records=n * t, card=run.card,
                           window_s=window_s, pace_s=pace_s,
                           init_ms=list(stats["init_ms"]), k=k))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = run.clock()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    checks = check(run, kept, max_rounds, failed)
    check_s = run.clock() - t_check
    check_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, round_s=stats["round_s"],
        counters={"votes": k * sum(stats["polls"]), "simulations": sims},
        attempted=sims, failed=failed, memory_peak_bytes=peak,
        checks=checks, trace=slice_,
        notes={"checked_simulations": [i for i, _, _ in kept],
               "check_s": check_s, "check_peak_bytes": check_peak,
               "pace_s": pace_s,
               **round_notes(stats["round_s"], stats["enqueue_s"]),
               "outside_rounds_s": window_s - sum(stats["round_s"])})


def check(run: harness.Run, kept, max_rounds, failed) -> dict:
    """Each kept simulation against the plain reference's run of it."""
    n, t = run.shape["nodes"], run.shape["txs"]
    ref_cfg = dict(run.fields)
    ref_av.check_config(ref_cfg)
    state_bad = tel_bad = 0
    for index, snap, rows in kept:
        key = torch.tensor(harness.key_words(run.seed, index),
                           dtype=torch.int64, device=run.device)
        ref_state, ref_rows = ref_av.run_settle(key, n, t, ref_cfg,
                                                max_rounds)
        state_bad += sum(mismatched(snap, ref_state).values())
        tel_bad += telemetry_mismatches(rows_to_host(rows),
                                        rows_to_host(ref_rows))
        del ref_state, ref_rows
    return {"state_mismatch": Check(state_bad, 0),
            "telemetry_mismatch": Check(tel_bad, 0),
            "unsettled_simulations": Check(failed, 0),
            "simulations_checked": Check(len(kept), 1, at_least=True)}
