"""The streaming conflict DAG in steady state, as `models/streaming_dag.run`
drives it: `streaming_dag.step` with one host read a step, which carries
the step's `retired_sets` and its round's `polls`.

Set-up builds the backlog from the benchmark's scores
(`streaming_dag.make_set_backlog`), the window (`streaming_dag.init`) and
steps until the first sets have retired, so the window opens in steady
state.  A segment is the steps from one retiring step (exclusive) to
the next (inclusive).  The window closes at the end of the segment
running at the deadline, so it holds whole segments; a traced window
holds `trace.steps` steps, then closes the same way.

The check, by the plain reference, which never takes the program's
state: (1) its initial state from the same scores and key equals the
program's; (2) it runs the set-up's steps from there and must reach the
program's state at the window's opening, counter for counter; (3) it
runs on through the window's steps to the end of segment j, drawn from
the seed among the first `check.segments_from`, and every counter of
every step and the state at that segment's end must be equal; (4) for
the rest of the window, which it does not replay, the program's final
state must hold the round key the reference's key chain reaches after
every step, the backlog planes as the reference made them, every
admitted set exactly once (retired, or in the window), as many retired
sets as the steps' counters say, and exactly one accepted member in
every retired set.
"""

from __future__ import annotations

import random

import torch

from portbench import harness, roofline, tracing
from portbench.compare import (Check, mismatched, rows_to_host,
                               telemetry_mismatches)
from portbench.drivers import dag_settle
from portbench.reference import dag as ref_dag
from portbench.reference import stream as ref_stream
from portbench.stats import round_notes

SPANS = ("retire_refill", "poll_mask", "sample_peers", "gather_prefs",
         "ingest_votes")
STEP_COUNTERS = ("retired_sets", "occupied_sets", "backlog_left")


class Port:
    """The program under test: `go_avalanche_tpu_torch.models.streaming_dag`."""

    def __init__(self, fields: dict, device):
        from go_avalanche_tpu_torch.models import streaming_dag
        self.sd = streaming_dag
        self.device = device
        self.cfg = harness.program_config(fields)

    def init(self, words, n, window_sets, scores):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        queue = self.sd.make_set_backlog(scores)
        return self.sd.init(key, n, window_sets, queue, self.cfg,
                            track_finality=True, device=self.device)

    def step(self, state):
        state, tel = self.sd.step(state, self.cfg)
        row = tel.round._asdict()
        row.update({name: getattr(tel, name) for name in STEP_COUNTERS})
        return state, row

    @staticmethod
    def leaves(state) -> dict:
        out = dag_settle.Port.leaves(state.dag)
        out.update(slot_set=state.slot_set,
                   slot_admit_round=state.slot_admit_round,
                   next_idx=state.next_idx)
        for name in ("score", "init_pref", "valid"):
            out[f"backlog_{name}"] = getattr(state.backlog, name)
        for name in ("settled", "accepted", "accept_votes", "settle_round",
                     "admit_round"):
            out[f"out_{name}"] = getattr(state.outputs, name)
        return out


class Reference:
    """The plain reference in the program's place (the control: run it
    with another `vote_mode`)."""

    def __init__(self, fields: dict, device, c: int, **changes):
        self.cfg = {**fields, **changes}
        self.device = device
        self.c = c

    def init(self, words, n, window_sets, scores):
        key = torch.tensor(words, dtype=torch.int64, device=self.device)
        return ref_stream.init(key, n, window_sets, scores, self.cfg)

    def step(self, state):
        return ref_stream.step(state, self.cfg, self.c)

    @staticmethod
    def leaves(state) -> dict:
        return state


def backlog_scores(run: harness.Run) -> torch.Tensor:
    """The int32 ``[S_b, c]`` member scores, drawn on the device from the
    seed in one call: the benchmark's input to both sides."""
    g = torch.Generator(device=run.device)
    g.manual_seed(run.seed % 2**63)
    shape = (run.shape["backlog_sets"], run.shape["set_size"])
    return torch.randint(0, run.cell.traffic["score_max"], shape,
                         generator=g, device=run.device, dtype=torch.int32)


def _read(tel) -> tuple:
    vals = torch.stack([tel["retired_sets"].to(torch.int64),
                        tel["polls"].to(torch.int64)]).tolist()
    return int(vals[0]), int(vals[1])


def _snapshot(program, state) -> dict:
    return {k: v.clone() for k, v in program.leaves(state).items()}


def run(run: harness.Run, program=None) -> harness.Outcome:
    shape, tp, params = run.shape, run.cell.traffic, run.cell.params
    n, s_w, c = shape["nodes"], shape["window_sets"], shape["set_size"]
    k = run.fields["k"]
    dev = run.device
    clock = run.clock
    program = program or Port(run.fields, dev)
    words = harness.key_words(run.seed)
    scores = backlog_scores(run)
    run.mark("scores")

    state = program.init(words, n, s_w, scores)
    start = _snapshot(program, state)
    harness.synchronize(dev)
    run.mark("init")
    warm_rows = []
    warm_retired = 0
    while not warm_retired and len(warm_rows) < tp["max_warmup_steps"]:
        state, tel = program.step(state)
        warm_rows.append(tel)
        warm_retired = _read(tel)[0]
    opening = _snapshot(program, state)
    harness.synchronize(dev)
    run.mark("warmup")
    run.after_setup()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # The segment the reference replays to: drawn from the seed.
    sample_at = random.Random(run.seed).randint(
        1, params["check"]["segments_from"])
    round_s, enqueue_s, polls, retired = [], [], [], []
    rows = []             # the counters of every step to segment sample_at
    sample_end = None
    segments = 0          # segments completed
    seg_steps = 0
    limit = params["trace"]["steps"] if run.trace else None
    prof = None
    if run.trace:
        prof = harness.profiler(dev)
        prof.__enter__()
    t_open = clock()
    setup_s = t_open - run.t_start
    while True:
        t0 = clock()
        with harness.span("portbench.round", run.trace):
            state, tel = program.step(state)
        t_enq = clock()
        with harness.span("portbench.read", run.trace):
            r, p = _read(tel)
        round_s.append(clock() - t0)
        enqueue_s.append(t_enq - t0)
        polls.append(p)
        retired.append(r)
        seg_steps += 1
        if segments < sample_at:
            rows.append(tel)
        if r > 0:
            seg_steps = 0
            segments += 1
            if segments == sample_at:
                with harness.span("portbench.snapshot", run.trace):
                    sample_end = _snapshot(program, state)
                    harness.synchronize(dev)
            due = (len(round_s) >= limit if run.trace
                   else clock() - t_open >= run.seconds)
            if due and segments >= sample_at:
                break
        elif seg_steps > tp["max_segment_steps"]:
            break
    harness.synchronize(dev)
    window_s = clock() - t_open
    slice_ = None
    if prof is not None:
        prof.__exit__(None, None, None)
        slice_ = tracing.reduce(
            prof, SPANS, roofline.INGEST_KERNELS,
            tracing.TraceSlice(rounds=len(round_s), polls=list(polls),
                               nodes=n, records=n * s_w * c, card=run.card,
                               window_s=window_s))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    final = program.leaves(state)
    del state, program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = clock()
    checks = check(run, words, scores, start, warm_rows, opening,
                   rows, sample_end, final,
                   steps=len(warm_rows) + len(round_s),
                   retired_total=warm_retired + sum(retired))
    check_s = clock() - t_check
    checks["setup_retired_sets"] = Check(warm_retired, 1, at_least=True)
    sets = sum(retired)
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, round_s=round_s,
        counters={"votes": k * sum(polls), "retired_sets": sets,
                  "settled_txs": c * sets, "segments": segments,
                  "warmup_steps": len(warm_rows)},
        attempted=sets, failed=checks["one_winner_violations"].value,
        memory_peak_bytes=peak, checks=checks, trace=slice_,
        notes={"window_ends_on_retirement": retired[-1] > 0,
               "checked_segment": sample_at, "check_s": check_s,
               **round_notes(round_s, enqueue_s),
               "outside_rounds_s": window_s - sum(round_s)})


def one_winner_violations(leaves: dict) -> int:
    """Retired sets that do not have exactly one accepted member."""
    settled = leaves["out_settled"].any(dim=1)
    winners = (leaves["out_accepted"] & leaves["backlog_valid"]).sum(dim=1)
    return int((settled & (winners != 1)).sum())


def admitted_once_violations(leaves: dict) -> int:
    """Backlog sets not held exactly once, retired or in the window, up
    to `next_idx`, plus sets past it held at all."""
    s_b = leaves["backlog_score"].shape[0]
    held = leaves["out_settled"].any(dim=1).to(torch.int64)
    slots = leaves["slot_set"].long()
    slots = slots[slots != ref_stream.NO_SET]
    held = held.index_add(0, slots, torch.ones_like(slots))
    admitted = int(leaves["next_idx"])
    return (int((held[:admitted] != 1).sum())
            + int((held[admitted:] != 0).sum())
            + int(not 0 <= admitted <= s_b))


def check(run, words, scores, start, warm_rows, opening, rows, sample_end,
          final, steps: int, retired_total: int) -> dict:
    shape = run.shape
    n, s_w, c = shape["nodes"], shape["window_sets"], shape["set_size"]
    cfg = dict(run.fields)
    ref_dag.check_config(cfg)
    key = torch.tensor(words, dtype=torch.int64, device=run.device)

    ref = ref_stream.init(key, n, s_w, scores, cfg)
    init_bad = sum(mismatched(start, ref).values())
    del start
    backlog = {name: ref[name].clone() for name in
               ("backlog_score", "backlog_init_pref", "backlog_valid")}
    ref_rows = []
    for _ in warm_rows:
        ref, tel = ref_stream.step(ref, cfg, c)
        ref_rows.append(tel)
    warm_bad = sum(mismatched(opening, ref).values())
    warm_tel_bad = telemetry_mismatches(rows_to_host(warm_rows),
                                        rows_to_host(ref_rows))
    del opening
    seg_bad = seg_tel_bad = 0
    checked = sample_end is not None
    if checked:
        ref_rows = []
        for _ in rows:
            ref, tel = ref_stream.step(ref, cfg, c)
            ref_rows.append(tel)
        seg_bad = sum(mismatched(sample_end, ref).values())
        seg_tel_bad = telemetry_mismatches(rows_to_host(rows),
                                           rows_to_host(ref_rows))
    del ref, sample_end
    final_key = ref_dag.key_after(key.cpu(), steps)
    retired_rows = int(final["out_settled"].any(dim=1).sum())
    return {"init_mismatch": Check(init_bad, 0),
            "setup_state_mismatch": Check(warm_bad, 0),
            "setup_telemetry_mismatch": Check(warm_tel_bad, 0),
            "segment_state_mismatch": Check(seg_bad, 0),
            "segment_telemetry_mismatch": Check(seg_tel_bad, 0),
            "segments_checked": Check(int(checked), 1, at_least=True),
            "final_key_mismatch": Check(
                sum(mismatched({"key": final["key"]},
                               {"key": final_key}).values()), 0),
            "final_backlog_mismatch": Check(
                sum(mismatched(final, backlog).values()), 0),
            "admitted_once_violations": Check(
                admitted_once_violations(final), 0),
            "retired_count_mismatch": Check(
                abs(retired_rows - retired_total), 0),
            "one_winner_violations": Check(one_winner_violations(final), 0)}
