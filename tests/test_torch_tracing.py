"""The port's tracing helpers (`utils/tracing.py`, `obs/tags.PHASE_SPANS`)
against the JAX package's `utils/tracing.py`, and the port's own span
log, round spans and counted host reads.

The span registry is the reference's tuple; `annotate` refuses any other
name with the reference's message; `collect_phase_times` times the
port's spans and nests; the two `TelemetryRecorder`s fed the same run's
telemetry (each package's `run_scan` from one state) give equal per-round
series, array for array and dtype for dtype, and equal totals;
`determinism_audit` passes a pure step and names the leaves an impure
one changes (the template of `tests/test_tracing.py`).  Tolerance 0.
"""

import time

import jax
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.obs import tags as jtags
from go_avalanche_tpu.utils import tracing as jtracing
from go_avalanche_tpu_torch import convert, sync
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.models import family as tfam
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from go_avalanche_tpu_torch.obs import tags
from go_avalanche_tpu_torch.utils import tracing
from test_torch_avalanche import _jax_numpy

KNOBS = dict(finalization_score=16)


def _pair(seed=0, **knobs):
    jcfg, tcfg = JaxConfig(**KNOBS, **knobs), AvalancheConfig(**KNOBS, **knobs)
    jstate = jav.init(jax.random.key(seed), 16, 8, jcfg)
    return jstate, convert.state_from_numpy(_jax_numpy(jstate), "cpu"), \
        jcfg, tcfg


def test_phase_spans_are_the_reference_tuple():
    assert tags.PHASE_SPANS == jtags.PHASE_SPANS
    assert not set(tags.PORT_SPANS) & set(tags.PHASE_SPANS)


def test_annotate_refuses_a_name_outside_the_registry():
    with pytest.raises(ValueError) as want:
        jtracing.annotate("poll")
    with pytest.raises(ValueError) as got:
        tracing.annotate("poll")
    assert str(got.value) == str(want.value)
    for name in tags.PHASE_SPANS + tags.PORT_SPANS:
        assert tracing.annotate(name) is tracing._OFF
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for name in tags.PHASE_SPANS + tags.PORT_SPANS:
            assert isinstance(tracing.annotate(name),
                              torch.profiler.record_function)


def test_collect_phase_times_times_the_round_spans_and_nests():
    _, state, _, cfg = _pair(trace_every=1, metrics_every=0)
    state = tav.with_trace(state, cfg, 4)
    t0 = time.perf_counter()
    with tracing.collect_phase_times() as outer:
        state, _ = tav.round_step(state, cfg)
        with tracing.collect_phase_times() as inner:
            with tracing.annotate("fused_round"):
                pass
        state, _ = tav.round_step(state, cfg)
    wall = time.perf_counter() - t0
    assert set(inner) == {"fused_round"}        # not the outer's
    assert set(outer) == {"round"} | set(FLAT_CHILDREN) | {"trace_write"}
    assert all(v > 0 for v in outer.values())
    children = sum(outer[name] for name in set(FLAT_CHILDREN))
    assert children <= outer["round"] <= wall     # spans nest in round
    assert tracing._PHASE_SINK is None            # restored on exit


def _records(jtels, ttels):
    jrec, trec = jtracing.TelemetryRecorder(), tracing.TelemetryRecorder()
    for jt, tt in zip(jtels, ttels):
        jrec.append(jt)
        trec.append(tt)
    jrec.finish()
    trec.finish()
    return jrec, trec


def _assert_recorders_equal(jrec, trec):
    want, got = jrec.per_round(), trec.per_round()
    assert list(got) == list(want)
    for field in want:
        assert got[field].dtype == want[field].dtype, field
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    ws, gs = jrec.summary(), trec.summary()
    assert {k: v for k, v in gs.items() if k.startswith("total_")
            or k == "rounds"} == {k: v for k, v in ws.items()
                                  if k.startswith("total_") or k == "rounds"}
    assert ("votes_per_sec" in gs) == ("votes_per_sec" in ws)


@pytest.mark.parametrize("knobs", [{}, dict(byzantine_fraction=0.25,
                                            gossip=False)],
                         ids=["default", "byzantine_no_gossip"])
def test_recorder_matches_jax_on_one_avalanche_run(knobs):
    jstate, tstate, jcfg, tcfg = _pair(**knobs)
    jstate, jscan = jav.run_scan(jstate, jcfg, n_rounds=10)
    jstate, jone = jav.round_step(jstate, jcfg)
    tstate, tscan = tav.run_scan(tstate, tcfg, n_rounds=10, device="cpu")
    tstate, tone = tav.round_step(tstate, tcfg)
    jrec, trec = _records((jscan, jone), (tscan, tone))
    assert trec.per_round()["polls"].shape == (11,)
    _assert_recorders_equal(jrec, trec)


def test_recorder_matches_jax_on_one_snowball_run():
    jcfg, tcfg = JaxConfig(**KNOBS), AvalancheConfig(**KNOBS)
    jstate = jsb.init(jax.random.key(2), 24, jcfg)
    tstate = convert.family_state_from_numpy("snowball", _jax_numpy(jstate),
                                             "cpu")
    _, jtel = jsb.run_scan(jstate, jcfg, n_rounds=12)
    _, ttel = tsb.run_scan(tstate, tcfg, n_rounds=12, device="cpu")
    _assert_recorders_equal(*_records((jtel,), (ttel,)))


def test_recorder_empty_and_confidence_as_u16():
    rec = tracing.TelemetryRecorder()
    assert rec.per_round() == {}
    assert rec.summary()["rounds"] == 0.0
    from typing import NamedTuple

    class Conf(NamedTuple):
        confidence: torch.Tensor

    rec.append(Conf(torch.tensor([-1, 3], dtype=torch.int16)))
    got = rec.per_round()["confidence"]
    assert got.dtype == np.uint16 and got.tolist() == [0xFFFF, 3]


def test_determinism_audit_passes_for_pure_step():
    _, state, _, cfg = _pair()
    report = tracing.determinism_audit(
        lambda s: tav.round_step(s, cfg)[0], state, n_repeats=3)
    assert report == {"deterministic": True, "mismatches": []}


def test_determinism_audit_catches_impure_step():
    _, state, _, cfg = _pair(trace_every=1)
    state = tav.with_trace(state, cfg, 4)
    counter = {"n": 0}

    def impure(state):
        counter["n"] += 1
        out, tel = tav.round_step(state, cfg)
        return out._replace(round=out.round + counter["n"]), tel

    report = tracing.determinism_audit(impure, state)
    assert not report["deterministic"]
    # keystr paths: [0] is the state of the (state, telemetry) pair.
    assert report["mismatches"] == ["[0].round"]

    def impure_trace(state):
        counter["n"] += 1
        out, tel = tav.round_step(state, cfg)
        trace = out.trace
        return out._replace(trace=type(trace)(
            trace.data + counter["n"], trace.cursor, trace.columns,
            trace.stride)), tel

    # The trace buffer is one leaf: a change to its data names it.
    assert tracing.determinism_audit(impure_trace, state)["mismatches"] \
        == ["[0].trace"]


def test_determinism_audit_structure_and_dtype():
    _, state, _, cfg = _pair()
    flip = {"n": 0}

    def dtype_flip(s):
        flip["n"] += 1
        out = tav.round_step(s, cfg)[0]
        return out._replace(round=out.round.to(
            torch.int32 if flip["n"] % 2 else torch.int64))

    assert tracing.determinism_audit(dtype_flip, state)["mismatches"] == [
        ".round"]

    def shape_flip(s):
        flip["n"] += 1
        return (s.round,) * (1 + flip["n"] % 2)

    assert tracing.determinism_audit(shape_flip, state) == {
        "deterministic": False, "mismatches": ["<structure>"]}


def test_trace_writes_a_profiler_trace(tmp_path):
    _, state, _, cfg = _pair()
    with tracing.trace(str(tmp_path / "trace"), device="cpu"):
        tav.round_step(state, cfg)
    assert list((tmp_path / "trace").glob("*.json"))


# --- The span log, the spans of the DAG round and streaming step, and
# the counted host reads of the run loops (the port's own).

DAG_CHILDREN = ["key_split", "finality", "poll_mask", "sample_peers",
                "responses", "gather_prefs", "ingest_votes", "finality",
                "telemetry"]


FLAT_CHILDREN = ["key_split", "finality", "poll_mask", "sample_peers",
                 "responses", "gossip_admission", "gather_prefs",
                 "ingest_votes", "finality", "telemetry"]


def _flat(n=16, t=32, **knobs):
    cfg = AvalancheConfig(**KNOBS, **knobs)
    key = torch.tensor([7, 8], dtype=torch.int64)
    prior = tav.contested_init_pref_from_key(key, n, t)
    return tav.init(key, n, t, cfg, init_pref=prior, device="cpu"), cfg


def _dag(n=24, t=16, **knobs):
    cfg = AvalancheConfig(**KNOBS, **knobs)
    key = torch.tensor([3, 4], dtype=torch.int64)
    conflict = torch.arange(t, dtype=torch.int32) // 2
    return tdag.init(key, n, conflict, cfg, device="cpu"), cfg


def _stream(**knobs):
    cfg = AvalancheConfig(**KNOBS, **knobs)
    key = torch.tensor([5, 6], dtype=torch.int64)
    scores = torch.arange(64, dtype=torch.int32).reshape(32, 2) % 7
    state = tsd.init(key, 24, 8, tsd.make_set_backlog(scores), cfg,
                     device="cpu")
    return state, cfg


def _children(rows, parent):
    return [r.name for r in rows if r.parent == parent]


def test_span_log_records_the_nesting_of_a_dag_round_and_a_stream_step():
    state, cfg = _dag(trace_every=1)
    state = tdag.with_trace(state, cfg, 4)
    with tracing.span_log() as log:
        state, _ = tdag.round_step(state, cfg)
        tdag.settled(state, cfg)
    rows = log.rows
    assert (rows[0].name, rows[0].parent) == ("round", -1)
    assert _children(rows, 0) == DAG_CHILDREN
    telemetry = [i for i, r in enumerate(rows) if r.name == "telemetry"]
    assert _children(rows, telemetry[0]) == ["trace_write"]
    settled = [i for i, r in enumerate(rows) if r.name == "settled"]
    assert rows[settled[0]].parent == -1
    assert _children(rows, settled[0]) == ["finality"]
    for r in rows:
        assert r.end_ns >= r.start_ns > 0 and r.reads == 0
        if r.parent >= 0:
            outer = rows[r.parent]
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    assert tracing._PHASE_SINK is None

    sstate, scfg = _stream(arrival_mode="poisson", arrival_rate=2.0)
    with tracing.span_log() as log:
        tsd.step(sstate, scfg)
    rows = log.rows
    assert (rows[0].name, rows[0].parent) == ("stream_step", -1)
    assert _children(rows, 0) == ["arrivals", "retire_refill", "round",
                                  "telemetry"]
    refill_row = [i for i, r in enumerate(rows) if r.name == "retire_refill"]
    # One settle test a step (`settle_scan_plain` on the CPU).
    assert _children(rows, refill_row[0]) == ["finality"]
    inner = [i for i, r in enumerate(rows) if r.name == "round"][0]
    assert rows[inner].parent == 0 and _children(rows, inner) == DAG_CHILDREN


@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_span_log_records_the_nesting_of_a_flat_round(engine):
    gossip = engine == "phased"
    state, cfg = _flat(round_engine=engine, gossip=gossip, trace_every=1)
    state = tav.with_trace(state, cfg, 4)
    with tracing.span_log() as log:
        state, _ = tav.round_step(state, cfg)
        tav.all_settled(state, cfg)
    rows = log.rows
    assert (rows[0].name, rows[0].parent) == ("round", -1)
    want = [{"ingest_votes": "fused_round"}.get(name, name) if not gossip
            else name for name in FLAT_CHILDREN
            if gossip or name != "gossip_admission"]
    assert _children(rows, 0) == want
    telemetry = [i for i, r in enumerate(rows) if r.name == "telemetry"]
    assert _children(rows, telemetry[0]) == ["trace_write"]
    settled = [i for i, r in enumerate(rows) if r.name == "settled"]
    assert rows[settled[0]].parent == -1
    assert _children(rows, settled[0]) == ["finality"]
    for r in rows:
        assert r.end_ns >= r.start_ns > 0 and r.reads == 0


def _kineto(prof):
    """``(name, start ns, end ns, is a span)`` of every host event of the
    profiler, on its Unix-epoch clock."""
    from torch.autograd import DeviceType
    names = set(tags.PHASE_SPANS + tags.PORT_SPANS)
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            out.append((e.name(), e.start_ns(), e.end_ns(),
                        e.name() in names))
    return out


@pytest.mark.parametrize("which", ["dag_round", "stream_step",
                                   "flat_round", "flat_megakernel"])
def test_every_op_of_the_round_runs_in_a_named_child_span(which):
    if which == "dag_round":
        state, cfg = _dag(trace_every=1, metrics_every=0)
        state = tdag.with_trace(state, cfg, 4)
        step, top = tdag.round_step, "round"
    elif which.startswith("flat"):
        engine = "phased" if which == "flat_round" else "megakernel"
        state, cfg = _flat(round_engine=engine, trace_every=1,
                           byzantine_fraction=0.25)
        state = tav.with_trace(state, cfg, 4)
        step, top = tav.round_step, "round"
    else:
        state, cfg = _stream(arrival_mode="poisson", arrival_rate=2.0)
        step, top = tsd.step, "stream_step"
    step(state, cfg)                                 # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, cfg)
    events = _kineto(prof)
    (_, s0, e0, _), = [e for e in events if e[0] == top]
    children = [(s, e) for name, s, e, span in events
                if span and name != top and s0 <= s and e <= e0]
    assert children
    ops = [(name, s) for name, s, _, span in events
           if not span and name.startswith("aten::") and s0 <= s <= e0]
    assert ops
    outside = [name for name, s in ops
               if not any(cs <= s <= ce for cs, ce in children)]
    assert outside == []


def test_span_log_rows_join_the_profiler_events():
    state, cfg = _dag()
    tdag.round_step(state, cfg)                      # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span_log() as log:
            state, _ = tdag.round_step(state, cfg)
            tdag.settled(state, cfg)
    spans = [(name, s, e) for name, s, e, span in _kineto(prof) if span]
    spans.sort(key=lambda x: x[1])
    rows = sorted(log.rows, key=lambda r: r.start_ns)
    assert [name for name, _, _ in spans] == [r.name for r in rows]
    slack = 1_000_000                                # 1 ms
    for (name, s, e), row in zip(spans, rows):
        mid = (s + e) // 2
        assert row.start_ns - slack <= mid <= row.end_ns + slack, name


def test_annotate_with_nothing_active_makes_no_record_function(monkeypatch):
    made = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *args, **kwargs):
            made.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    state, cfg = _dag()
    state, _ = tdag.round_step(state, cfg)
    tdag.settled(state, cfg)
    tsd.step(*_stream())
    assert made == []
    assert tracing.annotate("round") is tracing.annotate("init") \
        is tracing._OFF
    with pytest.raises(ValueError, match="unknown phase span"):
        tracing.annotate("rounds")
    with tracing.span_log(), pytest.raises(ValueError):
        tracing.annotate("rounds")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        tracing.annotate("round")
    assert made == [("round",)]


def test_collect_phase_times_is_the_synchronising_span_log():
    state, cfg = _dag()
    with tracing.collect_phase_times() as outer:
        state, _ = tdag.round_step(state, cfg)
        with tracing.span_log(synchronize=True) as inner:
            tdag.settled(state, cfg)
        assert isinstance(tracing._PHASE_SINK, tracing.SpanLog)
        assert tracing._PHASE_SINK.synchronize
    assert tracing._PHASE_SINK is None
    assert set(outer) == {"round"} | set(DAG_CHILDREN)
    assert all(v > 0 for v in outer.values())
    assert outer["round"] >= sum(v for k, v in outer.items()
                                 if k != "round")
    assert set(inner.totals) == {"settled", "finality"}
    assert [r.name for r in inner.rows] == ["settled", "finality"]


@pytest.mark.parametrize("partition", ["detect", "n_sets", "both"])
def test_sync_reads_counts_every_host_read_of_dag_init(partition):
    cfg = AvalancheConfig(**KNOBS)
    key = torch.tensor([3, 4], dtype=torch.int64)
    conflict = torch.arange(16, dtype=torch.int32) // 2
    statics = {"detect": {}, "n_sets": {"n_sets": 8},
               "both": {"n_sets": 8, "set_size": 2}}[partition]
    reads = sync.reads
    with tracing.span_log() as log:
        state = tdag.init(key, 24, conflict, cfg, device="cpu", **statics)
    want = {"detect": 2, "n_sets": 1, "both": 1}[partition]
    assert sync.reads - reads == want
    assert [(r.name, r.reads) for r in log.rows] == [("init", want)]
    assert state.set_size == (None if partition == "n_sets" else 2)


def _rounds_reads(run, state, **kw):
    reads = sync.reads
    out = run(state, device="cpu", **kw)
    return int(out.round if hasattr(out, "round") else out.base.round), \
        sync.reads - reads


def test_sync_reads_counts_every_host_read_of_the_run_loops():
    state, cfg = _dag()
    rounds, reads = _rounds_reads(tdag.run, state, cfg=cfg)
    assert 0 < rounds < 2000 and reads == 2 * rounds + 2  # settled
    rounds, reads = _rounds_reads(tdag.run, state, cfg=cfg, max_rounds=2)
    assert rounds == 2 and reads == 2 * rounds + 1        # at the cap

    _, astate, _, acfg = _pair()
    rounds, reads = _rounds_reads(tav.run, astate, cfg=acfg, max_rounds=3)
    assert reads == 2 * rounds + (1 if rounds == 3 else 2)
    scfg = AvalancheConfig(**KNOBS)
    sstate = tsb.init(torch.tensor([7, 8], dtype=torch.int64), 24, scfg,
                      device="cpu")
    rounds, reads = _rounds_reads(tsb.run, sstate, cfg=scfg, max_rounds=3)
    assert reads == 2 * rounds + (1 if rounds == 3 else 2)
    fstate = tfam.snowflake_init(torch.tensor([9, 10], dtype=torch.int64),
                                 24, scfg, device="cpu")
    rounds, reads = _rounds_reads(tfam.snowflake_run, fstate, cfg=scfg,
                                  max_rounds=3)
    assert reads == 2 * rounds + (1 if rounds == 3 else 2)
