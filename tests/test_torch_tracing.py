"""The port's tracing helpers (`utils/tracing.py`, `obs/tags.PHASE_SPANS`)
against the JAX package's `utils/tracing.py`.

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
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import snowball as tsb
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
    assert set(outer) == {"poll_mask", "sample_peers", "gossip_admission",
                          "gather_prefs", "ingest_votes", "trace_write"}
    assert all(v > 0 for v in outer.values())
    assert sum(outer.values()) <= wall
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
