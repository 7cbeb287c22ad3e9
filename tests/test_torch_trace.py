"""The port's flight recorder in the round loops (`obs/trace.py`,
`obs/sink.py`) against the JAX package's: every model runs from one
state carried over from the JAX `init`, with the metrics tap and the
trace plane on, and

  * the tap's JSONL and `write_trace`'s JSONL are byte-identical to the
    JAX package's files (the JAX tap is an unordered callback, so its
    lines are put in round order first);
  * the trace leaf's data and cursor are equal, its columns equal the
    JAX manifest, the final states equal;
  * a run past the buffer's horizon clamps its last writes to the last
    slot, as `lax.dynamic_update_slice` does;
  * the fleet's ``[F, S, M]`` trace equals the stacked single-sim
    traces, and both `fleet_trace_records` equal the JAX package's.

The node stream's `resident_stake` float column is held within the
2-ulp bound `tests/test_torch_node_stream.py` uses (the port sums in
float64 and rounds once, XLA:CPU sums float32 in its own order), every
other column at tolerance 0; so a node-stream JSONL, whose float field
prints its shortest round-trip digits, cannot be compared byte for
byte.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import fleet as jfleet
from go_avalanche_tpu import obs as jobs
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu.obs import trace as jtrace
from go_avalanche_tpu_torch import convert, fleet as tfleet, obs as tobs
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import backlog as tbl
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.models import node_stream as tns
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from go_avalanche_tpu_torch.obs import trace as ttrace
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_backlog import assert_trees_equal as assert_leaves_equal

TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)
STAKE_ULPS = 2
ROUNDS = 10


def jsonl_in_round_order(path) -> str:
    """A JAX tap file's lines in round order (stable)."""
    lines = path.read_text().splitlines(keepends=True)
    return "".join(sorted(lines, key=lambda ln: json.loads(ln)["round"]))


def run_avalanche(knobs, n=16, t=32):
    jcfg, tcfg = _configs(knobs)
    jstate = jav.init(jax.random.key(1), n, t, jcfg,
                      init_pref=jav.contested_init_pref(1, n, t))
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jstate=jstate,
        tstate=convert.state_from_numpy(_jax_numpy(jstate), device="cpu"),
        jwith=jav.with_trace, twith=tav.with_trace,
        jrun=jav.run_scan,
        trun=lambda s, c, r: tav.run_scan(s, c, r, device="cpu"),
        trace_of=lambda s: s.trace,
        to_numpy=convert.state_to_numpy)


def run_dag(knobs, n=16, t=24):
    jcfg, tcfg = _configs(knobs)
    jstate = jdag.init(jax.random.key(2), n,
                       jnp.arange(t, dtype=jnp.int32) // 2, jcfg,
                       n_sets=t // 2, set_size=2)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jstate=jstate,
        tstate=convert.dag_state_from_numpy(_jax_numpy(jstate),
                                            device="cpu"),
        jwith=jdag.with_trace, twith=tdag.with_trace,
        jrun=jdag.run_scan,
        trun=lambda s, c, r: tdag.run_scan(s, c, r, device="cpu"),
        trace_of=lambda s: s.base.trace,
        to_numpy=convert.dag_state_to_numpy)


def run_snowball(knobs, n=32):
    jcfg, tcfg = _configs(knobs)
    jstate = jsb.init(jax.random.key(3), n, jcfg)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jstate=jstate,
        tstate=convert.family_state_from_numpy(
            "snowball", _jax_numpy(jstate), device="cpu"),
        jwith=jsb.with_trace, twith=tsb.with_trace,
        jrun=lambda s, c, r: jsb.run_scan(s, c, r),
        trun=lambda s, c, r: tsb.run_scan(s, c, r, device="cpu"),
        trace_of=lambda s: s.trace,
        to_numpy=convert.family_state_to_numpy)


def run_backlog(knobs, n=12, b=32, window=8):
    jcfg, tcfg = _configs(knobs)
    jstate = jbl.init(jax.random.key(4), n, window,
                      jbl.make_backlog(jnp.arange(b, dtype=jnp.int32)), jcfg)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jstate=jstate,
        tstate=convert.backlog_state_from_numpy(_jax_numpy(jstate),
                                                device="cpu"),
        jwith=jbl.with_trace, twith=tbl.with_trace,
        jrun=jax.jit(jbl.run_scan, static_argnames=("cfg", "n_rounds")),
        trun=lambda s, c, r: tbl.run_scan(s, c, r, device="cpu"),
        trace_of=lambda s: s.sim.trace,
        to_numpy=convert.backlog_state_to_numpy)


def run_streaming_dag(knobs, n=12, n_sets=10, c=2, w_sets=3):
    jcfg, tcfg = _configs(knobs)
    scores = jax.random.randint(jax.random.key(105), (n_sets, c), 0, 1000)
    jstate = jsd.init(jax.random.key(5), n, w_sets,
                      jsd.make_set_backlog(scores), jcfg)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jstate=jstate,
        tstate=convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                      device="cpu"),
        jwith=jsd.with_trace, twith=tsd.with_trace,
        jrun=jax.jit(jsd.run_scan, static_argnames=("cfg", "n_rounds")),
        trun=lambda s, c, r: tsd.run_scan(s, c, r, device="cpu"),
        trace_of=lambda s: s.dag.base.trace,
        to_numpy=convert.streaming_dag_state_to_numpy)


FLAGSHIP = dict(finalization_score=16, k=8, gossip=False)
MODELS = {
    "avalanche_u8": (run_avalanche, FLAGSHIP),
    "avalanche_swar32": (run_avalanche, dict(FLAGSHIP,
                                             ingest_engine="swar32")),
    "avalanche_megakernel": (run_avalanche, dict(FLAGSHIP,
                                                 round_engine="megakernel")),
    "avalanche_partition": (run_avalanche, dict(
        finalization_score=16, latency_mode="fixed", latency_rounds=1,
        partition_spec=(2, 6, 0.5), **TIMING)),
    "dag": (run_dag, dict(finalization_score=12)),
    "snowball": (run_snowball, dict(finalization_score=12)),
    "backlog": (run_backlog, dict(finalization_score=6)),
    "backlog_arrivals": (run_backlog, dict(finalization_score=6,
                                           arrival_mode="poisson",
                                           arrival_rate=2.0)),
    "streaming_dag": (run_streaming_dag, dict(finalization_score=8)),
}


def run_traced(case, n_rounds, tmp_path, horizon=ROUNDS):
    """Both packages' run of `case` with its taps on, each inside its
    own active sink; returns (jax final, port final, jax tap file, port
    tap file)."""
    js = case.jwith(case.jstate, case.jcfg, horizon)
    ts = case.twith(case.tstate, case.tcfg, horizon)
    assert case.trace_of(ts).columns == tuple(
        (n, k) for n, k in case.trace_of(js).columns)
    jpath, tpath = tmp_path / "jax_tap.jsonl", tmp_path / "port_tap.jsonl"
    tag = tobs.config_tag(case.tcfg)
    assert tag == jobs.tag_from_config(case.jcfg)
    with jobs.metrics_sink(jpath, tag=tag):
        jfinal, _ = case.jrun(js, case.jcfg, n_rounds)
    with tobs.metrics_sink(tpath, tag=tag):
        tfinal, _ = case.trun(ts, case.tcfg, n_rounds)
    return jfinal, tfinal, jpath, tpath


def assert_trees_equal(want, got, where):
    """`test_torch_backlog.assert_trees_equal`, with trace buffers
    compared field by field."""
    if isinstance(got, ttrace.TraceBuffer):
        assert_trace_equal(want, got, where)
    elif hasattr(got, "_fields"):
        for field in got._fields:
            assert_trees_equal(getattr(want, field), getattr(got, field),
                               f"{where}.{field}")
    else:
        assert_leaves_equal(want, got, where)


def assert_trace_equal(jbuf, tbuf, where):
    want = _jax_numpy(jbuf)
    got = ttrace.to_host(tbuf)
    assert got.data.dtype == np.int32 and got.cursor.dtype == np.int32
    np.testing.assert_array_equal(want.data, got.data, err_msg=where)
    np.testing.assert_array_equal(want.cursor, got.cursor, err_msg=where)
    assert (got.columns, got.stride) == (tuple(want.columns), want.stride)


@pytest.mark.parametrize("metrics_every,trace_every", [(1, 1), (2, 3)])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_taps_and_trace_match_jax(tmp_path, model, metrics_every,
                                  trace_every):
    build, knobs = MODELS[model]
    case = build(dict(knobs, metrics_every=metrics_every,
                      trace_every=trace_every))
    jfinal, tfinal, jpath, tpath = run_traced(case, ROUNDS, tmp_path)
    assert tpath.read_text() == jsonl_in_round_order(jpath)
    assert len(tpath.read_text().splitlines()) == -(-ROUNDS
                                                    // metrics_every)
    assert_trace_equal(case.trace_of(jfinal), case.trace_of(tfinal), model)
    assert_trees_equal(_jax_numpy(jfinal), case.to_numpy(tfinal), model)

    jtr, ttr = tmp_path / "jax_trace.jsonl", tmp_path / "port_trace.jsonl"
    with jobs.metrics_sink(jtr) as sink:
        wrote = jtrace.write_trace(sink, case.trace_of(jfinal))
    with tobs.metrics_sink(ttr) as sink:
        assert tobs.write_trace(sink, case.trace_of(tfinal)) == wrote
    assert ttr.read_bytes() == jtr.read_bytes()
    assert wrote == -(-ROUNDS // trace_every)
    assert (ttrace.trace_records(case.trace_of(tfinal))
            == jtrace.trace_records(case.trace_of(jfinal)))


@pytest.mark.parametrize("model,trace_every", [
    ("avalanche_u8", 1), ("avalanche_megakernel", 3), ("snowball", 2),
    ("backlog_arrivals", 1)])
def test_run_past_horizon_clamps_like_jax(tmp_path, model, trace_every):
    """A run two slots past the buffer's horizon: the writes past the
    last slot land on it (`dynamic_update_slice` clamps), the cursor
    counts them all."""
    build, knobs = MODELS[model]
    case = build(dict(knobs, trace_every=trace_every))
    horizon = 2 * trace_every
    n_rounds = horizon + 2 * trace_every
    jfinal, tfinal, _, _ = run_traced(case, n_rounds, tmp_path, horizon)
    got = ttrace.to_host(case.trace_of(tfinal))
    assert got.data.shape[0] == 2 and int(got.cursor) == 4
    assert_trace_equal(case.trace_of(jfinal), case.trace_of(tfinal), model)


@pytest.mark.parametrize("trace_every", [1, 3])
def test_trace_rows_equal_stacked_telemetry(trace_every):
    """The trace rows are the run's own stacked telemetry at every
    stride-th round."""
    build, knobs = MODELS["backlog_arrivals"]
    case = build(dict(knobs, trace_every=trace_every))
    ts = case.twith(case.tstate, case.tcfg, ROUNDS)
    final, tel = case.trun(ts, case.tcfg, ROUNDS)
    rows = ttrace.stacked_telemetry(case.trace_of(final))
    flat = tobs.sink._flatten_telemetry(tel, {})
    assert rows._fields == tuple(flat)
    for name, col in flat.items():
        np.testing.assert_array_equal(getattr(rows, name),
                                      col.numpy()[::trace_every], name)


def test_node_stream_trace_and_tap_match_jax(tmp_path):
    """The node stream's rows: every int column equal, the float column
    `resident_stake` within STAKE_ULPS, and decoded back to a float in
    the tap's JSONL and the trace records alike."""
    # `tests/test_torch_node_stream.py`'s registry (24 nodes, zipf at the
    # default exponent), where the bound is pinned.
    knobs = dict(stake_mode="zipf", registry_nodes=24, active_nodes=8,
                 node_churn_rate=0.3, metrics_every=1, trace_every=1)
    jcfg, tcfg = JaxConfig(**knobs), AvalancheConfig(**knobs)
    jstate = jns.with_trace(jns.init(jax.random.key(6), 4, jcfg), jcfg, 8)
    tstate = tns.with_trace(convert.node_stream_state_from_numpy(
        _jax_numpy(jstate._replace(sim=jstate.sim._replace(trace=None))),
        device="cpu"), tcfg, 8)
    assert tstate.sim.trace.columns == tuple(jstate.sim.trace.columns)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    with jobs.metrics_sink(jpath):
        jfinal, jtel = jax.jit(jns.run_scan,
                               static_argnames=("cfg", "n_rounds"))(
            jstate, jcfg, 8)
    with tobs.metrics_sink(tpath):
        tfinal, ttel = tns.run_scan(tstate, tcfg, 8, device="cpu")
    want = _jax_numpy(jfinal.sim.trace)
    got = ttrace.to_host(tfinal.sim.trace)
    f = [n for n, _ in got.columns].index("resident_stake")
    ints = [j for j in range(len(got.columns)) if j != f]
    np.testing.assert_array_equal(want.data[:, ints], got.data[:, ints])
    np.testing.assert_array_equal(want.cursor, got.cursor)
    assert np.abs(want.data[:, f].astype(np.int64)
                  - got.data[:, f]).max() <= STAKE_ULPS
    jrows = [json.loads(ln) for ln in jsonl_in_round_order(jpath)
             .splitlines()]
    trows = [json.loads(ln) for ln in tpath.read_text().splitlines()]
    recs = ttrace.trace_records(tfinal.sim.trace)
    stake = ttel.resident_stake.numpy()
    for jr, tr, rec in zip(jrows, trows, recs, strict=True):
        assert isinstance(tr["resident_stake"], float)
        assert tr == rec
        assert rec["resident_stake"] == float(stake[rec["round"]])
        assert abs(jr.pop("resident_stake") - tr.pop("resident_stake")) \
            <= STAKE_ULPS * 2.0 ** -23
        assert jr == {k: v for k, v in tr.items()}


def test_scheduler_trace_columns_match_jax():
    for arrivals in (dict(), dict(arrival_mode="poisson",
                                  arrival_rate=2.0)):
        jcfg, tcfg = JaxConfig(**arrivals), AvalancheConfig(**arrivals)
        assert tbl.trace_columns(tcfg) == jbl.trace_columns(jcfg)
        assert tsd.trace_columns(tcfg) == jsd.trace_columns(jcfg)
    assert tav.TRACE_COLUMNS == jav.TRACE_COLUMNS
    assert tsb.TRACE_COLUMNS == jsb.TRACE_COLUMNS
    assert tns.TRACE_COLUMNS == jns.TRACE_COLUMNS


def test_trace_off_leaves_every_state_as_before():
    """trace_every 0: `with_trace` attaches nothing and the rounds carry
    a None leaf, as the reference's do."""
    for name in ("avalanche_u8", "dag", "snowball", "backlog"):
        build, knobs = MODELS[name]
        case = build(knobs)
        ts = case.twith(case.tstate, case.tcfg, ROUNDS)
        assert case.trace_of(ts) is None
        final, _ = case.trun(ts, case.tcfg, 2)
        assert case.trace_of(final) is None


# --------------------------------------------------------- refusals


def test_alloc_and_write_round_refuse_as_jax():
    cfg, jcfg = AvalancheConfig(trace_every=8), JaxConfig(trace_every=8)
    with pytest.raises(ValueError) as jerr:
        jtrace.alloc(jcfg, 5, jav.TRACE_COLUMNS)
    with pytest.raises(ValueError) as terr:
        ttrace.alloc(cfg, 5, tav.TRACE_COLUMNS, "cpu")
    assert str(terr.value) == str(jerr.value)

    cfg, jcfg = AvalancheConfig(trace_every=1), JaxConfig(trace_every=1)
    cols = (("polls", "i"), ("bogus", "i"))
    ttel = tav.SimTelemetry(*([torch.tensor(0, dtype=torch.int32)]
                              * len(tav.SimTelemetry._fields)))
    jtel = jav.SimTelemetry(*([jnp.int32(0)]
                              * len(jav.SimTelemetry._fields)))
    with pytest.raises(ValueError) as jerr:
        jtrace.write_round(jtrace.alloc(jcfg, 4, cols), jcfg, jnp.int32(0),
                           jtel)
    with pytest.raises(ValueError) as terr:
        ttrace.write_round(ttrace.alloc(cfg, 4, cols, "cpu"), cfg,
                           torch.tensor(0), ttel)
    assert str(terr.value) == str(jerr.value)
    # A float leaf under an int column.
    jfl = jtel._replace(polls=jnp.float32(1.5))
    tfl = ttel._replace(polls=torch.tensor(1.5))
    with pytest.raises(ValueError) as jerr:
        jtrace.write_round(jtrace.alloc(jcfg, 4, jav.TRACE_COLUMNS), jcfg,
                           jnp.int32(0), jfl)
    with pytest.raises(ValueError) as terr:
        ttrace.write_round(ttrace.alloc(cfg, 4, tav.TRACE_COLUMNS, "cpu"),
                           cfg, torch.tensor(0), tfl)
    assert str(terr.value) == str(jerr.value)


def test_decoders_refuse_the_wrong_rank_as_jax():
    cfg = AvalancheConfig(trace_every=1)
    single = ttrace.alloc(cfg, 4, tav.TRACE_COLUMNS, "cpu")
    stacked = ttrace.stack_fleet([single, single])
    jsingle = jtrace.alloc(JaxConfig(trace_every=1), 4, jav.TRACE_COLUMNS)
    jstacked = dataclasses.replace(
        jsingle, data=jnp.stack([jsingle.data] * 2),
        cursor=jnp.stack([jsingle.cursor] * 2))
    for tfn, jfn, tbuf, jbuf in (
            (ttrace.trace_records, jtrace.trace_records, stacked, jstacked),
            (ttrace.stacked_telemetry, jtrace.stacked_telemetry, stacked,
             jstacked),
            (ttrace.fleet_trace_records, jtrace.fleet_trace_records, single,
             jsingle)):
        with pytest.raises(ValueError) as jerr:
            jfn(jbuf)
        with pytest.raises(ValueError) as terr:
            tfn(tbuf)
        assert str(terr.value) == str(jerr.value)
    skewed = dataclasses.replace(stacked, cursor=torch.tensor([1, 2]))
    jskewed = dataclasses.replace(jstacked, cursor=jnp.asarray([1, 2]))
    with pytest.raises(ValueError) as jerr:
        jtrace.fleet_trace_records(jskewed)
    with pytest.raises(ValueError) as terr:
        ttrace.fleet_trace_records(skewed)
    assert str(terr.value) == str(jerr.value)


def test_trace_leaf_carries_both_ways():
    build, knobs = MODELS["dag"]
    case = build(dict(knobs, trace_every=2))
    js, _ = case.jrun(case.jwith(case.jstate, case.jcfg, ROUNDS), case.jcfg,
                      5)
    carried = convert.dag_state_from_numpy(_jax_numpy(js), device="cpu")
    assert_trace_equal(js.base.trace, carried.base.trace, "carried")
    back = convert.dag_state_to_numpy(carried).base.trace
    np.testing.assert_array_equal(back.data,
                                  np.asarray(js.base.trace.data))
    # ... and the carried buffer goes on writing as the reference's does.
    jf, _ = case.jrun(js, case.jcfg, 5)
    tf_, _ = case.trun(carried, case.tcfg, 5)
    assert_trace_equal(jf.base.trace, tf_.base.trace, "resumed")


# ------------------------------------------------------------ fleet


FLEET_KNOBS = dict(finalization_score=48, latency_mode="fixed",
                   latency_rounds=1, fault_script=(("partition", 2, 6, 0.5),),
                   trace_every=1, **TIMING)


@pytest.mark.parametrize("model,kw", [
    ("avalanche", dict(n_nodes=16, n_txs=8)),
    ("snowball", dict(n_nodes=24)),
    ("dag", dict(n_nodes=12, n_txs=8)),
    ("backlog", dict(n_nodes=12, n_txs=24, window=8)),
])
def test_fleet_trace_matches_jax(model, kw):
    """The fleet's [F, S, M] buffer equals the JAX fleet's and the
    port's own single-sim traces stacked; both `fleet_trace_records`
    routes equal the JAX package's."""
    jcfg, tcfg = _configs(FLEET_KNOBS)
    fleet, rounds = 3, 9
    want = jfleet.run_fleet(model, jcfg, fleet=fleet, n_rounds=rounds, **kw)
    got = tfleet.run_fleet(model, tcfg, fleet=fleet, n_rounds=rounds,
                           device="cpu", **kw)
    assert got.trace.data.shape == (fleet, rounds, len(got.trace.columns))
    np.testing.assert_array_equal(got.trace.data, np.asarray(want.trace.data))
    np.testing.assert_array_equal(got.trace.cursor,
                                  np.asarray(want.trace.cursor))
    assert got.trace_records() == want.trace_records()
    assert (tfleet.fleet_trace_records(got.telemetry, fleet)
            == jfleet.fleet_trace_records(want.telemetry, fleet))
    if model == "avalanche":
        keys = prng.split(prng.key(0, "cpu"), fleet)
        for i in range(fleet):
            st = tav.with_trace(tav.init(
                keys[i], 16, 8, tcfg,
                init_pref=tav.contested_init_pref_from_key(keys[i], 16, 8),
                device="cpu"), tcfg, rounds)
            fin, _ = tav.run_scan(st, tcfg, rounds, device="cpu")
            np.testing.assert_array_equal(got.trace.data[i],
                                          fin.trace.data.numpy())
