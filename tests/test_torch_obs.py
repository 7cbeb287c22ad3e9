"""The port's flight recorder off the round loop — the JSONL sink, the
metrics tap's drain, the run manifest, the watchdog, the recovery checker
and `utils/metrics` — against the JAX package's (`go_avalanche_tpu/obs/`,
`go_avalanche_tpu/utils/metrics.py`) on the same seeded inputs: the same
files byte for byte, the same records and reports, the same refusals and
`InvariantViolation` messages.  Tolerance 0.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import fleet as jfleet
from go_avalanche_tpu import obs as jobs
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.obs import manifest as jmanifest
from go_avalanche_tpu.obs import recovery as jrecovery
from go_avalanche_tpu.ops import inflight as jinflight
from go_avalanche_tpu.utils import metrics as jmetrics
from go_avalanche_tpu_torch import convert, sync
from go_avalanche_tpu_torch import fleet as tfleet
from go_avalanche_tpu_torch import obs as tobs
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.obs import manifest as tmanifest
from go_avalanche_tpu_torch.obs import recovery as trecovery
from go_avalanche_tpu_torch.obs import tags
from go_avalanche_tpu_torch.ops import inflight as tinflight
from go_avalanche_tpu_torch.utils import metrics as tmetrics
from test_torch_avalanche import _configs, _jax_numpy

TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)
ASYNC = dict(finalization_score=16, latency_mode="fixed", latency_rounds=1,
             partition_spec=(2, 6, 0.5), **TIMING)


def pair(knobs, n=16, t=8, seed=1, contested=True):
    """(jax state, port state, jax cfg, port cfg) from one JAX init."""
    jcfg, tcfg = _configs(knobs)
    pref = jav.contested_init_pref(seed, n, t) if contested else None
    jstate = jav.init(jax.random.key(seed), n, t, jcfg, init_pref=pref)
    return (jstate, convert.state_from_numpy(_jax_numpy(jstate),
                                             device="cpu"), jcfg, tcfg)


# ------------------------------------------------------------- the sink


def test_sink_writes_jsonl_with_tag_as_jax(tmp_path):
    records = [{"round": 0, "polls": 7}, {"round": 1, "polls": 9,
                                          "frac": 0.625}]
    for mod, name in ((jobs, "j"), (tobs, "t")):
        with mod.metrics_sink(tmp_path / f"{name}.jsonl",
                              tag=", swar32-ingest") as sink:
            for r in records:
                sink.write(dict(r))
        assert sink.records_written == 2
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())
    # Opening truncates: one file is one run's trace.
    with tobs.metrics_sink(tmp_path / "t.jsonl") as sink:
        sink.write({"round": 5})
    assert (tmp_path / "t.jsonl").read_text() == '{"round": 5}\n'


@pytest.mark.parametrize("every,start,stride", [(1, 0, 1), (2, 0, 1),
                                                (3, 4, 3)])
def test_write_stacked_matches_jax(tmp_path, every, start, stride):
    """`write_stacked` of the same run's stacked telemetry: the port's
    tensors and the JAX arrays give byte-identical files, one host copy
    for the port's whole tree."""
    jstate, tstate, jcfg, tcfg = pair(ASYNC)
    _, jtel = jav.run_scan(jstate, jcfg, 7)
    _, ttel = tav.run_scan(tstate, tcfg, 7, device="cpu")
    with jobs.metrics_sink(tmp_path / "j.jsonl") as sink:
        want = sink.write_stacked(jtel, every=every, start_round=start,
                                  round_stride=stride)
    reads = sync.reads
    with tobs.metrics_sink(tmp_path / "t.jsonl") as sink:
        assert sink.write_stacked(ttel, every=every, start_round=start,
                                  round_stride=stride) == want
    assert sync.reads - reads == 1
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())
    for bad in (dict(every=0), dict(round_stride=0)):
        with pytest.raises(ValueError) as jerr:
            jobs.MetricsSink(tmp_path / "x.jsonl").write_stacked(jtel, **bad)
        with pytest.raises(ValueError) as terr:
            tobs.MetricsSink(tmp_path / "y.jsonl").write_stacked(ttel, **bad)
        assert str(terr.value) == str(jerr.value)


def test_tap_rows_wait_on_the_device_until_the_drain(tmp_path):
    """The tap reads nothing back in the round loop: its rows wait in
    the sink, and the drain at the end of `metrics_sink` copies them in
    one counted read and writes the gated rows in round order."""
    cfg = AvalancheConfig(finalization_score=8, metrics_every=2)
    state = tav.init(torch.tensor([0, 1]), 16, 8, cfg, device="cpu")
    path = tmp_path / "tap.jsonl"
    reads = sync.reads
    with tobs.metrics_sink(path) as sink:
        state, tel = tav.run_scan(state, cfg, 7, device="cpu")
        assert sync.reads == reads and len(sink._pending) == 7
        assert path.read_text() == ""
    assert sync.reads - reads == 1
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["round"] for r in rows] == [0, 2, 4, 6]
    for r in rows:
        for f in tel._fields:
            assert r[f] == int(getattr(tel, f)[r["round"]]), f
    # flush drains too, and a second drain has nothing left.
    with tobs.metrics_sink(path) as sink:
        tav.run_scan(state, cfg, 2, device="cpu")
        sink.flush()
        assert len(path.read_text().splitlines()) == 1
        assert sink.drain() == 0


def test_tap_without_sink_or_stride_does_nothing(tmp_path):
    cfg = AvalancheConfig(finalization_score=8, metrics_every=1)
    state = tav.init(torch.tensor([0, 1]), 8, 8, cfg, device="cpu")
    final, _ = tav.run_scan(state, cfg, 3, device="cpu")  # no sink
    assert int(final.round) == 3
    with tobs.metrics_sink(tmp_path / "off.jsonl") as sink:
        tav.run_scan(state, dataclasses.replace(cfg, metrics_every=0), 3,
                     device="cpu")
        assert sink._pending == []


def test_tap_preserves_float_fields_as_jax(tmp_path):
    """A float leaf stays a float through the tap, an int leaf an int,
    with the reference's bits."""

    class Tel(tuple):
        _fields = ("frac", "count")
        frac = property(lambda s: s[0])
        count = property(lambda s: s[1])

    jcfg, tcfg = JaxConfig(metrics_every=1), AvalancheConfig(metrics_every=1)
    values = (0.1 + 0.2, 7)
    with jobs.metrics_sink(tmp_path / "j.jsonl"):
        jax.jit(lambda r: (jobs.emit_round(jcfg, r, Tel((
            jnp.float32(values[0]), jnp.int32(values[1])))), r)[1])(
            jnp.int32(3))
    with tobs.metrics_sink(tmp_path / "t.jsonl"):
        tobs.emit_round(tcfg, torch.tensor(3, dtype=torch.int32), Tel((
            torch.tensor(values[0], dtype=torch.float32),
            torch.tensor(values[1], dtype=torch.int32))))
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())


@pytest.mark.parametrize("knobs", [
    dict(metrics_every=1), dict(trace_every=3),
    dict(metrics_every=2, trace_every=5, ingest_engine="swar32"),
    dict(round_engine="megakernel", trace_every=1),
])
def test_tag_tap_fragments_match_tag_from_config(knobs):
    jcfg, tcfg = _configs(knobs)
    assert tags.config_tag(tcfg) == jobs.tag_from_config(jcfg)
    assert ", trace" in tags.config_tag(tcfg) or ", metrics" in \
        tags.config_tag(tcfg)


# ----------------------------------------------------------- manifest


def test_manifest_matches_jax_keys_and_config(tmp_path):
    knobs = dict(ingest_engine="swar32", metrics_every=2, trace_every=3,
                 partition_spec=(2, 6, 0.5), latency_mode="fixed",
                 latency_rounds=1, **TIMING)
    jcfg, tcfg = _configs(knobs)
    want = jmanifest.manifest_dict(jcfg, extra={"tag": ", x"})
    path = tmobs_write(tmp_path, tcfg)
    got = json.loads(path.read_text())
    renamed = {"jax": "torch", "jaxlib": "cuda"}
    assert set(got) == {renamed.get(k, k) for k in want}
    assert got["torch"] == torch.__version__
    assert got["cuda"] == torch.version.cuda
    assert got["hlo_pins"] is None
    assert got["backend"] == got["devices"]["platform"] == "cpu"
    assert got["config"] == json.loads(json.dumps(want["config"]))
    assert got["tap"] == want["tap"]
    assert got["tag"] == ", x"
    assert path == tmanifest.manifest_path_for(tmp_path / "run.jsonl")
    assert (tmanifest.manifest_path_for(tmp_path / "run.jsonl")
            == jmanifest.manifest_path_for(tmp_path / "run.jsonl"))
    for m, t in ((0, 0), (1, 0), (0, 1), (4, 2)):
        jc, tc = _configs(dict(metrics_every=m, trace_every=t))
        assert tmanifest._tap_dict(tc) == jmanifest._tap_dict(jc)


def tmobs_write(tmp_path, cfg):
    return tobs.write_manifest(tmp_path / "run.jsonl", cfg,
                               extra={"tag": ", x"})


# ----------------------------------------------------------- watchdog


def raises_same(jfn, tfn):
    """Both calls raise InvariantViolation with the same message."""
    with pytest.raises(jobs.InvariantViolation) as jerr:
        jfn()
    with pytest.raises(tobs.InvariantViolation) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


def test_watchdog_clean_run_matches_jax():
    """A run checked after every round: the same finalized counts, the
    run's trajectory untouched, one counted read a check."""
    jstate, tstate, jcfg, tcfg = pair(dict(ASYNC, trace_every=2))
    jstate = jav.with_trace(jstate, jcfg, 10)
    tstate = tav.with_trace(tstate, tcfg, 10)
    jwd, twd = jobs.Watchdog(jcfg), tobs.Watchdog(tcfg)
    jstep = jax.jit(lambda s: jav.round_step(s, jcfg)[0])
    for _ in range(8):
        jstate = jstep(jstate)
        tstate, _ = tav.round_step(tstate, tcfg)
        reads = sync.reads
        assert twd.check(tstate) == jwd.check(jstate)
        # records, ring, the round, the ring cut and the trace.
        assert sync.reads - reads == 5
    assert twd.checks == jwd.checks == 8


@pytest.mark.parametrize("score,bump,match", [
    (8, 0, None), (8, 2, "finalization_score"), (0x7FFF, 0, None)])
def test_watchdog_counter_caps_match_jax(score, bump, match):
    """Overshoot within the crossing call's k votes is legal, one more
    bump is corruption; a saturated 0x7FFF counter passes."""
    jstate, tstate, jcfg, tcfg = pair(dict(finalization_score=score))
    word = (min(0x7FFF, score + jcfg.k - 1) << 1) + bump
    if score == 0x7FFF:
        word = 0xFFFF
    jrec = jstate.records._replace(confidence=jnp.full_like(
        jstate.records.confidence, jnp.uint16(word)))
    trec = convert.state_from_numpy(_jax_numpy(jstate._replace(
        records=jrec)), device="cpu").records
    if match is None:
        assert (tobs.check_records(trec, tcfg)
                == jobs.check_records(jrec, jcfg))
    else:
        msg = raises_same(lambda: jobs.check_records(jrec, jcfg),
                          lambda: tobs.check_records(trec, tcfg))
        assert match in msg and "offender(s)" in msg


@pytest.mark.parametrize("plane", ["votes", "consider"])
def test_watchdog_window_bits_match_jax(plane):
    jstate, tstate, jcfg, tcfg = pair(dict(window=4, quorum=3))
    rng = np.random.default_rng(0)
    dirty = np.asarray(getattr(jstate.records, plane)).copy()
    for r, c in zip(rng.integers(0, 16, 7), rng.integers(0, 8, 7)):
        dirty[r, c] |= 0x10                      # a bit above window 4
    jrec = jstate.records._replace(**{plane: jnp.asarray(dirty)})
    trec = tstate.records._replace(**{plane: torch.from_numpy(dirty)})
    msg = raises_same(lambda: jobs.check_records(jrec, jcfg),
                      lambda: tobs.check_records(trec, tcfg))
    assert "window" in msg and "(+" in msg


def test_watchdog_ring_latency_and_padding_match_jax():
    jcfg, tcfg = _configs(dict(ASYNC, inflight_engine="coalesced"))
    n, t = 8, 12            # t=12: the packed plane has 4 padding bits
    jring = jinflight.init_ring(jcfg, n, t)
    tring = tinflight.init_ring(tcfg, n, t, device="cpu")
    jobs.check_ring(jring, jcfg, t=t)
    tobs.check_ring(tring, tcfg, t=t)
    late = jcfg.timeout_rounds() + 1
    raises_same(
        lambda: jobs.check_ring(jring._replace(
            lat=jring.lat.at[0, 3, 1].set(late)), jcfg, t=t),
        lambda: tobs.check_ring(tring._replace(
            lat=tring.lat.index_put((torch.tensor(0), torch.tensor(3),
                                     torch.tensor(1)),
                                    torch.tensor(late, dtype=torch.int32))),
                                tcfg, t=t))
    assert tring.polled.dtype == torch.uint8
    padded = tring.polled.clone()
    padded[..., -1] = 0x80
    raises_same(
        lambda: jobs.check_ring(jring._replace(
            polled=jring.polled.at[..., -1].set(jnp.uint8(0x80))), jcfg,
            t=t),
        lambda: tobs.check_ring(tring._replace(polled=padded), tcfg, t=t))
    deep = jinflight.init_ring(dataclasses.replace(
        jcfg, request_timeout_s=5.0), n, t)
    raises_same(lambda: jobs.check_ring(deep, jcfg, t=t),
                lambda: tobs.check_ring(tinflight.init_ring(
                    dataclasses.replace(tcfg, request_timeout_s=5.0), n, t,
                    device="cpu"), tcfg, t=t))


def test_watchdog_finalized_monotonicity_matches_jax():
    jstate, tstate, jcfg, tcfg = pair(dict(finalization_score=8))
    fin = np.full(np.asarray(jstate.records.confidence).shape, 8 << 1,
                  np.uint16)
    jfin = jstate._replace(records=jstate.records._replace(
        confidence=jnp.asarray(fin)))
    tfin = convert.state_from_numpy(_jax_numpy(jfin), device="cpu")
    jwd, twd = jobs.Watchdog(jcfg), tobs.Watchdog(tcfg)
    assert twd.check(tfin) == jwd.check(jfin)
    raises_same(lambda: jwd.check(jstate), lambda: twd.check(tstate))
    # monotonic=False (streaming refills) accepts the same sequence.
    twd2 = tobs.Watchdog(tcfg, monotonic=False)
    twd2.check(tfin)
    twd2.check(tstate)


def test_watchdog_ring_cut_matches_jax():
    """A deliverable latency planted on a draw severed by the active
    partition: the host re-derivation of the cut names the same slot and
    offenders."""
    jstate, tstate, jcfg, tcfg = pair(dict(ASYNC, finalization_score=48),
                                      n=32, t=8)
    jstep = jax.jit(lambda s: jav.round_step(s, jcfg)[0])
    for _ in range(4):                      # the cut is live from round 2
        jstate = jstep(jstate)
        tstate, _ = tav.round_step(tstate, tcfg)
    jobs.check_ring_cut(jstate.inflight, jcfg, 4, n_global=32)
    tobs.check_ring_cut(tstate.inflight, tcfg, 4, n_global=32)
    peers = np.asarray(jstate.inflight.peers)
    slot = 3 % peers.shape[0]
    q = 0                                   # querier 0 sits below the split
    d = int(np.argmax(peers[slot, q] >= 16))
    assert peers[slot, q, d] >= 16
    jring = jstate.inflight._replace(
        lat=jstate.inflight.lat.at[slot, q, d].set(0))
    tlat = tstate.inflight.lat.clone()
    tlat[slot, q, d] = 0
    tring = tstate.inflight._replace(lat=tlat)
    msg = raises_same(
        lambda: jobs.check_ring_cut(jring, jcfg, 4, n_global=32),
        lambda: tobs.check_ring_cut(tring, tcfg, 4, n_global=32))
    assert "across an active cut" in msg


def test_watchdog_trace_cursor_and_zero_slots_match_jax():
    jstate, tstate, jcfg, tcfg = pair(dict(finalization_score=64,
                                           trace_every=2), n=8, t=8)
    jstate = jav.with_trace(jstate, jcfg, 10)
    tstate = tav.with_trace(tstate, tcfg, 10)
    jstep = jax.jit(lambda s: jav.round_step(s, jcfg)[0])
    for _ in range(5):
        jstate = jstep(jstate)
        tstate, _ = tav.round_step(tstate, tcfg)
    tobs.check_trace(tstate.trace, tcfg, 5)
    raises_same(
        lambda: jobs.check_trace(dataclasses.replace(
            jstate.trace, cursor=jstate.trace.cursor + 1), jcfg, 5),
        lambda: tobs.check_trace(dataclasses.replace(
            tstate.trace, cursor=tstate.trace.cursor + 1), tcfg, 5))
    dirty = tstate.trace.data.clone()
    dirty[-1, 0] = 7
    raises_same(
        lambda: jobs.check_trace(dataclasses.replace(
            jstate.trace, data=jstate.trace.data.at[-1, 0].set(7)), jcfg, 5),
        lambda: tobs.check_trace(dataclasses.replace(
            tstate.trace, data=dirty), tcfg, 5))


# ----------------------------------------------------------- recovery


def planted_records(n=24):
    """A stride-1 trace with a cut that never drains, a lost expiry and a
    negative finalization count."""
    rng = np.random.default_rng(3)
    out = []
    for r in range(n):
        out.append({"round": r, "expiries": int(rng.integers(0, 3)),
                    "ring_occupancy": 100 + (50 if r >= 5 else 0),
                    "partition_blocked": 4 if 5 <= r < 9 else 0,
                    "deliveries": 90, "finalizations": -1 if r == 7 else 1})
    return out[::-1]                       # unsorted: both re-sort


@pytest.mark.parametrize("slack", [0, 2])
def test_verify_recovery_violations_match_jax(tmp_path, slack):
    knobs = dict(ASYNC, partition_spec=(5, 9, 0.5))
    jcfg, tcfg = _configs(knobs)
    recs = planted_records()
    want = jrecovery.verify_recovery(jcfg, recs, occupancy_slack=slack)
    got = trecovery.verify_recovery(tcfg, recs, occupancy_slack=slack)
    assert not got.ok and got.violations == want.violations
    assert (got.windows, got.totals) == (want.windows, want.totals)
    path = tmp_path / "planted.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert trecovery.load_trace(path) == jrecovery.load_trace(path)
    with pytest.raises(jrecovery.RecoveryViolation) as jerr:
        jrecovery.check_recovery(jcfg, path, occupancy_slack=slack)
    with pytest.raises(trecovery.RecoveryViolation) as terr:
        trecovery.check_recovery(tcfg, path, occupancy_slack=slack)
    assert str(terr.value) == str(jerr.value)
    msgs = []
    for bad in (recs[:-1], [{k: v for k, v in r.items() if k != "expiries"}
                            for r in recs]):
        with pytest.raises(ValueError) as jerr:
            jrecovery.verify_recovery(jcfg, bad)
        with pytest.raises(ValueError) as terr:
            trecovery.verify_recovery(tcfg, bad)
        msgs.append((str(jerr.value), str(terr.value)))
    assert msgs[0][1] == msgs[0][0]
    # The missing-counter message stops before the reference's closing
    # note on the project's history (ROADMAP.md Queue 3).
    want, got = msgs[1]
    assert got.endswith("carries it)") and want.startswith(got[:-1])


def test_fleet_recovery_verdicts_match_jax():
    """Per-trial verdicts straight from the fleet's trace plane against
    each trial's own realized stochastic window, equal to the JAX
    package's, and to its telemetry route's."""
    knobs = dict(finalization_score=48, latency_mode="fixed",
                 latency_rounds=1,
                 fault_script=(("stochastic_partition", (3, 6), (4, 10),
                                (0.4, 0.6)),),
                 trace_every=1, **TIMING)
    jcfg, tcfg = _configs(knobs)
    kw = dict(fleet=4, n_nodes=48, n_txs=12, n_rounds=40, seed=1)
    want = jfleet.run_fleet("avalanche", jcfg, **kw)
    got = tfleet.run_fleet("avalanche", tcfg, device="cpu", **kw)
    jreps = jobs.check_recovery(jcfg, want.trace, windows=want.cut_windows)
    treps = tobs.check_recovery(tcfg, got.trace, windows=got.cut_windows)
    assert len(treps) == 4 and all(r.ok for r in treps)
    assert [dataclasses.asdict(r) for r in treps] == [
        dataclasses.asdict(r) for r in jreps]
    legacy = tobs.check_recovery(
        tcfg, tfleet.fleet_trace_records(got.telemetry, 4),
        windows=got.cut_windows)
    assert [dataclasses.asdict(r) for r in legacy] == [
        dataclasses.asdict(r) for r in treps]
    with pytest.raises(ValueError) as jerr:
        jobs.check_recovery(jcfg, want.trace)
    with pytest.raises(ValueError) as terr:
        tobs.check_recovery(tcfg, got.trace)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------- utils/metrics


def test_metrics_reductions_match_jax():
    jstate, tstate, jcfg, tcfg = pair(dict(finalization_score=8), n=24,
                                      t=16)
    jfinal, jtel = jav.run_scan(jstate, jcfg, 12)
    tfinal, ttel = tav.run_scan(tstate, tcfg, 12, device="cpu")
    assert (tmetrics.telemetry_summary(ttel)
            == jmetrics.telemetry_summary(jtel))
    assert (tmetrics.rounds_to_finality(tfinal.finalized_at)
            == jmetrics.rounds_to_finality(jfinal.finalized_at))
    np.testing.assert_array_equal(
        tmetrics.finality_curve(ttel.finalizations, 24 * 16),
        jmetrics.finality_curve(jtel.finalizations, 24 * 16))
    with pytest.raises(ValueError) as jerr:
        jmetrics.rounds_to_finality(None)
    with pytest.raises(ValueError) as terr:
        tmetrics.rounds_to_finality(None)
    assert str(terr.value) == str(jerr.value)
    np.testing.assert_array_equal(
        tmetrics.status_plane(tfinal.records.confidence, tcfg).numpy(),
        np.asarray(jmetrics.status_plane(jfinal.records.confidence, jcfg)))
    assert tmetrics.votes_per_second(10, 2.0) == \
        jmetrics.votes_per_second(10, 2.0)
    assert tmetrics.votes_per_second(10, 0.0) == \
        jmetrics.votes_per_second(10, 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_safety_failure_and_status_updates_match_jax(seed):
    rng = np.random.default_rng(seed)
    decided, value = rng.random(32) < 0.5, rng.random(32) < 0.9
    honest = rng.random(32) < 0.8
    for h in (None, honest):
        want = jmetrics.safety_failure(decided, value, h)
        got = tmetrics.safety_failure(
            torch.from_numpy(decided), torch.from_numpy(value),
            None if h is None else torch.from_numpy(h))
        assert got == want
    conf = rng.integers(0, 1 << 16, 40).astype(np.uint16)
    changed = rng.random(40) < 0.4
    cfg, jcfg = AvalancheConfig(finalization_score=200), JaxConfig(
        finalization_score=200)
    want = jmetrics.extract_status_updates(jnp.asarray(changed),
                                           jnp.asarray(conf), jcfg)
    got = tmetrics.extract_status_updates(
        torch.from_numpy(changed), torch.from_numpy(conf.view(np.int16)),
        cfg)
    assert [(u.hash, int(u.status)) for u in got] == [
        (u.hash, int(u.status)) for u in want]
    assert [u.status.name for u in got] == [u.status.name for u in want]
