"""The port's live-traffic plane (`traffic.py`) against the JAX one: the
rate schedules, backpressure, the histogram and its percentiles, and
whole backlog and streaming-DAG runs in every arrival mode, started from
one state and compared leaf by leaf (the cases `tests/test_traffic.py`
pins).  Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import traffic as jtf
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch import traffic as ttf
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import backlog as tbl
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from test_torch_avalanche import _jax_numpy
from test_torch_backlog import assert_trees_equal, jax_tree, torch_tree

MODES = {
    "poisson": dict(arrival_mode="poisson", arrival_rate=2.0),
    "rejection_backpressure": dict(arrival_mode="poisson", arrival_rate=14.0,
                                   arrival_backpressure=(0.5, 0.9)),
    "bursty": dict(arrival_mode="bursty", arrival_rate=1.5,
                   arrival_period=10, arrival_burst_factor=4.0,
                   arrival_duty=0.3),
    "diurnal": dict(arrival_mode="diurnal", arrival_rate=3.0,
                    arrival_period=24, arrival_depth=0.8),
    "cluster_weights_small_buckets": dict(
        arrival_mode="poisson", arrival_rate=3.0, n_clusters=3,
        cluster_locality=0.7, arrival_cluster_weights=(1.0, 3.0, 0.5),
        arrival_latency_buckets=8),
}


def configs(**knobs):
    return JaxConfig(**knobs), AvalancheConfig(**knobs)


def backlog_pair(knobs, n_txs=48, n_nodes=16, slots=8, seed=0):
    jcfg, tcfg = configs(**knobs)
    jstate = jbl.init(jax.random.key(seed), n_nodes, slots,
                      jbl.make_backlog(jnp.arange(n_txs, dtype=jnp.int32)),
                      jcfg)
    tstate = convert.backlog_state_from_numpy(_jax_numpy(jstate),
                                              device="cpu")
    return jstate, tstate, jcfg, tcfg


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_schedule_and_backpressure_match_jax(mode):
    """Exact, but for the diurnal rate: XLA:CPU takes `sin` from the C
    library's `sinf`, the port in float64 rounded once (so the CPU and
    the card agree), and the rates differ by at most 1 ulp (ROADMAP.md
    Queue 3)."""
    jcfg, tcfg = configs(**MODES[mode])
    bound = 1 if mode == "diurnal" else 0
    for r in range(0, 200, 7):
        want = jtf.schedule_rate(jcfg, jnp.int32(r))
        got = ttf.schedule_rate(tcfg, torch.tensor(r, dtype=torch.int32))
        assert _ulps(want, got.numpy()) <= bound, (mode, r)
    for occ in np.linspace(0.0, 1.0, 41, dtype=np.float32):
        want = jtf.backpressure_factor(jcfg, jnp.float32(occ))
        got = ttf.backpressure_factor(tcfg, torch.tensor(occ))
        assert np.float32(want) == got.numpy(), (mode, occ)


def test_histogram_and_percentiles_match_jax():
    cfg_kw = dict(arrival_mode="poisson", arrival_rate=1.0,
                  arrival_latency_buckets=64)
    jcfg, tcfg = configs(**cfg_kw)
    rng = np.random.default_rng(0)
    for _ in range(20):
        lat = rng.integers(-5, 90, 50).astype(np.int32)
        count = rng.integers(-2, 4, 50).astype(np.int32)
        want = jtf.latency_delta(jcfg, jnp.asarray(lat), jnp.asarray(count))
        got = ttf.latency_delta(tcfg, torch.from_numpy(lat),
                                torch.from_numpy(count))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        for q in jtf.PERCENTILES:
            assert int(jtf.percentile_from_hist(want, *q)) == int(
                ttf.percentile_from_hist(got, *q))
    empty = torch.zeros(64, dtype=torch.int32)
    assert int(ttf.percentile_from_hist(empty, 1, 2)) == -1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_backlog_steps_match_jax(mode):
    """Step by step, with the traffic telemetry, then `run` to the end."""
    jstate, tstate, jcfg, tcfg = backlog_pair(MODES[mode])
    jstep = jax.jit(jbl.step, static_argnames=("cfg",))
    for r in range(15):
        jstate, jtel = jstep(jstate, jcfg)
        tstate, ttel = tbl.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel),
                           f"{mode} round {r}")
    want = jax.jit(jbl.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 3000)
    got = tbl.run(tstate, tcfg, max_rounds=3000, device="cpu")
    assert_trees_equal(_jax_numpy(want), convert.backlog_state_to_numpy(got),
                       mode)
    assert ttf.latency_percentiles(got.traffic) == jtf.latency_percentiles(
        want.traffic)


def test_backlog_percentiles_match_host_and_admission_gated():
    jstate, tstate, jcfg, tcfg = backlog_pair(MODES["rejection_backpressure"])
    final = tbl.run(tstate, tcfg, max_rounds=5000, device="cpu")
    out = final.outputs
    arr = final.traffic.arrival_round.numpy()
    assert out.settled.all()
    assert (out.admit_round.numpy() >= arr).all()
    assert len(np.unique(out.admit_round.numpy())) > 3
    ingraph = ttf.latency_percentiles(final.traffic)
    host = ttf.latency_percentiles_host(
        arr, out.settle_round.numpy(), out.settled.numpy().astype(np.int64),
        tcfg.arrival_latency_buckets)
    for key, value in host.items():
        assert ingraph[key] == value, key


def test_external_push_arrivals_match_jax():
    jstate, tstate, jcfg, tcfg = backlog_pair(dict(arrival_mode="external"))
    jstep = jax.jit(jbl.step, static_argnames=("cfg",))
    for r, count in enumerate([5, 0, 3, 12, 0, 0, 40, 1] * 3):
        jstate = jstate._replace(traffic=jtf.push_arrivals(
            jstate.traffic, count, jstate.sim.round))
        tstate = tstate._replace(traffic=ttf.push_arrivals(
            tstate.traffic, count, tstate.sim.round))
        jstate, jtel = jstep(jstate, jcfg)
        tstate, ttel = tbl.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel), f"round {r}")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "external")


def test_everything_arrived_matches_disabled_run():
    """A flood arrives the whole backlog in round 0, so the consensus
    trajectory equals the arrival-off run's (the traffic key is folded
    off the sim key)."""
    n_txs = 32
    _, off, _, off_cfg = backlog_pair({}, n_txs=n_txs)
    _, on, _, on_cfg = backlog_pair(dict(arrival_mode="poisson",
                                         arrival_rate=float(n_txs * 20)),
                                    n_txs=n_txs)
    f_off, t_off = tbl.run_scan(off, off_cfg, n_rounds=40, device="cpu")
    f_on, t_on = tbl.run_scan(on, on_cfg, n_rounds=40, device="cpu")
    assert int(f_on.traffic.arrived_idx) == n_txs
    assert_trees_equal(torch_tree(f_off.outputs), torch_tree(f_on.outputs),
                       "outputs")
    assert torch.equal(f_off.sim.records.confidence,
                       f_on.sim.records.confidence)
    assert torch.equal(t_off.round.polls, t_on.round.polls)


@pytest.mark.parametrize("mode", ["diurnal", "rejection_backpressure"])
def test_streaming_dag_traffic_matches_jax(mode):
    """Set granularity: a retiring set records one sample per valid
    member; the whole run equals JAX's and the in-graph percentiles equal
    the host's."""
    jcfg, tcfg = configs(**MODES[mode])
    n_sets, c = 16, 3
    valid = jnp.arange(n_sets * c).reshape(n_sets, c) % 3 != 2
    backlog = jsd.make_set_backlog(
        jnp.arange(n_sets * c, dtype=jnp.int32).reshape(n_sets, c),
        valid=valid)
    jstate = jsd.init(jax.random.key(0), 16, 4, backlog, jcfg)
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")
    want = jax.jit(jsd.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 3000)
    got = tsd.run(tstate, tcfg, max_rounds=3000, device="cpu")
    assert_trees_equal(_jax_numpy(want),
                       convert.streaming_dag_state_to_numpy(got), mode)
    out = got.outputs
    arr = got.traffic.arrival_round.numpy()[:, None].repeat(c, axis=1)
    weights = (out.settled & got.backlog.valid).numpy().astype(np.int64)
    host = ttf.latency_percentiles_host(arr, out.settle_round.numpy(),
                                        weights, tcfg.arrival_latency_buckets)
    ingraph = ttf.latency_percentiles(got.traffic)
    for key, value in host.items():
        assert ingraph[key] == value, key
    assert ingraph["finality_latency_count"] == int(weights.sum())


def test_arrival_config_rejections_match_jax():
    for kwargs in (dict(arrival_mode="bogus"), dict(arrival_rate=3.0),
                   dict(arrival_backpressure=(0.5, 0.9)),
                   dict(arrival_mode="poisson"),
                   dict(arrival_mode="external", arrival_rate=1.0),
                   dict(arrival_mode="bursty", arrival_rate=1.0,
                        arrival_period=1),
                   dict(arrival_mode="poisson", arrival_rate=1.0,
                        arrival_cluster_weights=(1.0, 2.0)),
                   dict(arrival_mode="poisson", arrival_rate=1.0,
                        arrival_latency_buckets=1)):
        with pytest.raises(ValueError):
            JaxConfig(**kwargs)
        with pytest.raises(ValueError):
            AvalancheConfig(**kwargs)


def diurnal_sin_mismatches() -> dict:
    """How many diurnal phases ``f32(2 pi / P) * r`` (12 periods P,
    rounds r < 20000) XLA:CPU's float32 `sin` rounds differently from the
    port's (float64 rounded once), and the largest distance in ulp."""
    differ = total = worst = 0
    for period in (2, 3, 5, 7, 10, 16, 24, 50, 100, 240, 1000, 9973):
        step = np.float32(2.0 * np.pi / period)
        phase = (step * np.arange(20000, dtype=np.float32)).astype(np.float32)
        want = np.asarray(jnp.sin(jnp.asarray(phase)))
        got = torch.sin(torch.from_numpy(phase).double()).float().numpy()
        dist = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32))
        differ += int((dist > 0).sum())
        total += dist.size
        worst = max(worst, int(dist.max()))
    return {"phases": total, "differ": differ, "max_ulp": worst}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_traffic.py
    # (a few seconds; not part of the test run).
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(diurnal_sin_mismatches()))
