"""The port's fault script (`ops/inflight.py`, `config.py`) against the
JAX one.

Each fault-script function of both packages takes the same seeded numpy
inputs; a script with every event kind runs whole trajectories on each
delivery engine; the fault studies of `examples/fault_scenarios.py`
reproduce the record the port commits (`workload.FAULT_STUDY_RECORDS`)
from the JAX package, and the port reproduces it too; and the async and
fault configs validate the same way in both packages.  Tolerance 0.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.config import fault_script_from_json as jax_from_json
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.ops import inflight as jif
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch import convert, workload
from go_avalanche_tpu_torch.config import (AvalancheConfig,
                                           fault_script_from_json)
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.ops import inflight as tif
from go_avalanche_tpu_torch.ops import voterecord as tvr
from test_torch_avalanche import (_jax_numpy, assert_leaves_equal,
                                  assert_states_equal)

ENGINES = ("walk", "walk_earlyout", "coalesced")
TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)   # timeout 4
STOCHASTIC = (
    ("stochastic_partition", (1, 6), (2, 9), (0.2, 0.8)),
    ("stochastic_spike", (0, 4), (1, 5), (1, 3)),
    ("stochastic_regional_outage", (2, 7), (1, 4), (0, 2)),
)


def configs(**knobs):
    return JaxConfig(**knobs), AvalancheConfig(**knobs)


def key_words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key),
                                       np.uint32).astype(np.int64))


def rounds_tensor(r):
    return torch.tensor(r, dtype=torch.int32)


@pytest.mark.parametrize("clusters", [1, 3])
@pytest.mark.parametrize("event", range(len(STOCHASTIC)))
def test_draw_fault_params_matches_jax(event, clusters):
    script = (STOCHASTIC[event],)
    if clusters == 1 and script[0][0] == "stochastic_regional_outage":
        script = (("stochastic_partition", (0, 0), (1, 1), (0.5, 0.5)),)
    jcfg, tcfg = configs(fault_script=script, n_clusters=clusters, **TIMING)
    for seed in range(6):
        want = jif.draw_fault_params(jcfg, jax.random.key(seed), 200)
        got = tif.draw_fault_params(tcfg, key_words(jax.random.key(seed)),
                                    200)
        assert_leaves_equal(_jax_numpy(want), convert._np_tree(got),
                            f"seed {seed}")
    assert tif.draw_fault_params(AvalancheConfig(), key_words(
        jax.random.key(0)), 10) is None


def test_draw_fault_params_every_kind_in_one_script():
    jcfg, tcfg = configs(fault_script=STOCHASTIC + STOCHASTIC[:2],
                         n_clusters=3, **TIMING)
    want = jif.draw_fault_params(jcfg, jax.random.key(8), 99)
    got = tif.draw_fault_params(tcfg, key_words(jax.random.key(8)), 99)
    assert_leaves_equal(_jax_numpy(want), convert._np_tree(got), "all")
    assert got.cut_start.shape == (2,) and got.region_start.shape == (1,)


CUT_SCRIPTS = {
    "partition": dict(partition_spec=(2, 6, 0.3)),
    "partition_clustered": dict(partition_spec=(2, 6, 0.5), n_clusters=3),
    "regional": dict(n_clusters=4, fault_script=(
        ("regional_outage", 1, 5, 0), ("regional_outage", 3, 8, 2))),
    "stochastic": dict(n_clusters=3, fault_script=(STOCHASTIC[0],
                                                   STOCHASTIC[2])),
}


@pytest.mark.parametrize("case", sorted(CUT_SCRIPTS))
def test_partition_cut_and_apply_faults_match_jax(case):
    jcfg, tcfg = configs(latency_mode="fixed", latency_rounds=1,
                         **CUT_SCRIPTS[case], **TIMING)
    rng = np.random.default_rng(len(case))
    n, rows, offset = 90, 40, 25
    peers = rng.integers(0, n, (rows, 8)).astype(np.int32)
    lat = rng.integers(0, 4, (rows, 8)).astype(np.int32)
    jfp = jif.draw_fault_params(jcfg, jax.random.key(2), n)
    tfp = tif.draw_fault_params(tcfg, key_words(jax.random.key(2)), n)
    blocked = 0
    for r in range(12):
        want = jif.partition_cut(jcfg, jnp.int32(r), offset,
                                 jnp.asarray(peers), n, jfp)
        got = tif.partition_cut(tcfg, rounds_tensor(r), offset,
                                torch.from_numpy(peers), n, tfp)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        blocked += int(got.sum())
        want = jif.apply_faults(jnp.asarray(lat), jcfg, jnp.int32(r), offset,
                                jnp.asarray(peers), n, jfp)
        got = tif.apply_faults(torch.from_numpy(lat), tcfg, rounds_tensor(r),
                               offset, torch.from_numpy(peers), n, tfp)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert blocked > 0
    assert tif.partition_cut(AvalancheConfig(), rounds_tensor(0), 0,
                             torch.from_numpy(peers), n) is None


@pytest.mark.parametrize("stochastic", [False, True])
def test_apply_latency_spikes_matches_jax(stochastic):
    script = (("latency_spike", 2, 5, 1), ("latency_spike", 6, 9, 3))
    if stochastic:
        script = script[:1] + (STOCHASTIC[1], STOCHASTIC[1])
    jcfg, tcfg = configs(latency_mode="geometric", latency_rounds=1,
                         fault_script=script, **TIMING)
    lat = np.random.default_rng(4).integers(0, 5, (30, 8)).astype(np.int32)
    jfp = jif.draw_fault_params(jcfg, jax.random.key(3), 30)
    tfp = tif.draw_fault_params(tcfg, key_words(jax.random.key(3)), 30)
    for r in range(11):
        want = jif.apply_latency_spikes(jnp.asarray(lat), jcfg, jnp.int32(r),
                                        jfp)
        got = tif.apply_latency_spikes(torch.from_numpy(lat), tcfg,
                                       rounds_tensor(r), tfp)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_apply_churn_bursts_matches_jax():
    jcfg, tcfg = configs(fault_script=(("churn_burst", 2, 0.3),
                                       ("churn_burst", 5, 0.8)))
    alive = np.random.default_rng(5).random(500) < 0.9
    key = jax.random.key(11)
    changed = 0
    for r in range(7):
        want = jif.apply_churn_bursts(jnp.asarray(alive), jcfg, jnp.int32(r),
                                      key)
        got = tif.apply_churn_bursts(torch.from_numpy(alive), tcfg,
                                     rounds_tensor(r), key_words(key))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        changed += int((got.numpy() != alive).sum())
    assert changed > 0


EVERY_KIND = (
    ("partition", 2, 5, 0.5),
    ("regional_outage", 3, 7, 1),
    ("latency_spike", 6, 9, 2),
    ("churn_burst", 4, 0.2),
    ("stochastic_partition", (7, 9), (1, 3), (0.3, 0.6)),
    ("stochastic_spike", (1, 3), (2, 4), (1, 2)),
    ("stochastic_regional_outage", (8, 10), (1, 2), (0, 1)),
)


@pytest.mark.parametrize("engine", ENGINES)
def test_every_event_kind_trajectory_matches_jax(engine):
    knobs = dict(latency_mode="fixed", latency_rounds=1, n_clusters=2,
                 fault_script=EVERY_KIND, finalization_score=6,
                 inflight_engine=engine, **TIMING)
    jcfg, tcfg = configs(**knobs)
    n, t = 32, 24
    jstate = jav.init(jax.random.key(5), n, t, jcfg,
                      init_pref=jav.contested_init_pref(5, n, t))
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    want, wtel = jav.run_scan(jstate, jcfg, n_rounds=14)
    got, gtel = tav.run_scan(tstate, tcfg, n_rounds=14, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_states_equal(want, got, "every kind")
    assert int(gtel.partition_blocked.sum()) > 0
    assert int(gtel.expiries.sum()) > 0


SERIES = ("finalizations", "deliveries", "expiries", "partition_blocked",
          "ring_occupancy")


def jax_fault_study(name):
    """The study's record from the JAX package: `measure()`'s config as
    `examples/fault_scenarios.measure` builds it, the scenarios' from the
    example's own `SCENARIOS` builders."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import fault_scenarios

    timing = dict(time_step_s=1.0, request_timeout_s=float(
        workload.FAULT_STUDY_TIMEOUT - 1))
    if name == "measure":
        cfg = JaxConfig(finalization_score=48, latency_mode="fixed",
                        latency_rounds=1, partition_spec=(5, 60, 0.5),
                        **timing)
        rounds = 130
    else:
        cfg, rounds, _ = fault_scenarios.SCENARIOS[name](timing)
    n, t = workload.FAULT_STUDY_SHAPE
    state = jav.init(jax.random.key(0), n, t, cfg,
                     init_pref=jav.contested_init_pref(0, n, t))
    final, tel = jav.run_scan(state, cfg, n_rounds=rounds)
    record = {f: np.asarray(getattr(tel, f)).tolist() for f in SERIES}
    record["finalized_fraction"] = float(np.asarray(
        jvr.has_finalized(final.records.confidence, cfg)).mean())
    return cfg, record


@pytest.mark.parametrize("name", sorted(workload.FAULT_STUDY_RECORDS))
def test_fault_study_record_reproduces(name):
    """The JAX package reproduces the committed record; the port's
    config is the example's, field by field; and the port's coalesced
    engine reproduces the record too."""
    jcfg, want = jax_fault_study(name)
    assert want == workload.FAULT_STUDY_RECORDS[name]
    tcfg, rounds = workload.fault_study_config(name)
    assert rounds == len(want["finalizations"])
    for field in tcfg.__dataclass_fields__:
        w, g = getattr(jcfg, field), getattr(tcfg, field)
        assert getattr(w, "value", w) == getattr(g, "value", g), field
    state, cfg, rounds = workload.fault_study_state(name, "coalesced",
                                                    device="cpu")
    final, tel = tav.run_scan(state, cfg, n_rounds=rounds, device="cpu")
    got = {f: getattr(tel, f).tolist() for f in SERIES}
    got["finalized_fraction"] = float(tvr.has_finalized(
        final.records.confidence, cfg).double().mean())
    assert got == want


# ----------------------------------------------------------- config rules


INVALID = [
    dict(latency_mode="fixed", latency_rounds=-1),
    dict(latency_mode="fixed"),                           # timeout 6001
    dict(latency_mode="fixed", time_step_s=1.0, request_timeout_s=-1.0),
    dict(latency_mode="fixed", vote_mode="majority", **TIMING),
    dict(latency_mode="rtt", n_clusters=2, **TIMING),
    dict(rtt_matrix=((1, 1), (1, 1)), n_clusters=2),
    dict(latency_mode="rtt", rtt_matrix=((1, 2),), n_clusters=2, **TIMING),
    dict(latency_mode="rtt", rtt_matrix=((1, -2), (2, 1)), n_clusters=2,
         **TIMING),
    dict(partition_spec=(3, 3, 0.5), **TIMING),
    dict(partition_spec=(4, 2, 0.5), **TIMING),
    dict(partition_spec=(1, 4, 1.5), **TIMING),
    dict(partition_spec=(1, 4), **TIMING),
    dict(fault_script=(("meteor", 1, 2, 3),), **TIMING),
    dict(fault_script=(("partition", 1, 2),), **TIMING),
    dict(fault_script=(("partition", 1.5, 2, 0.5),), **TIMING),
    dict(fault_script=(("partition", 2, 2, 0.5),), **TIMING),
    dict(fault_script=(("partition", 1, 4, 0.5), ("partition", 3, 6, 0.4)),
         **TIMING),
    dict(partition_spec=(1, 4, 0.5),
         fault_script=(("partition", 2, 5, 0.5),), **TIMING),
    dict(fault_script=(("regional_outage", 1, 4, 0),), **TIMING),
    dict(fault_script=(("regional_outage", 1, 4, 5),), n_clusters=3,
         **TIMING),
    dict(fault_script=(("regional_outage", 1, 4, 1),
                       ("regional_outage", 2, 6, 1)), n_clusters=3,
         **TIMING),
    dict(fault_script=(("latency_spike", 1, 4, 0),), **TIMING),
    dict(fault_script=(("churn_burst", -1, 0.5),)),
    dict(fault_script=(("churn_burst", 1, 1.5),)),
    dict(fault_script=(("churn_burst", 1, 0.5), ("churn_burst", 1, 0.2))),
    dict(fault_script=(("stochastic_partition", (1, 0), (1, 2),
                        (0.2, 0.4)),), **TIMING),
    dict(fault_script=(("stochastic_partition", (0, 1), (0, 2),
                        (0.2, 0.4)),), **TIMING),
    dict(fault_script=(("stochastic_partition", (0, 1), (1, 2),
                        (0.2, 1.0)),), **TIMING),
    dict(fault_script=(("stochastic_partition", (0, 1), (1, 2),
                        (None, 0.4)),), **TIMING),
    dict(fault_script=(("stochastic_spike", (0, 1), (1, 2), (0, 2)),),
         **TIMING),
    dict(fault_script=(("stochastic_spike", (0, 1.5), (1, 2), (1, 2)),),
         **TIMING),
    dict(fault_script=(("stochastic_spike", 3, (1, 2), (1, 2)),), **TIMING),
    dict(fault_script=(("stochastic_regional_outage", (0, 1), (1, 2),
                        (0, 1)),), **TIMING),
    dict(fault_script=(("stochastic_regional_outage", (0, 1), (1, 2),
                        (0, 3)),), n_clusters=3, **TIMING),
    dict(fault_script=(("stochastic_spike", (True, 2), (1, 2), (1, 2)),),
         **TIMING),
    dict(inflight_engine="ring"),
    dict(latency_mode="lognormal"),
]


def _build(config_cls, knobs):
    from go_avalanche_tpu.config import VoteMode as JaxVoteMode
    from go_avalanche_tpu_torch.config import VoteMode

    knobs = dict(knobs)
    if "vote_mode" in knobs:
        mode = JaxVoteMode if config_cls is JaxConfig else VoteMode
        knobs["vote_mode"] = mode(knobs["vote_mode"])
    return config_cls(**knobs)


@pytest.mark.parametrize("case", range(len(INVALID)))
def test_invalid_async_and_fault_configs_raise_as_jax(case):
    """Each config raises ValueError in both packages, with the same
    message (the non-positive-timeout message names the run-until-settled
    loop in its own word in each package)."""
    knobs = INVALID[case]
    with pytest.raises(ValueError) as want:
        _build(JaxConfig, knobs)
    with pytest.raises(ValueError) as got:
        _build(AvalancheConfig, knobs)

    def text(e):
        return re.sub(r"run-until-settled \w+", "run-until-settled",
                      str(e.value))

    assert text(got) == text(want)


VALID = {
    # The three cases that raised NotImplementedError before the ring
    # was ported (formerly in test_unported_fields_raise_not_implemented).
    "coalesced_engine": dict(inflight_engine="coalesced"),
    "fixed_latency_default_timing": dict(latency_mode="fixed",
                                         time_step_s=1.0,
                                         request_timeout_s=5.0),
    "churn_burst_only": dict(fault_script=(("churn_burst", 1, 0.1),)),
    "every_kind": dict(fault_script=EVERY_KIND, n_clusters=2, **TIMING),
    "json_lists": dict(fault_script=(["stochastic_spike", [0, 2], [1, 3],
                                      [1, 1]],), **TIMING),
    "partition_spec_and_script": dict(
        partition_spec=(1, 3, 0.5),
        fault_script=(("partition", 3, 6, 0.4),), **TIMING),
    "rtt": dict(latency_mode="rtt", rtt_matrix=[[0, 2], [2, 0]],
                n_clusters=2, **TIMING),
}


@pytest.mark.parametrize("case", sorted(VALID))
def test_async_configs_derive_as_jax(case):
    """Both packages accept the config and derive the same fields:
    `async_queries()`, `timeout_rounds()` and every event accessor."""
    jcfg, tcfg = configs(**VALID[case])
    for name in ("async_queries", "timeout_rounds", "fault_events",
                 "cut_events", "spike_events", "stochastic_cut_events",
                 "stochastic_spike_events", "stochastic_region_events",
                 "stochastic_events", "churn_burst_events"):
        assert getattr(jcfg, name)() == getattr(tcfg, name)(), name
    assert jcfg.fault_script == tcfg.fault_script
    assert jcfg.rtt_matrix == tcfg.rtt_matrix


def test_adaptive_adversary_still_unported():
    """The timing policy rides the async ring: accepted with a latency
    mode, refused with the reference's message without one."""
    cfg = AvalancheConfig(byzantine_fraction=0.2, adversary_policy="timing",
                          latency_mode="fixed", **TIMING)
    assert cfg.async_queries() and cfg.adversary_policy == "timing"
    with pytest.raises(ValueError, match="async engine on"):
        AvalancheConfig(byzantine_fraction=0.2, adversary_policy="timing",
                        **TIMING)


@pytest.mark.parametrize("data", [
    [["partition", 2, 6, 0.5], {"kind": "latency_spike", "start": 1,
                                "end": 3, "extra_rounds": 2}],
    [{"kind": "stochastic_partition", "start": [0, 2], "length": [1, 4],
      "frac": [0.2, 0.5]}],
    {"kind": "partition"},
    [{"kind": "partition", "start": 1}],
    [{"kind": "meteor"}],
    [{"kind": "churn_burst", "round": 1, "frac": 0.1, "extra": 2}],
    [3],
])
def test_fault_script_from_json_matches_jax(data):
    try:
        want = jax_from_json(data)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fault_script_from_json(data)
        assert str(got.value) == str(e)
        return
    assert fault_script_from_json(data) == want
