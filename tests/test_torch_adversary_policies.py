"""The port's adaptive adversary (`cfg.adversary_policy`,
`go_avalanche_tpu_torch/ops/adversary.py`) against the JAX package's.

Each policy helper gets the same seeded numpy inputs in both packages;
whole `run_scan` trajectories start both packages from one JAX `init`
(carried with `convert.py`) under every policy, on the fused and the
legacy exchange and, under latency, on the three delivery engines: every
state leaf and every per-round telemetry scalar must be equal.  The
config rules are held message for message.  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import family as jfam
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu.ops import adversary as jadv
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch import convert, prng, workload
from go_avalanche_tpu_torch.config import (ADVERSARY_POLICIES,
                                           AdversaryStrategy, AvalancheConfig)
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import backlog as tbl
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.models import family as tfam
from go_avalanche_tpu_torch.models import node_stream as tns
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from go_avalanche_tpu_torch.ops import adversary as tadv
from go_avalanche_tpu_torch.ops import voterecord as tvr
from test_torch_avalanche import _configs, _jax_numpy, assert_leaves_equal
from test_torch_backlog import assert_trees_equal, jax_tree, torch_tree
from test_torch_inflight import ENGINES, TIMING, key_words

POLICY_KNOBS = {
    "split_vote": dict(byzantine_fraction=0.25, adversary_policy="split_vote"),
    "withhold_near_quorum": dict(byzantine_fraction=0.25,
                                 adversary_policy="withhold_near_quorum",
                                 adversary_margin=4),
    "stake_eclipse": dict(byzantine_fraction=0.25,
                          adversary_policy="stake_eclipse", stake_mode="zipf"),
}
ASYNC = dict(latency_mode="geometric", latency_rounds=1, **TIMING)
ASYNC_POLICY_KNOBS = {
    "timing": dict(byzantine_fraction=0.25, adversary_policy="timing",
                   **ASYNC),
    "withhold_near_quorum": dict(POLICY_KNOBS["withhold_near_quorum"],
                                 **ASYNC),
    "split_vote": dict(POLICY_KNOBS["split_vote"], **ASYNC),
}


def jkey(seed):
    return jax.random.key(seed)


def t_(x):
    return torch.from_numpy(np.asarray(x))


def np_(x):
    return np.asarray(jax.device_get(x))


# --------------------------------------------------------------- config


CONFIG_CASES = [
    dict(adversary_policy="split_vote"),
    dict(flip_probability=0.3),
    dict(adversary_strategy="oppose_majority"),
    dict(adversary_margin=2),
    dict(adversary_policy="timing", adversary_margin=3),
    dict(flip_probability=1.0, adversary_strategy="flip",
         adversary_policy="off", adversary_margin=1),
    dict(byzantine_fraction=0.2, adversary_policy="bogus"),
    dict(byzantine_fraction=0.2, adversary_margin=-1),
    dict(byzantine_fraction=0.2, adversary_margin=True),
    dict(byzantine_fraction=0.2, adversary_margin=2.0),
    dict(byzantine_fraction=0.2, adversary_margin=3,
         adversary_policy="split_vote"),
    dict(byzantine_fraction=0.2, adversary_margin=3),
    dict(byzantine_fraction=0.2, adversary_margin=3,
         adversary_policy="withhold_near_quorum"),
    dict(byzantine_fraction=0.2, adversary_margin=0,
         adversary_policy="withhold_near_quorum"),
    dict(byzantine_fraction=0.2, adversary_policy="timing"),
    dict(byzantine_fraction=0.2, adversary_policy="timing",
         latency_mode="fixed", latency_rounds=1, **TIMING),
    dict(byzantine_fraction=0.2, adversary_policy="timing",
         partition_spec=(1, 3, 0.5), **TIMING),
    dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse"),
    dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse",
         stake_mode="zipf"),
    dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse",
         stake_mode="uniform"),
    dict(byzantine_fraction=1.5),
    dict(byzantine_fraction=0.2, flip_probability=2.0),
    dict(byzantine_fraction=0.2, adversary_policy="split_vote",
         adversary_strategy="equivocate"),
    dict(byzantine_fraction=0.2, adversary_policy="split_vote",
         adversary_strategy="oppose_majority"),
    dict(byzantine_fraction=0.2, adversary_policy="split_vote"),
    dict(byzantine_fraction=0.2, adversary_policy="withhold_near_quorum",
         flip_probability=0.5, adversary_strategy="equivocate"),
    dict(byzantine_fraction=0.2, adversary_policy="split_vote",
         round_engine="megakernel"),
    dict(byzantine_fraction=0.2, adversary_policy="withhold_near_quorum",
         round_engine="megakernel"),
    dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse",
         stake_mode="zipf", round_engine="megakernel"),
]


def _outcome(config_cls, strategy_cls, kwargs):
    kw = dict(kwargs)
    if "adversary_strategy" in kw:
        kw["adversary_strategy"] = strategy_cls(kw["adversary_strategy"])
    try:
        config_cls(**kw)
    except ValueError as err:
        return str(err)
    return None


@pytest.mark.parametrize("kwargs", CONFIG_CASES,
                         ids=[str(i) for i in range(len(CONFIG_CASES))])
def test_policy_config_rules_match_jax(kwargs):
    """Both configs accept, or both reject with the same message."""
    want = _outcome(JaxConfig, JaxStrategy, kwargs)
    got = _outcome(AvalancheConfig, AdversaryStrategy, kwargs)
    assert got == want


def test_adversary_policies_constant_matches_jax():
    from go_avalanche_tpu.config import ADVERSARY_POLICIES as JAX_POLICIES

    assert ADVERSARY_POLICIES == JAX_POLICIES


# --------------------------------------------------------------- helpers


@pytest.mark.parametrize("shape", [(9,), (10,), (13, 7), (12, 33)])
def test_honest_split_plane_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    n = shape[0]
    for trial in range(6):
        prefs = rng.random(shape) < 0.5
        byz = rng.random(n) < (0.2 + 0.1 * trial)
        if trial == 0:             # exact honest ties on every column
            byz = np.arange(n) < n % 2
            half = (n - n % 2) // 2
            prefs = np.zeros(shape, bool)
            prefs[n % 2:n % 2 + half] = True
        want = jadv.honest_split_plane(jnp.asarray(prefs), jnp.asarray(byz))
        got = tadv.honest_split_plane(t_(prefs), t_(byz))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np_(w), g.numpy())
        if trial == 0:
            assert bool(got[1].all())


def random_records_np(rng, shape, fin_score, window=8):
    wm = (1 << window) - 1
    votes = rng.integers(0, 256, shape).astype(np.uint8) & wm
    cons = rng.integers(0, 256, shape).astype(np.uint8) & wm
    counter = np.where(rng.random(shape) < 0.3, fin_score,
                       rng.integers(0, fin_score, shape))
    conf = ((counter << 1) | rng.integers(0, 2, shape)).astype(np.uint16)
    return votes, cons, conf


@pytest.mark.parametrize("margin", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(17,), (15, 11)])
def test_near_quorum_rows_matches_jax(margin, shape):
    """Near-quorum rows on random windows, finalized records excluded
    (about a third of the records sit at the score)."""
    jcfg, tcfg = _configs(dict(byzantine_fraction=0.3, finalization_score=9,
                               adversary_policy="withhold_near_quorum",
                               adversary_margin=margin))
    rng = np.random.default_rng(margin)
    votes, cons, conf = random_records_np(rng, shape, 9)
    want = jadv.near_quorum_rows(jvr.VoteRecordState(
        jnp.asarray(votes), jnp.asarray(cons), jnp.asarray(conf)), jcfg)
    got = tadv.near_quorum_rows(convert._records_from_numpy(
        jvr.VoteRecordState(votes, cons, conf)), tcfg)
    np.testing.assert_array_equal(np_(want), got.numpy())


def test_near_quorum_excludes_finalized_records():
    jcfg, tcfg = _configs(dict(byzantine_fraction=0.5, finalization_score=4,
                               adversary_policy="withhold_near_quorum"))
    votes = np.full((2, 1), 0b01111111, np.uint8)
    conf = np.array([[4 << 1 | 1], [3 << 1 | 1]], np.uint16)
    records = jvr.VoteRecordState(votes, votes, conf)
    want = jadv.near_quorum_rows(jax.tree.map(jnp.asarray, records), jcfg)
    got = tadv.near_quorum_rows(convert._records_from_numpy(records), tcfg)
    assert np_(want).tolist() == got.tolist() == [False, True]


@pytest.mark.parametrize("byz_frac,n", [(0.25, 8), (0.75, 8), (0.1, 37),
                                        (0.5, 30), (0.9, 20), (0.02, 16)])
def test_eclipse_rows_matches_jax(byz_frac, n):
    """The eclipse set on zipf, tied and random weights; a requested set
    beyond the honest rows saturates at every honest row."""
    jcfg, tcfg = _configs(dict(byzantine_fraction=byz_frac,
                               adversary_policy="stake_eclipse",
                               stake_mode="zipf"))
    rng = np.random.default_rng(n)
    n_byz = int(round(byz_frac * n))
    for weights in (1.0 / (np.arange(n, dtype=np.float32) + 1.0),
                    np.ones(n, np.float32),
                    rng.integers(1, 4, n).astype(np.float32),
                    rng.uniform(0.1, 3.0, n).astype(np.float32)):
        byz = np.arange(n) < n_byz
        want = jadv.eclipse_rows(jnp.asarray(weights), jnp.asarray(byz), jcfg)
        got = tadv.eclipse_rows(t_(weights), t_(byz), tcfg)
        np.testing.assert_array_equal(np_(want), got.numpy())
        assert not (got.numpy() & byz).any()
        if n_byz >= n - n_byz:
            assert (got.numpy() == ~byz).all()


@pytest.mark.parametrize("policy", ADVERSARY_POLICIES)
def test_policy_ctx_and_issue_match_jax(policy):
    """`policy_ctx` on a contested state, then `apply_policy_issue` on
    random masks: every context plane and the three masks."""
    knobs = dict(byzantine_fraction=0.3, finalization_score=6)
    if policy != "off":
        knobs["adversary_policy"] = policy
    if policy == "withhold_near_quorum":
        knobs["adversary_margin"] = 3
    if policy == "stake_eclipse":
        knobs["stake_mode"] = "zipf"
    if policy == "timing":
        knobs.update(ASYNC)
    jcfg, tcfg = _configs(knobs)
    n, t = 20, 12
    jstate = jav.init(jkey(3), n, t, jcfg,
                      init_pref=jav.contested_init_pref(3, n, t))
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    # Three of the port's rounds fill the windows (the trajectories are
    # held to JAX below); both packages read the same records.
    tstate, _ = tav.run_scan(tstate, tcfg, n_rounds=3, device="cpu")
    jrec = convert.state_to_numpy(tstate)
    want = jadv.policy_ctx(
        jcfg, jvr.VoteRecordState(*(jnp.asarray(x) for x in jrec.records)),
        jnp.asarray(jrec.byzantine), jnp.asarray(jrec.latency_weight))
    got = tadv.policy_ctx(tcfg, tstate.records, tstate.byzantine,
                          tstate.latency_weight)
    if policy == "off":
        assert want is None and got is None
    else:
        assert_leaves_equal(_jax_numpy(want), convert._np_tree(got), "ctx")
    rng = np.random.default_rng(1)
    lie = rng.random((n, 8)) < 0.4
    resp = rng.random((n, 8)) < 0.9
    w = jadv.apply_policy_issue(jcfg, want, jnp.asarray(lie),
                                jnp.asarray(resp))
    g = tadv.apply_policy_issue(tcfg, got, t_(lie), t_(resp))
    for name, wx, gx in zip(("lie", "responded", "withheld"), w, g):
        assert (wx is None) == (gx is None), name
        if gx is not None:
            np.testing.assert_array_equal(np_(wx), gx.numpy(), err_msg=name)
    if policy in ("off", "timing", "split_vote"):
        assert g[0] is not None and g[2] is None


@pytest.mark.parametrize("policy", ["timing", "withhold_near_quorum", "off"])
def test_apply_policy_latency_matches_jax(policy):
    knobs = dict(ASYNC)
    if policy != "off":
        knobs.update(byzantine_fraction=0.5, adversary_policy=policy)
    jcfg, tcfg = _configs(knobs)
    rng = np.random.default_rng(2)
    lat = rng.integers(0, 4, (9, 8)).astype(np.int32)
    lie = rng.random((9, 8)) < 0.4
    withheld = ((rng.random((9, 8)) < 0.3) & lie
                if policy == "withhold_near_quorum" else None)
    want = jadv.apply_policy_latency(
        jcfg, jnp.asarray(lat), jnp.asarray(lie),
        None if withheld is None else jnp.asarray(withheld))
    got = tadv.apply_policy_latency(tcfg, t_(lat), t_(lie),
                                    None if withheld is None else t_(withheld))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(want), got.numpy())
    if policy == "timing":
        assert (got.numpy()[lie] == tcfg.timeout_rounds() - 1).all()
    if policy == "withhold_near_quorum":
        assert (got.numpy()[withheld] == tcfg.timeout_rounds()).all()


def split_ctx_pair(prefs, byz):
    js, je = jadv.honest_split_plane(jnp.asarray(prefs), jnp.asarray(byz))
    ts, te = tadv.honest_split_plane(t_(prefs), t_(byz))
    return (jadv.PolicyCtx(split_t=js, split_even=je),
            tadv.PolicyCtx(split_t=ts, split_even=te))


def test_split_vote_transforms_match_jax():
    """`apply_1d`, `apply_plane` and `apply_draw_planes` under split_vote,
    on planes with tied and untied columns; the k-pass planes equal the
    fused cube's, and ties take the coins of their own stream."""
    jcfg, tcfg = _configs(POLICY_KNOBS["split_vote"])
    rng = np.random.default_rng(4)
    n, k, t = 16, 8, 10
    byz = np.arange(n) < 4
    prefs = rng.random((n, t)) < 0.5
    prefs[4:10, :5] = True                # columns 0-4: 6 yes of 12 honest
    prefs[10:, :5] = False
    jctx, tctx = split_ctx_pair(prefs, byz)
    assert np_(jctx.split_even)[:5].all()
    votes = rng.random((n, k, t)) < 0.5
    lie = rng.random((n, k)) < 0.5
    key = jkey(11)
    want = jadv.apply_draw_planes(key, jnp.asarray(votes), jnp.asarray(lie),
                                  jcfg, jnp.zeros(t, bool), jctx)
    got = tadv.apply_draw_planes(key_words(key), t_(votes), t_(lie), tcfg,
                                 torch.zeros(t, dtype=torch.bool), tctx)
    np.testing.assert_array_equal(np_(want), got.numpy())
    for j in range(k):
        wj = jadv.apply_plane(key, j, jnp.asarray(votes[:, j]),
                              jnp.asarray(lie[:, j]), jcfg,
                              jnp.zeros(t, bool), jctx)
        gj = tadv.apply_plane(key_words(key), j, t_(votes[:, j]),
                              t_(lie[:, j]), tcfg,
                              torch.zeros(t, dtype=torch.bool), tctx)
        np.testing.assert_array_equal(np_(wj), gj.numpy())
        np.testing.assert_array_equal(gj.numpy(), got[:, j].numpy())
    # single decree: a scalar tally, tied and untied
    for p1 in (np.arange(n) % 2 == 0, np.arange(n) < 12):
        jctx1, tctx1 = split_ctx_pair(p1, byz)
        v = rng.random((n, k)) < 0.5
        want = jadv.apply_1d(key, jnp.asarray(v), jnp.asarray(lie), jcfg,
                             jnp.asarray(p1), jctx1)
        got = tadv.apply_1d(key_words(key), t_(v), t_(lie), tcfg, t_(p1),
                            tctx1)
        np.testing.assert_array_equal(np_(want), got.numpy())


@pytest.mark.parametrize("tied", [True, False])
def test_split_vote_tie_flag_matches_jax(tied):
    """`policy_ctx` flags a round with a tie; without one the transforms
    draw no coin and give JAX's bits all the same."""
    jcfg, tcfg = _configs(POLICY_KNOBS["split_vote"])
    rng = np.random.default_rng(7)
    n, k, t = 16 if tied else 17, 8, 12     # 12 or 13 honest rows
    byz = np.arange(n) < 4
    prefs = rng.random((n, t)) < 0.5
    prefs[4:, 0] = np.arange(n - 4) < 6      # 6 yes: a tie of 12
    records = convert.state_to_numpy(tav.init(
        prng.key(0, "cpu"), n, t, tcfg, init_pref=t_(prefs), device="cpu"))
    tctx = tadv.policy_ctx(tcfg, convert._records_from_numpy(
        records.records), t_(byz), None)
    jctx = jadv.policy_ctx(jcfg, jvr.VoteRecordState(
        *(jnp.asarray(x) for x in records.records)), jnp.asarray(byz), None)
    assert tctx.split_tied is bool(np_(jctx.split_even).any()) is tied
    votes = rng.random((n, k, t)) < 0.5
    lie = rng.random((n, k)) < 0.5
    key = jkey(3)
    want = jadv.apply_draw_planes(key, jnp.asarray(votes), jnp.asarray(lie),
                                  jcfg, jnp.zeros(t, bool), jctx)
    got = tadv.apply_draw_planes(key_words(key), t_(votes), t_(lie), tcfg,
                                 torch.zeros(t, dtype=torch.bool), tctx)
    np.testing.assert_array_equal(np_(want), got.numpy())


def test_split_vote_requires_ctx():
    jcfg, tcfg = _configs(POLICY_KNOBS["split_vote"])
    msgs = []
    for adv, key, ones in ((jadv, jkey(0), lambda s: jnp.ones(s, bool)),
                           (tadv, key_words(jkey(0)),
                            lambda s: torch.ones(s, dtype=torch.bool))):
        cfg = jcfg if adv is jadv else tcfg
        with pytest.raises(ValueError, match="PolicyCtx") as err:
            adv.apply_1d(key, ones((2, 2)), ones((2, 2)), cfg, ones((2,)))
        msgs.append(str(err.value))
        with pytest.raises(ValueError, match="PolicyCtx"):
            adv.apply_plane(key, 0, ones((2, 3)), ones((2,)), cfg,
                            ones((3,)), adv.PolicyCtx())
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ trajectories


def check_avalanche(knobs, n=16, t=16, rounds=10, seed=3):
    """Both packages' `run_scan` from one contested JAX init: final state
    and stacked telemetry equal; returns the port's telemetry."""
    jcfg, tcfg = _configs(knobs)
    jstate = jav.init(jkey(seed), n, t, jcfg,
                      init_pref=jav.contested_init_pref(seed, n, t))
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    want, wtel = jav.run_scan(jstate, jcfg, n_rounds=rounds)
    got, gtel = tav.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want), convert.state_to_numpy(got),
                       "state")
    return gtel


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", sorted(POLICY_KNOBS))
def test_avalanche_policy_trajectory_matches_jax(policy, fused):
    tel = check_avalanche(dict(POLICY_KNOBS[policy], finalization_score=16,
                               fused_exchange=fused))
    assert int(tel.votes_applied.sum()) > 0


@pytest.mark.parametrize("policy", ["split_vote", "withhold_near_quorum"])
def test_avalanche_policy_swar_gossip_matches_jax(policy):
    """The swar32 ingest engine and gossip admission under a policy."""
    check_avalanche(dict(POLICY_KNOBS[policy], finalization_score=16,
                         ingest_engine="swar32", gossip=True,
                         drop_probability=0.1), n=20, t=12)


def test_avalanche_majority_vote_under_split_vote_matches_jax():
    check_avalanche(dict(POLICY_KNOBS["split_vote"], finalization_score=16,
                         vote_mode="majority"))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", sorted(ASYNC_POLICY_KNOBS))
def test_avalanche_async_policy_trajectory_matches_jax(policy, engine):
    tel = check_avalanche(dict(ASYNC_POLICY_KNOBS[policy],
                               finalization_score=16,
                               inflight_engine=engine))
    assert int(tel.deliveries.sum()) > 0
    if policy == "withhold_near_quorum":
        assert int(tel.expiries.sum()) > 0


def test_timing_policy_delays_lies_to_pre_expiry_age():
    """Fixed latency 0 under timing: lies deliver at age timeout - 1 and
    none expires, equal to JAX (the coalesced engine: the policy turns
    off its single-age shortcut)."""
    tel = check_avalanche(dict(byzantine_fraction=0.5,
                               adversary_policy="timing",
                               latency_mode="fixed", latency_rounds=0,
                               finalization_score=0x7FFE,
                               inflight_engine="coalesced", **TIMING),
                          n=16, t=8, rounds=6)
    deliveries = tel.deliveries.numpy()
    assert (deliveries[:3] < deliveries[3:].min()).all()
    assert int(tel.expiries.sum()) == 0


def check_dag(knobs, n=16, t=12, rounds=8, seed=2):
    jcfg, tcfg = _configs(knobs)
    jstate = jdag.init(jkey(seed), n, jnp.arange(t, dtype=jnp.int32) // 2,
                       jcfg, n_sets=t // 2, set_size=2)
    tstate = convert.dag_state_from_numpy(_jax_numpy(jstate), device="cpu")
    want, wtel = jdag.run_scan(jstate, jcfg, n_rounds=rounds)
    got, gtel = tdag.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want), convert.dag_state_to_numpy(got),
                       "dag")
    return gtel


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", sorted(POLICY_KNOBS))
def test_dag_policy_trajectory_matches_jax(policy, fused):
    check_dag(dict(POLICY_KNOBS[policy], finalization_score=12,
                   fused_exchange=fused))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", ["timing", "withhold_near_quorum"])
def test_dag_async_policy_trajectory_matches_jax(policy, engine):
    tel = check_dag(dict(ASYNC_POLICY_KNOBS[policy], finalization_score=12,
                         inflight_engine=engine))
    assert int(tel.deliveries.sum()) > 0


def check_snowball(knobs, n=48, rounds=12, seed=9):
    jcfg, tcfg = _configs(knobs)
    jstate = jsb.init(jkey(seed), n, jcfg)
    tstate = convert.family_state_from_numpy("snowball", _jax_numpy(jstate),
                                             device="cpu")
    want, wtel = jsb.run_scan(jstate, jcfg, n_rounds=rounds)
    got, gtel = tsb.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want), convert.family_state_to_numpy(got),
                       "snowball")
    return gtel


@pytest.mark.parametrize("case", ["split_vote", "withhold_near_quorum",
                                  "stake_eclipse", "split_vote_majority"])
def test_snowball_policy_trajectory_matches_jax(case):
    policy = case.replace("_majority", "")
    knobs = dict(POLICY_KNOBS[policy], finalization_score=10)
    if case.endswith("_majority"):
        knobs["vote_mode"] = "majority"
    check_snowball(knobs)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", sorted(ASYNC_POLICY_KNOBS))
def test_snowball_async_policy_trajectory_matches_jax(policy, engine):
    tel = check_snowball(dict(ASYNC_POLICY_KNOBS[policy],
                              finalization_score=10,
                              inflight_engine=engine))
    assert int(tel.deliveries.sum()) > 0


def test_streaming_schedulers_inherit_split_vote():
    """One step of backlog, streaming DAG and node stream under
    split_vote: the policy threads through the wrapped rounds."""
    knobs = dict(POLICY_KNOBS["split_vote"], finalization_score=8)
    jcfg, tcfg = _configs(knobs)
    jstate = jbl.init(jkey(0), 16, 8,
                      jbl.make_backlog(jnp.arange(24, dtype=jnp.int32)), jcfg)
    tstate = convert.backlog_state_from_numpy(_jax_numpy(jstate), device="cpu")
    for _ in range(2):
        jstate, jtel = jax.jit(jbl.step, static_argnames="cfg")(jstate, jcfg)
        tstate, ttel = tbl.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel), "backlog tel")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "backlog")

    sets = jsd.make_set_backlog(jnp.arange(24, dtype=jnp.int32).reshape(12, 2))
    jstate = jsd.init(jkey(0), 16, 4, sets, jcfg)
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")
    for _ in range(2):
        jstate, jtel = jax.jit(jsd.step, static_argnames="cfg")(jstate, jcfg)
        tstate, ttel = tsd.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel), "sdag tel")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.streaming_dag_state_to_numpy(tstate), "sdag")

    ns_knobs = dict(knobs, stake_mode="zipf", registry_nodes=32,
                    active_nodes=16, node_churn_rate=0.1)
    jcfg, tcfg = _configs(ns_knobs)
    jstate = jns.init(jkey(0), 8, jcfg)
    tstate = convert.node_stream_state_from_numpy(_jax_numpy(jstate),
                                                  device="cpu")
    for _ in range(2):
        jstate, jtel = jax.jit(jns.step, static_argnames="cfg")(jstate, jcfg)
        tstate, ttel = tns.step(tstate, tcfg)
    assert_trees_equal(_jax_numpy(jstate),
                       convert.node_stream_state_to_numpy(tstate), "nstream")
    assert int(tstate.sim.round) == 2


@pytest.mark.parametrize("model", ["slush", "snowflake"])
def test_family_under_split_vote_raises_as_jax(model):
    """The family builds no policy context, in both packages: its poll
    refuses split_vote with the same message."""
    jcfg, tcfg = _configs(POLICY_KNOBS["split_vote"])
    jinit, jround = ((jfam.slush_init, jfam.slush_round) if model == "slush"
                     else (jfam.snowflake_init, jfam.snowflake_round))
    tinit, tround = ((tfam.slush_init, tfam.slush_round) if model == "slush"
                     else (tfam.snowflake_init, tfam.snowflake_round))
    with pytest.raises(ValueError, match="PolicyCtx") as jerr:
        jround(jinit(jkey(1), 16, jcfg), jcfg)
    with pytest.raises(ValueError, match="PolicyCtx") as terr:
        tround(tinit(prng.key(1, "cpu"), 16, tcfg, device="cpu"), tcfg)
    assert str(jerr.value) == str(terr.value)


def test_contested_init_pref_from_key_matches_jax():
    for seed, n, t in ((0, 12, 8), (5, 33, 17)):
        keys = jax.random.split(jkey(seed), 3)
        for key in keys:
            want = jav.contested_init_pref_from_key(key, n, t)
            got = tav.contested_init_pref_from_key(key_words(key), n, t)
            np.testing.assert_array_equal(np_(want), got.numpy())


def test_policy_dataclass_replace_keeps_rules():
    """A point config made by `dataclasses.replace` is validated again,
    as the fleet's phase points are."""
    cfg = AvalancheConfig(byzantine_fraction=0.2)
    assert dataclasses.replace(cfg, adversary_policy="split_vote")
    with pytest.raises(ValueError, match="inert"):
        dataclasses.replace(cfg, byzantine_fraction=0.0,
                            adversary_policy="split_vote")


def jax_policy_record(name):
    """The JAX package's run of a policy case (`workload.POLICY_CASES`),
    in the record's form."""
    model, knobs = workload.POLICY_CASES[name]
    cfg = JaxConfig(**knobs)
    n, t = workload.POLICY_SHAPE
    if model == "dag":
        state = jdag.init(jkey(0), n, jnp.arange(t, dtype=jnp.int32) // 2,
                          cfg)
        final, tel = jdag.run_scan(state, cfg,
                                   n_rounds=workload.POLICY_ROUNDS)
        conf = final.base.records.confidence
    else:
        state = jav.init(jkey(0), n, t, cfg,
                         init_pref=jav.contested_init_pref(0, n, t))
        final, tel = jav.run_scan(state, cfg,
                                  n_rounds=workload.POLICY_ROUNDS)
        conf = final.records.confidence
    record = {"finalizations": np_(tel.finalizations).tolist(),
              "votes_applied": np_(tel.votes_applied).tolist()}
    if cfg.async_queries():
        record["expiries"] = np_(tel.expiries).tolist()
    record["finalized_fraction"] = float(np_(jvr.has_finalized(conf,
                                                               cfg)).mean())
    return record


@pytest.mark.parametrize("name", sorted(workload.POLICY_RECORDS))
def test_policy_record_reproduces(name):
    """The JAX package reproduces the committed record, and the port
    does too on one of the case's engines (`chip_smoke.py` runs them
    all on the card)."""
    want = jax_policy_record(name)
    assert want == workload.POLICY_RECORDS[name]
    engine = workload.policy_engines(name)[-1]
    model, state, cfg = workload.policy_state(name, engine, device="cpu")
    run_scan = tdag.run_scan if model == "dag" else tav.run_scan
    final, tel = run_scan(state, cfg, n_rounds=workload.POLICY_ROUNDS,
                          device="cpu")
    records = final.base.records if model == "dag" else final.records
    got = {"finalizations": tel.finalizations.tolist(),
           "votes_applied": tel.votes_applied.tolist()}
    if "expiries" in want:
        got["expiries"] = tel.expiries.tolist()
    got["finalized_fraction"] = float(tvr.has_finalized(
        records.confidence, cfg).double().mean())
    assert got == want
