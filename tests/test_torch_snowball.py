"""Whole-trajectory parity of the port's single-decree Snowball with the
JAX one.

Both packages start from one state (the JAX `init`, carried across with
`convert.family_state_from_numpy`) and run the same rounds; every state
leaf and every per-round telemetry scalar must be equal.  The SEQUENTIAL
rounds ingest through `pallas_vote.register_packed_votes_fused`, which
runs its kernel's plain version on CPU tensors.  Tolerance 0.
"""

import jax
import numpy as np
import pytest
import torch

from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch import workload
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.ops import pallas_vote
from test_torch_avalanche import _configs, _jax_numpy, assert_leaves_equal

CASES = {
    "sequential": dict(),
    "majority": dict(vote_mode="majority"),
    "flip": dict(byzantine_fraction=0.2),
    "equivocate": dict(byzantine_fraction=0.2,
                       adversary_strategy="equivocate"),
    "oppose": dict(byzantine_fraction=0.2,
                   adversary_strategy="oppose_majority"),
    "majority_oppose": dict(vote_mode="majority", byzantine_fraction=0.2,
                            adversary_strategy="oppose_majority"),
    "churn_drop": dict(churn_probability=0.05, drop_probability=0.1),
    "distinct_k5": dict(sample_with_replacement=False, k=5, quorum=5,
                        finalization_score=40),
    "skip_absent": dict(skip_absent_votes=True, drop_probability=0.2),
}


def assert_states_equal(jstate, tstate, where):
    want = _jax_numpy(jstate)
    got = convert.family_state_to_numpy(tstate)
    for field in got._fields:
        w, g = getattr(want, field), getattr(got, field)
        if field == "records":
            for leaf in w._fields:
                a, b = getattr(w, leaf), getattr(g, leaf)
                assert a.dtype == b.dtype, (where, leaf)
                np.testing.assert_array_equal(a, b, err_msg=f"{where} {leaf}")
            continue
        assert_leaves_equal(w, g, f"{where} {field}")


def carry(jstate):
    return convert.family_state_from_numpy("snowball", _jax_numpy(jstate),
                                           device="cpu")


@pytest.mark.parametrize("engine", ["u8", "swar32"])
@pytest.mark.parametrize("case", list(CASES))
def test_round_step_trajectory_matches_jax(case, engine):
    jcfg, tcfg = _configs(dict(CASES[case], ingest_engine=engine))
    jstate = jsb.init(jax.random.key(3), 96, jcfg, yes_fraction=0.5)
    tstate = carry(jstate)
    assert_states_equal(jstate, tstate, "init")
    step = jax.jit(lambda s: jsb.round_step(s, jcfg))
    for r in range(30):
        jstate, jtel = step(jstate)
        tstate, ttel = tsb.round_step(tstate, tcfg)
        for field in jtel._fields:
            assert int(getattr(jtel, field)) == int(getattr(ttel, field)), (
                r, field)
    assert_states_equal(jstate, tstate, "round 30")


def test_init_matches_jax():
    for n, byz, yes in ((100, 0.0, 0.5), (64, 0.2, 0.3), (7, 0.5, 0.9)):
        jcfg, tcfg = _configs(dict(byzantine_fraction=byz))
        jstate = jsb.init(jax.random.key(n), n, jcfg, yes_fraction=yes)
        tstate = tsb.init(prng.key(n, "cpu"), n, tcfg, yes_fraction=yes,
                          device="cpu")
        assert_states_equal(jstate, tstate, f"init {n}")


@pytest.mark.parametrize("case", ["sequential", "majority", "flip"])
def test_run_and_run_scan_match_jax(case):
    jcfg, tcfg = _configs(dict(CASES[case], finalization_score=24))
    jstate = jsb.init(jax.random.key(11), 48, jcfg)
    jfinal = jsb.run(jstate, jcfg, max_rounds=200)
    tfinal = tsb.run(carry(jstate), tcfg, max_rounds=200, device="cpu")
    assert_states_equal(jfinal, tfinal, "run")
    jscan, jtel = jsb.run_scan(jstate, jcfg, n_rounds=12)
    tscan, ttel = tsb.run_scan(carry(jstate), tcfg, n_rounds=12,
                               device="cpu")
    assert_states_equal(jscan, tscan, "run_scan")
    for field in jtel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jtel, field)),
                                      getattr(ttel, field).numpy())


def test_sequential_round_goes_through_the_ingest_wrapper(monkeypatch):
    calls = []
    real = pallas_vote.register_packed_votes_fused

    def spy(records, yes_pack, consider_pack, k, cfg, update_mask=None):
        calls.append(tuple(records.votes.shape))
        return real(records, yes_pack, consider_pack, k, cfg, update_mask)

    monkeypatch.setattr(pallas_vote, "register_packed_votes_fused", spy)
    _, tcfg = _configs({})
    state = tsb.init(prng.key(0, "cpu"), 20, tcfg, device="cpu")
    tsb.run_scan(state, tcfg, n_rounds=3, device="cpu")
    assert calls == [(20, 1)] * 3


def test_megakernel_engine_is_rejected_as_in_jax():
    _, tcfg = _configs(dict(round_engine="megakernel"))
    state = tsb.init(prng.key(0, "cpu"), 8, device="cpu")
    with pytest.raises(ValueError, match="megakernel"):
        tsb.round_step(state, tcfg)


def test_config1_quick_matches_jax_and_the_suite():
    from go_avalanche_tpu.config import AvalancheConfig as JaxConfig

    jcfg = JaxConfig()
    jfinal = jsb.run(jsb.init(jax.random.key(0), 64, jcfg, yes_fraction=0.5),
                     jcfg, max_rounds=1000)
    tstate, tcfg = workload.config1_state(quick=True, device="cpu")
    tfinal = tsb.run(tstate, tcfg, max_rounds=1000, device="cpu")
    assert_states_equal(jfinal, tfinal, "config 1 quick")
    assert not bool(tsb.live_unfinished(tfinal, tcfg))
    pref = tfinal.records.confidence & 1
    assert bool((pref == pref[0]).all())
