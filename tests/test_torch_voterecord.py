"""The port's vote-record ops against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 0: every output is an integer plane compared bit for bit
(confidence as uint16).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu.utils.golden import golden_vector_sequence
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import voterecord as vr


def random_records(rng, shape, cfg):
    """Vote windows inside the window mask; confidence counters mixing
    uniform values, the finalization edge and the 0x7FFF saturation."""
    wm = (1 << cfg.window) - 1
    votes = rng.integers(0, 256, shape, dtype=np.uint8) & wm
    consider = rng.integers(0, 256, shape, dtype=np.uint8) & wm
    kind = rng.integers(0, 4, shape)
    counter = np.where(
        kind == 0, rng.integers(0, 0x8000, shape),
        np.where(kind == 1,
                 np.clip(cfg.finalization_score - rng.integers(-2, 9, shape),
                         0, 0x7FFF),
                 np.where(kind == 2, 0x7FFF - rng.integers(0, 3, shape),
                          rng.integers(0, 4, shape))))
    confidence = ((counter << 1) | rng.integers(0, 2, shape)).astype(np.uint16)
    return votes, consider, confidence


def jax_state(votes, consider, confidence):
    return jvr.VoteRecordState(jnp.asarray(votes), jnp.asarray(consider),
                               jnp.asarray(confidence))


def torch_state(votes, consider, confidence):
    return vr.VoteRecordState(torch.from_numpy(votes.copy()),
                              torch.from_numpy(consider.copy()),
                              torch.from_numpy(confidence.view(np.int16).copy()))


def assert_same(jstate, jchanged, tstate, tchanged):
    np.testing.assert_array_equal(np.asarray(jstate.votes),
                                  tstate.votes.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.consider),
                                  tstate.consider.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.confidence),
                                  tstate.confidence.numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(jchanged), tchanged.numpy())


CONFIGS = {
    "base": dict(),
    "k3q2w3": dict(k=3, quorum=2, window=3),
    "k5q4w6": dict(k=5, quorum=4, window=6),
    "score1": dict(finalization_score=1),
    "score7fff": dict(finalization_score=0x7FFF),
    "skip_absent": dict(skip_absent_votes=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("masked", [False, True])
def test_register_packed_votes_matches_jax(name, masked):
    kw = CONFIGS[name]
    jcfg, tcfg = JaxConfig(**kw), AvalancheConfig(**kw)
    rng = np.random.default_rng(sorted(CONFIGS).index(name) * 2 + masked)
    shape = (24, 40)
    recs = random_records(rng, shape, tcfg)
    yes_pack = rng.integers(0, 256, shape, dtype=np.uint8)
    consider_pack = rng.integers(0, 256, shape, dtype=np.uint8)
    mask = rng.random(shape) < 0.6 if masked else None
    js, jc = jvr.register_packed_votes(
        jax_state(*recs), jnp.asarray(yes_pack), jnp.asarray(consider_pack),
        tcfg.k, jcfg, None if mask is None else jnp.asarray(mask))
    ts, tc = vr.register_packed_votes_engine(
        torch_state(*recs), torch.from_numpy(yes_pack),
        torch.from_numpy(consider_pack), tcfg.k, tcfg,
        None if mask is None else torch.from_numpy(mask))
    assert_same(js, jc, ts, tc)


@pytest.mark.parametrize("name", ["base", "k5q4w6", "score7fff"])
def test_register_vote_matches_jax(name):
    kw = CONFIGS[name]
    jcfg, tcfg = JaxConfig(**kw), AvalancheConfig(**kw)
    rng = np.random.default_rng(7)
    shape = (16, 33)
    recs = random_records(rng, shape, tcfg)
    err = rng.integers(-2, 3, shape).astype(np.int32)
    mask = rng.random(shape) < 0.7
    js, jc = jvr.register_vote(jax_state(*recs), jnp.asarray(err), jcfg,
                               jnp.asarray(mask))
    ts, tc = vr.register_vote(torch_state(*recs), torch.from_numpy(err),
                              tcfg, torch.from_numpy(mask))
    assert_same(js, jc, ts, tc)


def test_status_and_accessors_match_jax():
    rng = np.random.default_rng(3)
    cfg = AvalancheConfig()
    _, _, confidence = random_records(rng, (8, 64), cfg)
    jconf = jnp.asarray(confidence)
    tconf = torch.from_numpy(confidence.view(np.int16).copy())
    np.testing.assert_array_equal(np.asarray(jvr.status(jconf)),
                                  vr.status(tconf, cfg).numpy())
    np.testing.assert_array_equal(np.asarray(jvr.get_confidence(jconf)),
                                  vr.get_confidence(tconf).numpy())
    np.testing.assert_array_equal(np.asarray(jvr.has_finalized(jconf)),
                                  vr.has_finalized(tconf, cfg).numpy())


def test_golden_sequence():
    """The reference suite's scripted sequence (`avalanche_test.go`)."""
    state = vr.init_state(torch.zeros((), dtype=torch.bool))
    for i, (err, acc, fin, conf) in enumerate(golden_vector_sequence()):
        state, _ = vr.register_vote(state, torch.tensor(err))
        assert bool(vr.is_accepted(state.confidence)) == acc, f"step {i}"
        assert bool(vr.has_finalized(state.confidence)) == fin, f"step {i}"
        assert int(vr.get_confidence(state.confidence)) == conf, f"step {i}"


@pytest.mark.parametrize("votes,finalized", [(133, False), (134, True)])
def test_unanimous_yes_finalizes_at_vote_134(votes, finalized):
    state = vr.init_state(torch.ones(64, dtype=torch.bool))
    yes = torch.zeros(64, dtype=torch.int32)
    changed_any = torch.zeros(64, dtype=torch.bool)
    for _ in range(votes):
        state, changed = vr.register_vote(state, yes)
        changed_any |= changed
    assert bool(vr.has_finalized(state.confidence).all()) == finalized
    assert bool(changed_any.all()) == finalized


def test_saturated_counter_does_not_wrap():
    cfg = dataclasses.replace(AvalancheConfig(), finalization_score=0x7FFF)
    conf = torch.tensor([(0x7FFF << 1) | 1], dtype=torch.int32).to(torch.int16)
    state = vr.VoteRecordState(torch.tensor([0xFF], dtype=torch.uint8),
                               torch.tensor([0xFF], dtype=torch.uint8), conf)
    state, changed = vr.register_packed_votes(
        state, torch.tensor([0xFF], dtype=torch.uint8),
        torch.tensor([0xFF], dtype=torch.uint8), 8, cfg)
    assert int(vr.get_confidence(state.confidence)) == 0x7FFF
    assert bool(vr.is_accepted(state.confidence))
    assert bool(changed)   # score == ceiling re-reports finalization


def test_packed_votes_reject_k_above_8():
    state = vr.init_state(torch.zeros(4, dtype=torch.bool))
    pack = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"k must be in \(0, 8\]"):
        vr.register_packed_votes(state, pack, pack, 9)
