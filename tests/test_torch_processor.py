"""The port's host API (`types`, `clock`, `net`, `utils/golden`,
`processor`) against the JAX package's, call for call.

The golden vectors and seeded vote streams go through both scalar
oracles; seeded random call scripts drive both `Processor`s in both
`strict_validation` modes and both `node_selection`s on a `StubClock`,
and every return value, status update and pending query must agree.
"""

from __future__ import annotations

import random
import time

import pytest

from go_avalanche_tpu import clock as jclock
from go_avalanche_tpu import config as jconfig
from go_avalanche_tpu import net as jnet
from go_avalanche_tpu import processor as jproc
from go_avalanche_tpu import types as jtypes
from go_avalanche_tpu.utils import golden as jgolden
from go_avalanche_tpu_torch import clock as tclock
from go_avalanche_tpu_torch import config as tconfig
from go_avalanche_tpu_torch import net as tnet
from go_avalanche_tpu_torch import processor as tproc
from go_avalanche_tpu_torch import types as ttypes
from go_avalanche_tpu_torch.utils import golden as tgolden

CONFIGS = [{}, dict(window=4, quorum=3, finalization_score=5),
           dict(window=6, quorum=4, finalization_score=20)]


def _cfgs(**kw):
    return jconfig.AvalancheConfig(**kw), tconfig.AvalancheConfig(**kw)


def test_golden_vectors_through_both_oracles():
    seq_j, seq_t = (jgolden.golden_vector_sequence(),
                    tgolden.golden_vector_sequence())
    assert seq_j == seq_t
    rj, rt = (jgolden.ScalarVoteRecord.new(False),
              tgolden.ScalarVoteRecord.new(False))
    for i, (err, acc, fin, conf) in enumerate(seq_t):
        assert rj.register_vote(err) == rt.register_vote(err), i
        assert (rt.votes, rt.consider, rt.confidence) == (
            rj.votes, rj.consider, rj.confidence), i
        assert (rt.is_accepted(), rt.has_finalized(),
                rt.get_confidence()) == (acc, fin, conf), i
        assert int(rt.status()) == int(rj.status()), i


@pytest.mark.parametrize("knobs", CONFIGS, ids=["default", "w4q3", "w6q4"])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("accepted", [False, True])
def test_replay_matches_reference(knobs, seed, accepted):
    rng = random.Random(seed)
    errs = [rng.choice([0, 0, 0, 1, 1, -1, 0xFFFFFFFF, 7])
            for _ in range(400)]
    cj, ct = _cfgs(**knobs)
    assert (tgolden.replay(accepted, errs, ct)
            == jgolden.replay(accepted, errs, cj))


def test_wire_types_and_constants_match():
    for name in ("NO_NODE", "VOTE_YES", "VOTE_NO", "VOTE_NEUTRAL"):
        assert getattr(ttypes, name) == getattr(jtypes, name)
    for err in (0, 1, -1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF):
        assert ttypes.normalize_err(err) == jtypes.normalize_err(err)
    assert [int(s) for s in ttypes.Status] == [int(s) for s in jtypes.Status]
    assert ttypes.Vote._fields == jtypes.Vote._fields
    assert ttypes.Response._fields == jtypes.Response._fields
    assert ttypes.RequestRecord._fields == jtypes.RequestRecord._fields
    rec = ttypes.RequestRecord(10.0, [ttypes.Inv("tx", 1)])
    assert rec.is_expired(70.5, 60.0) and not rec.is_expired(70.0, 60.0)
    assert isinstance(ttypes.Tx(3), ttypes.Target)
    targets_t = {h: ttypes.Tx(h, score=s) for h, s in ((1, 5), (2, 9), (3, 5))}
    targets_j = {h: jtypes.Tx(h, score=s) for h, s in ((1, 5), (2, 9), (3, 5))}
    invs = [ttypes.Inv("tx", h) for h in (3, 1, 2)]
    assert (ttypes.sort_invs_by_score(invs, targets_t)
            == jtypes.sort_invs_by_score(invs, targets_j))


def test_clock_and_connman():
    for mod in (tclock, jclock):
        c = mod.StubClock(5.0)
        c.advance(2.5)
        assert c.now() == 7.5
    cms = [tnet.Connman(), jnet.Connman()]
    for cm in cms:
        for n in (9, 2, 5):
            cm.AddNode(n, latency_weight=n / 10)
        assert cm.remove_node(5) and not cm.remove_node(5)
    assert cms[0].NodesIDs() == cms[1].NodesIDs() == [2, 9]
    assert cms[0].latency_weight(9) == cms[1].latency_weight(9)
    assert len(cms[0]) == 2 and 2 in cms[0] and 5 not in cms[0]


class _Twin:
    """One call script applied to both packages' processors."""

    def __init__(self, strict: bool, selection: str, seed: int,
                 advance_round: bool):
        knobs = dict(strict_validation=strict, max_element_poll=4,
                     finalization_score=12, request_timeout_s=30.0)
        self.cfg = _cfgs(**knobs)
        self.clocks = (jclock.StubClock(100.0), tclock.StubClock(100.0))
        self.cms = (jnet.Connman(), tnet.Connman())
        self.procs = tuple(
            mod.Processor(cm, cfg, clock=clk, advance_round=advance_round,
                          node_selection=selection, seed=seed)
            for mod, cm, cfg, clk in zip((jproc, tproc), self.cms, self.cfg,
                                         self.clocks))
        self.blocks = ({}, {})

    def both(self, name, *args):
        return [getattr(p, name)(*args) for p in self.procs]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("selection", ["lowest", "random"])
@pytest.mark.parametrize("strict", [False, True], ids=["sim", "strict"])
def test_processor_random_scripts_match(strict, selection, seed):
    rng = random.Random(1000 * seed + 17)
    tw = _Twin(strict, selection, seed, advance_round=seed != 1)
    pj, pt = tw.procs
    checked = 0
    for step in range(700):
        op = rng.random()
        if op < 0.08:
            node = rng.randrange(12)
            for cm in tw.cms:
                cm.add_node(node)
        elif op < 0.10:
            node = rng.randrange(12)
            assert tw.cms[0].remove_node(node) == tw.cms[1].remove_node(node)
        elif op < 0.22:
            h = rng.randrange(40)
            work, acc = rng.randrange(5), rng.random() < 0.6
            valid = rng.random() < 0.9
            got = []
            for mod, p, blocks in zip((jtypes, ttypes), tw.procs,
                                      tw.blocks):
                blocks.setdefault(h, mod.Block(h, work, valid, acc))
                got.append(p.add_target_to_reconcile(blocks[h]))
            assert got[0] == got[1], step
        elif op < 0.25 and tw.blocks[0]:
            h = rng.choice(sorted(tw.blocks[0]))
            for blocks in tw.blocks:
                blocks[h].valid = not blocks[h].valid
        elif op < 0.40:
            a, b = tw.both("event_loop")
            assert a == b
        elif op < 0.47:
            a, b = tw.both("get_invs_for_next_poll")
            assert a == b, step
        elif op < 0.52:
            a, b = tw.both("get_suitable_node_to_query")
            assert a == b, step
        elif op < 0.85:
            pending = sorted(pj._queries)
            assert pending == sorted(pt._queries), step
            if pending and rng.random() < 0.8:
                rnd, node = rng.choice(pending)
                invs = pj._queries[(rnd, node)].invs
                hashes = [inv.target_hash for inv in invs]
                if rng.random() < 0.1 and hashes:
                    hashes = hashes[::-1] + [hashes[0]]
            else:
                rnd, node = rng.randrange(5), rng.randrange(12)
                hashes = [rng.randrange(40) for _ in range(rng.randrange(4))]
            errs = [rng.choice([0, 0, 0, 0, 1, -1]) for _ in hashes]
            updates = ([], [])
            got = [p.register_votes(node, mod.Response(
                       rnd, 0, [mod.Vote(e, h) for e, h in zip(errs, hashes)]),
                       ups)
                   for mod, p, ups in zip((jtypes, ttypes), tw.procs,
                                          updates)]
            assert got[0] == got[1], step
            assert ([(u.hash, int(u.status)) for u in updates[0]]
                    == [(u.hash, int(u.status)) for u in updates[1]]), step
            checked += len(updates[0])
        elif op < 0.90:
            dt = rng.choice([0.5, 5.0, 31.0])
            for clk in tw.clocks:
                clk.advance(dt)
        else:
            h = rng.randrange(40)
            tj, tt = (tw.blocks[0].get(h, jtypes.Block(h, 0, True, True)),
                      tw.blocks[1].get(h, ttypes.Block(h, 0, True, True)))
            assert pj.is_accepted(tj) == pt.is_accepted(tt), step
            try:
                want = pj.get_confidence(tj)
            except KeyError:
                with pytest.raises(KeyError):
                    pt.get_confidence(tt)
            else:
                assert pt.get_confidence(tt) == want, step
        assert pj.get_round() == pt.get_round(), step
        assert pj.outstanding_requests() == pt.outstanding_requests(), step
    assert checked > 0


def test_strict_validation_accepted_and_enforced():
    cfg = tconfig.AvalancheConfig(strict_validation=True)
    clk = tclock.StubClock(0.0)
    cm = tnet.Connman()
    cm.add_node(3)
    p = tproc.Processor(cm, cfg, clock=clk)
    p.add_target_to_reconcile(ttypes.Tx(7))
    p.event_loop()
    invs = p.get_invs_for_next_poll()
    resp = ttypes.Response(0, 0, [ttypes.Vote(0, inv.target_hash)
                                  for inv in invs])
    assert p.register_votes(3, resp, [])
    assert not p.register_votes(3, resp, [])      # consumed
    p.event_loop()
    clk.advance(61.0)
    assert not p.register_votes(3, ttypes.Response(1, 0, resp.votes), [])
    with pytest.raises(ValueError, match="node_selection"):
        tproc.Processor(cm, node_selection="first")


def test_ticker_start_stop_and_aliases():
    cfg = tconfig.AvalancheConfig(time_step_s=0.001)
    cm = tnet.Connman()
    cm.add_node(1)
    p = tproc.Processor(cm, cfg)
    p.add_target_to_reconcile(ttypes.Tx(5))
    assert p.start() and not p.start()
    deadline = time.time() + 5.0
    while p.get_round() == 0 and time.time() < deadline:
        time.sleep(0.002)
    assert p.stop() and not p.stop()
    assert p.get_round() > 0 and p.outstanding_requests() > 0
    for alias, name in (("GetRound", "get_round"),
                        ("AddTargetToReconcile", "add_target_to_reconcile"),
                        ("RegisterVotes", "register_votes"),
                        ("IsAccepted", "is_accepted"),
                        ("GetConfidence", "get_confidence"),
                        ("GetInvsForNextPoll", "get_invs_for_next_poll")):
        assert getattr(tproc.Processor, alias) is getattr(tproc.Processor,
                                                          name)


def test_host_api_exported_like_the_reference():
    import go_avalanche_tpu
    import go_avalanche_tpu_torch

    missing = set(go_avalanche_tpu.__all__) - set(go_avalanche_tpu_torch.__all__)
    assert missing == set()
    assert go_avalanche_tpu_torch.Processor is tproc.Processor
