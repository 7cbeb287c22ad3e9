"""The port's ctypes binding to the native host runtime (`native.py`)
against the JAX package's binding and against the port's `Processor`.

Both bindings load the same `native/build/libavalanche_host.so`; this
file skips only where the JAX twin (`tests/test_native.py`) skips: when
the library cannot be built.
"""

from __future__ import annotations

import random

import pytest

from go_avalanche_tpu import config as jconfig
from go_avalanche_tpu import types as jtypes
from go_avalanche_tpu_torch import config as tconfig
from go_avalanche_tpu_torch import types as ttypes
from go_avalanche_tpu_torch.utils import golden as tgolden

jnative = pytest.importorskip("go_avalanche_tpu.native")
from go_avalanche_tpu_torch import native as tnative  # noqa: E402

try:
    jnative.load_library()
    tnative.load_library()
except (jnative.NativeBuildError, tnative.NativeBuildError) as e:
    pytest.skip(f"native runtime unavailable: {e}", allow_module_level=True)


def test_same_library_path():
    assert tnative.ensure_built() == jnative.ensure_built()


def test_golden_sequence():
    rec = tnative.NativeVoteRecord(False)
    for i, (err, acc, fin, conf) in enumerate(
            tgolden.golden_vector_sequence()):
        rec.register_vote(err)
        assert (rec.is_accepted(), rec.has_finalized(),
                rec.get_confidence()) == (acc, fin, conf), i


@pytest.mark.parametrize("knobs", [{}, dict(window=4, quorum=3,
                                             finalization_score=5)],
                         ids=["default", "w4q3"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("accepted", [False, True])
def test_replay_matches_both_references(knobs, seed, accepted):
    rng = random.Random(seed)
    errs = [rng.choice([0, 0, 0, 1, 1, -1, 0xFFFFFFFF]) for _ in range(500)]
    ct, cj = tconfig.AvalancheConfig(**knobs), jconfig.AvalancheConfig(**knobs)
    got = tnative.native_replay(accepted, errs, ct)
    assert got == jnative.native_replay(accepted, errs, cj)
    assert got == tgolden.replay(accepted, errs, ct)


def test_vote_record_steps_match():
    rng = random.Random(42)
    rt, rj = tnative.NativeVoteRecord(True), jnative.NativeVoteRecord(True)
    for _ in range(400):
        e = rng.choice([0, 1, -1])
        assert rt.register_vote(e) == rj.register_vote(e)
        assert (rt.votes, rt.consider, rt.confidence) == (
            rj.votes, rj.consider, rj.confidence)
        assert int(rt.status()) == int(rj.status())


def _drive(p, mod, rng, strict: bool):
    """A seeded script of every scalar call; returns every result."""
    out = []
    for n in (7, 3, 11):
        p.add_node(n)
    out.append(p.nodes_ids())
    for h in range(1, 9):
        out.append(p.add_target_to_reconcile(h, accepted=h % 3 != 0,
                                             valid=h != 5, score=h % 4))
    out.append(p.add_target_to_reconcile(2, accepted=True))
    p.set_stub_time(10.0)
    for step in range(300):
        op = rng.random()
        if op < 0.2:
            out.append(p.event_loop())
        elif op < 0.3:
            out.append(p.get_invs_for_next_poll())
        elif op < 0.35:
            out.append(p.get_suitable_node_to_query())
        elif op < 0.38:
            out.append(p.invalidate(rng.randrange(1, 9)))
        elif op < 0.9:
            invs = p.get_invs_for_next_poll()
            if not strict and rng.random() < 0.3:
                invs = invs[::-1]
            votes = [mod.Vote(rng.choice([0, 0, 0, 1, -1]), h) for h in invs]
            ups: list = []
            rnd = max(p.get_round() - 1, 0)
            node = rng.choice([3, 7, 11])
            out.append(p.register_votes(node, mod.Response(rnd, 0, votes),
                                        ups))
            out.append([(u.hash, int(u.status)) for u in ups])
        else:
            p.set_stub_time(10.0 + step)
        out.append((p.get_round(), p.outstanding_requests()))
        h = rng.randrange(1, 9)
        out.append(p.is_accepted(h))
        try:
            out.append(p.get_confidence(h))
        except KeyError:
            out.append("KeyError")
    return out


@pytest.mark.parametrize("selection", ["lowest", "random"])
@pytest.mark.parametrize("strict", [False, True], ids=["sim", "strict"])
def test_native_processor_matches_jax_binding(strict, selection):
    kw = dict(strict_validation=strict, max_element_poll=3,
              finalization_score=10)
    with tnative.NativeProcessor(tconfig.AvalancheConfig(**kw),
                                 node_selection=selection, seed=5) as pt, \
            jnative.NativeProcessor(jconfig.AvalancheConfig(**kw),
                                    node_selection=selection,
                                    seed=5) as pj:
        got = _drive(pt, ttypes, random.Random(9), strict)
        want = _drive(pj, jtypes, random.Random(9), strict)
    assert got == want


def test_native_processor_matches_port_processor():
    """One vote stream through the port's native and Python engines."""
    from go_avalanche_tpu_torch.net import Connman
    from go_avalanche_tpu_torch.processor import Processor

    rng = random.Random(7)
    errs = [rng.choice([0, 0, 1, -1]) for _ in range(500)]
    cm = Connman()
    cm.add_node(1)
    py = Processor(cm)
    py.add_target_to_reconcile(ttypes.Block(65, 99, True, True))
    py.add_target_to_reconcile(ttypes.Block(66, 5, True, False))
    py_up, nat_up = [], []
    with tnative.NativeProcessor() as nat:
        nat.add_node(1)
        nat.add_target_to_reconcile(65, accepted=True, valid=True, score=99)
        nat.add_target_to_reconcile(66, accepted=False, valid=True, score=5)
        assert nat.get_invs_for_next_poll() == [
            inv.target_hash for inv in py.get_invs_for_next_poll()]
        for e in errs:
            resp = ttypes.Response(0, 0, [ttypes.Vote(e, 65),
                                          ttypes.Vote(-e, 66)])
            assert (py.register_votes(1, resp, py_up)
                    == nat.register_votes(1, resp, nat_up))
        for h in (65, 66):
            assert py.is_accepted(ttypes.Tx(h)) == nat.is_accepted(h)
    assert nat_up == py_up


def test_closed_processor_raises():
    p = tnative.NativeProcessor()
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.get_round()
    with pytest.raises(ValueError, match="node_selection"):
        tnative.NativeProcessor(node_selection="first")
