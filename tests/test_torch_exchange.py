"""The port's peer exchange and gossip admission against the JAX reference.

Fused == legacy == JAX for the vote packs under every static adversary
strategy, and for the gossip scatter with duplicate peer draws (which
must OR, not overwrite).  Tolerance 0: uint8 planes compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import bitops as jbits
from go_avalanche_tpu.ops import exchange as jex
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.ops import bitops, exchange

STRATEGIES = ["flip", "oppose_majority", "equivocate"]


@pytest.mark.parametrize("t", [1, 8, 13, 64])
def test_pack_unpack_match_jax(t):
    rng = np.random.default_rng(t)
    x = rng.random((5, 3, t)) < 0.5
    packed = bitops.pack_bool_plane(torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.asarray(jbits.pack_bool_plane(jnp.asarray(x))), packed.numpy())
    np.testing.assert_array_equal(bitops.unpack_bool_plane(packed, t).numpy(),
                                  x)
    b = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jbits.popcount8(jnp.asarray(b))),
        bitops.popcount8(torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [3, 8])
def test_vote_packs_fused_legacy_jax_agree(strategy, k):
    kw = dict(k=k, byzantine_fraction=0.3)
    jcfg = JaxConfig(adversary_strategy=JaxStrategy(strategy), **kw)
    tcfg = AvalancheConfig(adversary_strategy=AdversaryStrategy(strategy),
                           **kw)
    rng = np.random.default_rng(k)
    n, t = 20, 37
    prefs = rng.random((n, t)) < 0.5
    peers = rng.integers(0, n, (n, k)).astype(np.int32)
    responded = rng.random((n, k)) < 0.8
    lie = rng.random((n, k)) < 0.4
    minority = rng.random(t) < 0.5
    seed = 11 + k
    jargs = (jbits.pack_bool_plane(jnp.asarray(prefs)), jnp.asarray(peers),
             jnp.asarray(responded), jnp.asarray(lie), jax.random.key(seed),
             jcfg, jnp.asarray(minority), t)
    targs = (bitops.pack_bool_plane(torch.from_numpy(prefs)),
             torch.from_numpy(peers), torch.from_numpy(responded),
             torch.from_numpy(lie), prng.key(seed, device="cpu"), tcfg,
             torch.from_numpy(minority), t)
    want = [np.asarray(x) for x in jex.fused_vote_packs(*jargs)]
    for engine in (exchange.fused_vote_packs, exchange.legacy_vote_packs):
        got = engine(*targs)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("t", [16, 21])
def test_gossip_heard_with_duplicate_draws(t):
    rng = np.random.default_rng(t)
    n, k = 12, 6
    peers = rng.integers(0, 4, (n, k)).astype(np.int32)   # many duplicates
    polled = (rng.random((n, t)) < 0.3).astype(np.uint8)
    want = np.asarray(jex.fused_gossip_heard(jnp.asarray(peers),
                                             jnp.asarray(polled)))
    np.testing.assert_array_equal(
        want, np.asarray(jex.legacy_gossip_heard(jnp.asarray(peers),
                                                 jnp.asarray(polled))))
    tp, tpol = torch.from_numpy(peers), torch.from_numpy(polled)
    for fused in (True, False):
        got = exchange.gossip_heard(tp, tpol,
                                    AvalancheConfig(fused_exchange=fused))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(want, got.numpy())


# ------------------------------------------ the kernel routes (CPU side)

ROUTE_CASES = [("flip", "off"), ("oppose_majority", "off"),
               ("equivocate", "off"), ("flip", "split_vote"),
               ("flip", "withhold_near_quorum"),
               ("oppose_majority", "stake_eclipse")]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("strategy,policy", ROUTE_CASES)
def test_kernel_routes_are_a_rule_of_device_engine_strategy_policy(
        device, fused, strategy, policy):
    stake = "zipf" if policy == "stake_eclipse" else "off"
    cfg = AvalancheConfig(fused_exchange=fused, byzantine_fraction=0.25,
                          adversary_strategy=AdversaryStrategy(strategy),
                          adversary_policy=policy, stake_mode=stake)
    dev = torch.device(device)
    on_card = device == "cuda"
    assert exchange.vote_packs_route(dev, cfg) == (
        on_card and fused and strategy != "equivocate"
        and policy != "split_vote")
    assert exchange.prefs_pack_route(dev, cfg) == (
        on_card and policy != "split_vote")


def _dag_state(cfg, fixed: bool):
    from go_avalanche_tpu_torch.models import dag

    n, t = 24, 40
    cs = torch.arange(t, dtype=torch.int32) // 2
    if fixed:
        return dag.init(prng.key(7, device="cpu"), n, cs, cfg, n_sets=t // 2,
                        set_size=2, device="cpu")
    cs = torch.from_numpy(np.random.default_rng(3).permutation(
        cs.numpy()).astype(np.int32))
    return dag.init(prng.key(7, device="cpu"), n, cs, cfg, n_sets=t // 2,
                    device="cpu")


def _pretend_card(monkeypatch):
    """Route CPU tensors as the card would, with the kernels' plain
    versions standing in for them; returns the stand-ins' call counts."""
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import adversary

    card = torch.device("cuda")
    vote_route, prefs_route = (exchange.vote_packs_route,
                               exchange.prefs_pack_route)
    calls = {"prefs_pack": 0, "vote_packs": 0}

    def prefs_pack(confidence, set_size, cfg):
        calls["prefs_pack"] += 1
        prefs = dag.preferred_in_set_fixed(confidence, set_size)
        minority = torch.zeros(prefs.shape[1], dtype=torch.bool)
        if cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY:
            minority = adversary.minority_plane(prefs)
        return bitops.pack_bool_plane(prefs), minority

    def vote_packs(packed_prefs, peers, responded, lie, cfg, minority_t, t):
        calls["vote_packs"] += 1
        return exchange.fused_vote_packs(packed_prefs, peers, responded,
                                         lie, None, cfg, minority_t, t)

    monkeypatch.setattr(exchange, "vote_packs_route",
                        lambda dev, cfg: vote_route(card, cfg))
    monkeypatch.setattr(exchange, "prefs_pack_route",
                        lambda dev, cfg: prefs_route(card, cfg))
    monkeypatch.setattr(exchange, "prefs_pack", prefs_pack)
    monkeypatch.setattr(exchange, "vote_packs", vote_packs)
    return calls


DAG_ROUTES = {   # name -> (config knobs, fixed partition, kernel calls)
    "honest": (dict(), True, (3, 3)),
    "flip": (dict(byzantine_fraction=0.25), True, (3, 3)),
    "oppose": (dict(byzantine_fraction=0.25,
                    adversary_strategy=AdversaryStrategy.OPPOSE_MAJORITY),
               True, (3, 3)),
    "equivocate": (dict(byzantine_fraction=0.25,
                        adversary_strategy=AdversaryStrategy.EQUIVOCATE),
                   True, (3, 0)),
    "split_vote": (dict(byzantine_fraction=0.25,
                        adversary_policy="split_vote"), True, (0, 0)),
    "legacy": (dict(fused_exchange=False), True, (3, 0)),
    "arbitrary": (dict(), False, (0, 3)),
}


@pytest.mark.parametrize("name", sorted(DAG_ROUTES))
def test_dag_round_routes_as_on_the_card(name, monkeypatch):
    """Three DAG rounds routed as on the card (the kernels' plain
    stand-ins counted) equal three plain rounds leaf for leaf; the
    stand-ins run exactly where the routes send them."""
    from go_avalanche_tpu_torch.models import dag

    knobs, fixed, (want_prefs, want_votes) = DAG_ROUTES[name]
    cfg = AvalancheConfig(**knobs)
    plain = routed = _dag_state(cfg, fixed)
    for _ in range(3):
        plain, ptel = dag.round_step(plain, cfg)
    calls = _pretend_card(monkeypatch)
    for _ in range(3):
        routed, rtel = dag.round_step(routed, cfg)
    assert calls == {"prefs_pack": want_prefs, "vote_packs": want_votes}
    assert [int(x) for x in rtel] == [int(x) for x in ptel]
    for g, w in zip((*routed.base.records, routed.base.finalized_at,
                     routed.base.key),
                    (*plain.base.records, plain.base.finalized_at,
                     plain.base.key)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fixed", [True, False])
def test_cpu_rounds_launch_no_exchange_kernel(fixed):
    """On CPU tensors the round keeps the plain path: no launch, and no
    plain route counted (the counter counts the card's calls)."""
    from go_avalanche_tpu_torch.models import dag

    cfg = AvalancheConfig(byzantine_fraction=0.25)
    before = dict(exchange.launches), dict(exchange.plain_routes)
    state = _dag_state(cfg, fixed)
    for _ in range(2):
        state = dag.round_step(state, cfg)[0]
    assert (exchange.launches, exchange.plain_routes) == before


def test_megakernel_reference_never_takes_the_kernel_route(monkeypatch):
    from go_avalanche_tpu_torch.ops import megakernel
    from go_avalanche_tpu_torch.ops import voterecord as vr

    calls = _pretend_card(monkeypatch)
    cfg = AvalancheConfig(round_engine="megakernel", byzantine_fraction=0.2)
    rng = np.random.default_rng(4)
    n, t = 16, 64
    records = vr.init_state(torch.from_numpy(rng.random(t) < 0.5)[None, :]
                            .expand(n, t).contiguous())
    megakernel.fused_round_reference(
        records, bitops.pack_bool_plane(torch.from_numpy(
            rng.random((n, t)) < 0.5)),
        torch.from_numpy(rng.integers(0, n, (n, 8)).astype(np.int32)),
        torch.ones((n, 8), dtype=torch.bool),
        torch.from_numpy(rng.random((n, 8)) < 0.3),
        torch.zeros(t, dtype=torch.bool), torch.ones((n, t), dtype=torch.bool),
        cfg)
    assert calls["vote_packs"] == 0


def test_kernel_wrappers_refuse_before_any_launch():
    cfg = AvalancheConfig()
    before = dict(exchange.launches)
    with pytest.raises(ValueError, match="must divide"):
        exchange.prefs_pack(torch.zeros((4, 9), dtype=torch.int16), 2, cfg)
    with pytest.raises(ValueError, match="uint8 packing"):
        exchange.vote_packs(torch.zeros((4, 1), dtype=torch.uint8),
                            torch.zeros((4, 9), dtype=torch.int32),
                            torch.zeros((4, 9), dtype=torch.bool),
                            torch.zeros((4, 9), dtype=torch.bool), cfg,
                            torch.zeros(8, dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="bytes a row"):
        exchange.vote_packs(torch.zeros((4, 2), dtype=torch.uint8),
                            torch.zeros((4, 8), dtype=torch.int32),
                            torch.zeros((4, 8), dtype=torch.bool),
                            torch.zeros((4, 8), dtype=torch.bool), cfg,
                            torch.zeros(8, dtype=torch.bool), 8)
    assert exchange.launches == before


@pytest.mark.parametrize("strategy", ["flip", "oppose_majority"])
def test_kernel_calls_run_inside_a_torch_op(strategy, monkeypatch):
    """The profiler places a device kernel under the innermost torch op
    open when it was launched, and a bare ctypes call opens none: each
    kernel's C entry runs inside `_Launch`, once a wrapper call, with
    its status checked (a stand-in entry on the CPU)."""
    import contextlib
    import types

    from torch.profiler import ProfilerActivity, profile

    entered = []
    monkeypatch.setattr(exchange, "_kernel",
                        lambda name: lambda *args: entered.append(name) or 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(exchange, "launches", dict.fromkeys(
        exchange.launches, 0))
    cfg = AvalancheConfig(byzantine_fraction=0.25,
                          adversary_strategy=AdversaryStrategy(strategy))
    n, t = 6, 16
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exchange.prefs_pack(torch.zeros((n, t), dtype=torch.int16), 2, cfg)
        exchange.vote_packs(torch.zeros((n, t // 8), dtype=torch.uint8),
                            torch.zeros((n, 8), dtype=torch.int32),
                            torch.ones((n, 8), dtype=torch.bool),
                            torch.zeros((n, 8), dtype=torch.bool), cfg,
                            torch.zeros(t, dtype=torch.bool), t)
    ops = [e.name() for e in prof.profiler.kineto_results.events()]
    assert entered == ["prefs_pack", "vote_packs"]
    assert ops.count("_Launch") == 2
    assert exchange.launches == {"prefs_pack": 1, "vote_packs": 1}
    monkeypatch.setattr(exchange, "_kernel", lambda name: lambda *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        exchange.prefs_pack(torch.zeros((n, t), dtype=torch.int16), 2, cfg)
