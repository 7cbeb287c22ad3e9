"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where
`torch.cuda.is_available()` is false (a CUDA kernel has no CPU mode).
Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance 0: records and `changed` compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_avalanche_tpu_torch.config import (AdversaryStrategy, AvalancheConfig,
                                           VoteMode)
from go_avalanche_tpu_torch.examples import recorded
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.ops import adversary
from go_avalanche_tpu_torch.ops import exchange as ex
from go_avalanche_tpu_torch.ops import megakernel as mk
from go_avalanche_tpu_torch.ops import pallas_vote as pv
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

CASES = {
    "base": (dict(), 64, 512),
    "flip": (dict(byzantine_fraction=0.2), 64, 512),
    "oppose": (dict(byzantine_fraction=0.25,
                    adversary_strategy=AdversaryStrategy.OPPOSE_MAJORITY),
               64, 512),
    "k3q2w3": (dict(k=3, quorum=2, window=3), 64, 512),
    "t1184": (dict(), 96, 1184),
    "score7fff": (dict(finalization_score=0x7FFF), 64, 512),
    "k1w3q2": (dict(k=1, window=3, quorum=2), 64, 512),
    "t2080": (dict(), 333, 2080),     # the last block of a row part empty
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, n, t, cfg, device):
    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    wm = (1 << cfg.window) - 1
    counter = np.clip(np.where(rng.random((n, t)) < 0.5,
                               rng.integers(0, 0x8000, (n, t)),
                               cfg.finalization_score
                               - rng.integers(-2, 9, (n, t))), 0, 0x7FFF)
    conf = ((counter << 1) | rng.integers(0, 2, (n, t))).astype(np.uint16)
    recs = vr.VoteRecordState(
        t_(rng.integers(0, 256, (n, t), dtype=np.uint8) & wm),
        t_(rng.integers(0, 256, (n, t), dtype=np.uint8) & wm),
        t_(conf.view(np.int16)))
    return (recs, pack_bool_plane(t_(rng.random((n, t)) < 0.5)),
            t_(rng.integers(0, n, (n, cfg.k)).astype(np.int32)),
            t_(rng.random((n, cfg.k)) < 0.85), t_(rng.random((n, cfg.k)) < 0.4),
            t_(rng.random(t) < 0.5), t_(rng.random((n, t)) < 0.7))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_megakernel_matches_plain_version(case, cuda):
    knobs, n, t = CASES[case]
    cfg = AvalancheConfig(round_engine="megakernel", **knobs)
    args = _inputs(np.random.default_rng(100), n, t, cfg, cuda)
    before = mk.launches
    got_recs, got_changed = mk.fused_round(*args, cfg)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    want_recs, want_changed = mk.fused_round_reference(*args, cfg)
    for g, w in zip((*got_recs, got_changed), (*want_recs, want_changed)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_megakernel_round_matches_phased_round(cuda):
    kw = dict(byzantine_fraction=0.2, gossip=False)
    mega_cfg = AvalancheConfig(round_engine="megakernel", **kw)
    phased_cfg = AvalancheConfig(**kw)
    pref = av.contested_init_pref(3, 128, 256, device=cuda)
    mega = phased = av.init(prng.key(3, cuda), 128, 256, mega_cfg,
                            init_pref=pref, device=cuda)
    for _ in range(6):
        mega, mtel = av.round_step(mega, mega_cfg)
        phased, ptel = av.round_step(phased, phased_cfg)
        assert [int(x) for x in mtel] == [int(x) for x in ptel]
    for g, w in zip((*mega.records, mega.finalized_at, mega.key),
                    (*phased.records, phased.finalized_at, phased.key)):
        assert torch.equal(g, w)


INGEST_CASES = {
    "base": (dict(), 64, 512),
    "k3q2w3": (dict(k=3, quorum=2, window=3), 64, 512),
    "k1w1": (dict(k=1, quorum=1, window=1), 40, 96),
    "score7fff": (dict(finalization_score=0x7FFF), 64, 512),
    "score1": (dict(finalization_score=1, k=5, quorum=4, window=6), 48, 200),
    "ragged": (dict(), 33, 1001),       # N*T % 4 == 1: a ragged last word
    "tiny": (dict(k=4), 3, 7),
    "k1w3q2": (dict(k=1, window=3, quorum=2), 64, 512),
    "k5w6q4score1": (dict(k=5, window=6, quorum=4, finalization_score=1),
                     64, 512),
    "t1180": (dict(), 40, 1180),        # T % 16 != 0: the general path
}
INGEST_KERNELS = {
    "vote_u8": (pv.register_packed_votes_cuda,
                pv.register_packed_votes_plain),
    "vote_swar": (pv.register_packed_votes_cuda_swar,
                  pv.register_packed_votes_swar_plain),
}


def _ingest_inputs(rng, n, t, cfg, device, pack_form, masked, offset=0):
    """One ingest call's inputs; with `offset`, each record plane and the
    mask start that many records into their storage."""
    def t_(a):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if not offset:
            return x
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

    wm = (1 << cfg.window) - 1
    kind = rng.integers(0, 3, (n, t))
    counter = np.where(kind == 0, rng.integers(0, 0x8000, (n, t)),
                       np.where(kind == 1,
                                np.clip(cfg.finalization_score
                                        - rng.integers(-2, 9, (n, t)),
                                        0, 0x7FFF),
                                0x7FFF - rng.integers(0, 2, (n, t))))
    conf = ((counter << 1) | rng.integers(0, 2, (n, t))).astype(np.uint16)
    recs = vr.VoteRecordState(
        t_(rng.integers(0, 256, (n, t), dtype=np.uint8) & wm),
        t_(rng.integers(0, 256, (n, t), dtype=np.uint8) & wm),
        t_(conf.view(np.int16)))
    yes = torch.from_numpy(rng.integers(0, 256, (n, t),
                                        dtype=np.uint8)).to(device)
    col = torch.from_numpy(rng.integers(0, 256, (n, 1),
                                        dtype=np.uint8)).to(device)
    cons = (col.expand(n, t) if pack_form == "stride0"
            else col.expand(n, t).contiguous())
    mask = t_(rng.random((n, t)) < 0.7) if masked else None
    return recs, yes, cons, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(INGEST_KERNELS))
@pytest.mark.parametrize("case", sorted(INGEST_CASES))
@pytest.mark.parametrize("pack_form", ["stride0", "plane"])
@pytest.mark.parametrize("masked", [True, False])
def test_ingest_kernel_matches_plain_version(kernel, case, pack_form, masked,
                                             cuda):
    knobs, n, t = INGEST_CASES[case]
    cfg = AvalancheConfig(**knobs)
    recs, yes, cons, mask = _ingest_inputs(np.random.default_rng(n * t), n,
                                           t, cfg, cuda, pack_form, masked)
    wrapper, plain = INGEST_KERNELS[kernel]
    before = pv.launches[kernel]
    got_recs, got_changed = wrapper(recs, yes, cons, cfg.k, cfg, mask)
    torch.cuda.synchronize()
    assert pv.launches[kernel] == before + 1
    want_recs, want_changed = plain(recs, yes, cons, cfg.k, cfg, mask)
    for g, w in zip((*got_recs, got_changed), (*want_recs, want_changed)):
        assert torch.equal(g, w)
    assert got_changed.view(torch.uint8).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(INGEST_KERNELS))
@pytest.mark.parametrize("pack_form", ["stride0", "plane"])
def test_ingest_kernel_matches_plain_version_off_16_bytes(kernel, pack_form,
                                                          cuda):
    """Record planes and mask 4 records into their storage (4 bytes for
    the uint8 planes, 8 for confidence): each kernel must refuse its
    fast path, which reads 16-byte chunks, and still give the plain
    bits."""
    cfg = AvalancheConfig()
    recs, yes, cons, mask = _ingest_inputs(np.random.default_rng(7), 64, 512,
                                           cfg, cuda, pack_form, True,
                                           offset=4)
    assert recs.votes.data_ptr() % 16 == 4
    wrapper, plain = INGEST_KERNELS[kernel]
    got_recs, got_changed = wrapper(recs, yes, cons, cfg.k, cfg, mask)
    want_recs, want_changed = plain(recs, yes, cons, cfg.k, cfg, mask)
    for g, w in zip((*got_recs, got_changed), (*want_recs, want_changed)):
        assert torch.equal(g, w)


def _ingest_symbols(kernel, recs, yes, cons, cfg, mask):
    """The device kernels one launch of ingest kernel `kernel` ran, by the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        INGEST_KERNELS[kernel][0](recs, yes, cons, cfg.k, cfg, mask)
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if kernel in e.key]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(INGEST_KERNELS))
@pytest.mark.parametrize("n,t,offset,fast", [
    (64, 512, 0, True), (40, 96, 0, True), (40, 1180, 0, False),
    (33, 1001, 0, False), (64, 512, 4, False)])
def test_ingest_kernel_takes_its_fast_path_where_it_can(kernel, n, t, offset,
                                                        fast, cuda):
    """T % 16 == 0 with 16-byte aligned planes and the round's stride-0
    consider pack takes `<kernel>_kernel<K, ...>`; anything else the
    general `<kernel>_kernel_any`.  The wrapper's per-path count names
    the path the profiler saw."""
    cfg = AvalancheConfig(k=3, window=3, quorum=2)
    args = _ingest_inputs(np.random.default_rng(n * t), n, t, cfg, cuda,
                          "stride0", True, offset)
    before = dict(pv.path_launches[kernel])
    symbols = _ingest_symbols(kernel, *args[:3], cfg, args[3])
    assert len(symbols) == 1, symbols
    assert (f"{kernel}_kernel_any" in symbols[0]) != fast, symbols
    assert (f"{kernel}_kernel<3" in symbols[0]) == fast, symbols
    path = "fast" if fast else "any"
    assert pv.path_launches[kernel] == {**before, path: before[path] + 1}


@pytest.mark.cuda
def test_dag_round_on_both_kernels_matches_plain_round(cuda):
    """The DAG round through kernel 1, through kernel 2 and on the CPU's
    plain engines: leaf-equal trajectories and telemetry."""
    cs = torch.arange(48, dtype=torch.int32) // 3
    pref = torch.from_numpy(np.random.default_rng(1).random(48) < 0.5)
    runs = {}
    for engine, device in (("u8", cuda), ("swar32", cuda),
                           ("u8", torch.device("cpu"))):
        cfg = AvalancheConfig(ingest_engine=engine, finalization_score=12,
                              byzantine_fraction=0.1)
        state = dag.init(prng.key(4, device), 64, cs, cfg, init_pref=pref,
                         device=device)
        counts = dict(pv.launches)
        final, tel = dag.run_scan(state, cfg, n_rounds=16, device=device)
        if device.type == "cuda":
            name = "vote_swar" if engine == "swar32" else "vote_u8"
            assert pv.launches[name] == counts[name] + 16
        runs[(engine, device.type)] = (final, tel)
    (ref, ref_tel) = runs[("u8", "cpu")]
    assert int(ref_tel.finalizations.sum()) > 0
    for final, tel in runs.values():
        for g, w in zip(tel, ref_tel):
            assert torch.equal(g.cpu(), w)
        for g, w in zip((*final.base.records, final.base.finalized_at,
                         final.base.alive, final.base.key),
                        (*ref.base.records, ref.base.finalized_at,
                         ref.base.alive, ref.base.key)):
            assert torch.equal(g.cpu(), w)


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (tuple, list)):
            _assert_leaves_equal(g, w)
        elif isinstance(w, torch.Tensor):
            assert torch.equal(g.cpu(), w.cpu())
        else:           # None, or a static int of the DAG state
            assert g == w


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    dict(), dict(byzantine_fraction=0.2, adversary_strategy=(
        AdversaryStrategy.EQUIVOCATE), drop_probability=0.1),
    dict(vote_mode=VoteMode.MAJORITY, churn_probability=0.005, window=3,
         quorum=2, finalization_score=4)])
def test_snowball_on_both_kernels_matches_plain_engine(knobs, cuda):
    """Snowball through ingest kernel 1, kernel 2 (their general path at
    T = 1) and the CPU's plain engines: leaf-equal trajectories."""
    from go_avalanche_tpu_torch.models import snowball

    runs = {}
    for engine, device in (("u8", cuda), ("swar32", cuda),
                           ("u8", torch.device("cpu"))):
        cfg = AvalancheConfig(**{"ingest_engine": engine,
                                 "finalization_score": 16, **knobs})
        state = snowball.init(prng.key(5, device), 1000, cfg,
                              yes_fraction=0.7, device=device)
        counts = dict(pv.launches)
        runs[(engine, device.type)] = snowball.run_scan(state, cfg, 60,
                                                        device=device)
        sequential = cfg.vote_mode is VoteMode.SEQUENTIAL
        if device.type == "cuda":
            name = "vote_swar" if engine == "swar32" else "vote_u8"
            assert pv.launches[name] == counts[name] + 60 * sequential
    ref_final, ref_tel = runs[("u8", "cpu")]
    assert int(ref_tel.finalizations.sum()) > 0
    for final, tel in runs.values():
        _assert_leaves_equal(tel, ref_tel)
        _assert_leaves_equal(final, ref_final)


@pytest.mark.cuda
def test_family_on_cuda_matches_cpu(cuda):
    from go_avalanche_tpu_torch.models import family

    cfg = AvalancheConfig(finalization_score=8, byzantine_fraction=0.1,
                          drop_probability=0.1)
    out = {}
    for device in (cuda, torch.device("cpu")):
        slush = family.slush_run(family.slush_init(prng.key(1, device), 512,
                                                   cfg, device=device),
                                 cfg, 40, device=device)
        flake = family.snowflake_run(family.snowflake_init(
            prng.key(2, device), 256, cfg, device=device), cfg, 500,
            device=device)
        out[device.type] = (slush, flake)
    _assert_leaves_equal(out["cuda"], out["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 4099, 100_000])
def test_weighted_draws_on_cuda_match_cpu(n, cuda):
    """The inverse-CDF samplers and the float paths under them (the CDF,
    `normal`, the zipf stake) give the CPU's bits on the card."""
    from go_avalanche_tpu_torch import stake
    from go_avalanche_tpu_torch.ops import sampling

    w = torch.exp(prng.normal(prng.key(42, "cpu"), (n,)) * 0.5)
    w[::7] = 0.0
    assert torch.equal(prng.normal(prng.key(42, cuda), (n,)).cpu(),
                       prng.normal(prng.key(42, "cpu"), (n,)))
    assert torch.equal(sampling.cumsum_f32(w.to(cuda)).cpu(),
                       sampling.cumsum_f32(w))
    zipf = AvalancheConfig(stake_mode="zipf", stake_zipf_s=1.3)
    assert torch.equal(stake.node_stake(zipf, n, cuda).cpu(),
                       stake.node_stake(zipf, n, "cpu"))
    for seed in (0, 1, 7):
        kc, kh = prng.key(seed, cuda), prng.key(seed, "cpu")
        draws = (
            lambda k, x: sampling.sample_peers_weighted(k, x, n, 8),
            lambda k, x: sampling.sample_peers_hierarchical(k, x, n, 8, 7),
            lambda k, x: sampling.sample_peers_clustered(k, x, min(n, 4099),
                                                         8, 5, 0.8),
            lambda k, x: sampling.sample_peers_distinct(k, n, 8)
        )
        for draw in draws:
            assert torch.equal(draw(kc, w.to(cuda)).cpu(), draw(kh, w))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["u8", "swar32", "megakernel"])
def test_config4_quick_on_cuda_matches_cpu(engine, cuda):
    from go_avalanche_tpu_torch import workload

    finals = []
    for device in (cuda, torch.device("cpu")):
        state, cfg = workload.config4_state(quick=True, device=device)
        if engine == "megakernel":
            cfg = dataclasses.replace(cfg, round_engine="megakernel")
        else:
            cfg = dataclasses.replace(cfg, ingest_engine=engine)
        finals.append(av.run(state, cfg, device=device))
    assert int(finals[1].round) == 17
    _assert_leaves_equal(finals[0], finals[1])


@pytest.mark.cuda
def test_prng_logs_gumbel_and_poisson_on_cuda_match_cpu(cuda):
    """XLA:CPU's float32 log, log1p and lgamma as the port spells them
    (one float32 operation or one float64-emulated fused multiply-add a
    step) give the same bits on the card as on the CPU, and so do the
    Gumbel and Poisson draws."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.uniform(1e-30, 1.0, 200_000), rng.uniform(1.0, 1e6, 200_000),
        rng.uniform(-0.5, 0.5, 200_000)]).astype(np.float32))
    for fn in (prng.log_f32, prng.log1p_f32):      # NaN bits included
        assert torch.equal(fn(x.to(cuda)).cpu().view(torch.int32),
                           fn(x).view(torch.int32))
    g = torch.from_numpy(rng.uniform(0.5, 1e5, 200_000).astype(np.float32))
    assert torch.equal(prng.lgamma_f32(g.to(cuda)).cpu(), prng.lgamma_f32(g))
    for seed in range(5):
        assert torch.equal(prng.gumbel(prng.key(seed, cuda), (100_000,)).cpu(),
                           prng.gumbel(prng.key(seed, "cpu"), (100_000,)))
        for rate in (0.0, 3.0, 9.99, 10.0, 200.0, 1e4):
            lam = torch.tensor(rate, dtype=torch.float32)
            assert int(prng.poisson(prng.key(seed, cuda), lam.to(cuda))) == \
                int(prng.poisson(prng.key(seed, "cpu"), lam))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["u8", "swar32"])
def test_streaming_schedulers_on_cuda_match_cpu(engine, cuda):
    """Configs 5 and 6 at the quick shapes (6 cut to 96 sets), a traffic
    run and a retire-capped run, on the card and on the CPU: every leaf
    equal."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import backlog
    from go_avalanche_tpu_torch.models import streaming_dag as sdg

    finals = []
    for device in (cuda, torch.device("cpu")):
        state, cfg = workload.config5_state(quick=True, device=device,
                                            n_txs=1024)
        cfg = dataclasses.replace(cfg, ingest_engine=engine)
        out = [backlog.run(state, cfg, device=device)]
        traffic = dataclasses.replace(cfg, arrival_mode="poisson",
                                      arrival_rate=12.0,
                                      arrival_backpressure=(0.6, 0.9))
        state = backlog.init(prng.key(0, device), 64, 256,
                             state.backlog, traffic, device=device)
        out.append(backlog.run(state, traffic, device=device))
        shape = dict(workload.QUICK, backlog_sets=96)
        for cap in (None, 8):
            state, cfg = workload.northstar_state(**shape, retire_cap=cap,
                                                  device=device)
            cfg = dataclasses.replace(cfg, ingest_engine=engine)
            out.append(sdg.run_chunked(state, cfg, chunk=40, device=device))
        finals.append(out)
    _assert_leaves_equal(finals[0], finals[1])
    assert bool(finals[1][0].outputs.settled.all())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["u8", "swar32", "megakernel"])
def test_node_stream_on_cuda_matches_cpu(engine, cuda):
    from go_avalanche_tpu_torch.models import node_stream

    cfg = AvalancheConfig(stake_mode="zipf", registry_nodes=4096,
                          active_nodes=256, node_churn_rate=0.05)
    if engine == "megakernel":
        cfg = dataclasses.replace(cfg, round_engine="megakernel")
    else:
        cfg = dataclasses.replace(cfg, ingest_engine=engine)
    finals = []
    for device in (cuda, torch.device("cpu")):
        state = node_stream.init(prng.key(2, device), 512, cfg,
                                 device=device)
        finals.append(node_stream.run_scan(state, cfg, n_rounds=20,
                                           device=device))
    _assert_leaves_equal(finals[0], finals[1])
    assert int(finals[1][1].departed.sum()) > 0


POLICY_KNOBS = {
    "split_vote": dict(byzantine_fraction=0.25, adversary_policy="split_vote"),
    "withhold_near_quorum": dict(byzantine_fraction=0.25,
                                 adversary_policy="withhold_near_quorum",
                                 adversary_margin=3),
    "stake_eclipse": dict(byzantine_fraction=0.25,
                          adversary_policy="stake_eclipse", stake_mode="zipf"),
    "timing": dict(byzantine_fraction=0.25, adversary_policy="timing"),
}
POLICY_ASYNC = dict(latency_mode="geometric", latency_rounds=1,
                    time_step_s=1.0, request_timeout_s=3.0)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,policy", [
    (engine, policy) for engine in ("u8", "swar32")
    for policy in ("split_vote", "withhold_near_quorum", "stake_eclipse")
] + [
    (engine, policy) for engine in ("walk", "walk_earlyout", "coalesced")
    for policy in ("timing", "withhold_near_quorum", "split_vote")])
def test_policy_rounds_on_cuda_match_cpu(engine, policy, cuda):
    """Avalanche rounds under each adaptive-adversary policy on the card
    and on the CPU, per ingest kernel (sync) or delivery engine (async):
    every leaf equal; the sync rounds launch their ingest kernel once a
    round."""
    knobs = dict(POLICY_KNOBS[policy], finalization_score=12)
    if engine in ("u8", "swar32"):
        knobs["ingest_engine"] = engine
    else:
        knobs.update(POLICY_ASYNC, inflight_engine=engine)
    cfg = AvalancheConfig(**knobs)
    rounds = 6
    out = []
    for device in (cuda, torch.device("cpu")):
        state = av.init(prng.key(3, device), 64, 512, cfg,
                        init_pref=av.contested_init_pref(3, 64, 512, device),
                        device=device)
        counts = dict(pv.launches)
        out.append(av.run_scan(state, cfg, n_rounds=rounds, device=device))
        if device.type == "cuda" and engine in ("u8", "swar32"):
            name = "vote_swar" if engine == "swar32" else "vote_u8"
            assert pv.launches[name] == counts[name] + rounds
    _assert_leaves_equal(out[0], out[1])
    assert int(out[1][1].votes_applied.sum()) > 0


@pytest.mark.cuda
def test_fleet_on_cuda_matches_cpu(cuda):
    """`run_fleet` and `run_phase_grid` on the card and on the CPU: the
    same per-trial vectors and rows."""
    from go_avalanche_tpu_torch import fleet

    cfg = AvalancheConfig(finalization_score=12, byzantine_fraction=0.3,
                          adversary_policy="split_vote")
    res = [fleet.run_fleet("snowball", cfg, fleet=4, n_nodes=48,
                           n_rounds=30, device=device)
           for device in (cuda, torch.device("cpu"))]
    for name in ("violations", "settled", "finality_round",
                 "finalized_fraction", "stalled"):
        np.testing.assert_array_equal(getattr(res[0], name),
                                      getattr(res[1], name))
    assert res[0].summary() == res[1].summary()
    base = AvalancheConfig(finalization_score=12, byzantine_fraction=0.2)
    grid = {"adversary_policy": ["off", "split_vote",
                                 "withhold_near_quorum"]}
    rows = [fleet.run_phase_grid("avalanche", base, grid, fleet=2,
                                 n_nodes=32, n_txs=64, n_rounds=12,
                                 device=device)
            for device in (cuda, torch.device("cpu"))]
    assert rows[0] == rows[1]


def _strip_trace(state):
    """`state` (an avalanche state) with its trace leaf set aside."""
    return state._replace(trace=None)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["u8", "swar32", "megakernel"])
def test_trace_and_tap_on_cuda_match_cpu(engine, cuda, tmp_path):
    """The trace plane and the metrics tap written from CUDA tensors: the
    same trace leaf and byte-identical tap and `write_trace` files as the
    CPU run, the rest of the state leaf-equal, and nothing read back in
    the round loop (the tap's drain is the one counted read)."""
    from go_avalanche_tpu_torch import obs, sync
    from go_avalanche_tpu_torch.obs import trace as obs_trace

    knobs = dict(finalization_score=12, metrics_every=1, trace_every=2)
    if engine == "megakernel":
        knobs["round_engine"] = "megakernel"
    else:
        knobs["ingest_engine"] = engine
    cfg = AvalancheConfig(**knobs)
    finals, files = [], []
    for device in (cuda, torch.device("cpu")):
        state = av.with_trace(av.init(
            prng.key(4, device), 64, 512, cfg,
            init_pref=av.contested_init_pref(4, 64, 512, device),
            device=device), cfg, 8)
        tap = tmp_path / f"tap_{device.type}.jsonl"
        reads = sync.reads
        with obs.metrics_sink(tap):
            final, _ = av.run_scan(state, cfg, n_rounds=8, device=device)
            assert sync.reads == reads
        assert sync.reads == reads + 1
        trace_file = tmp_path / f"trace_{device.type}.jsonl"
        with obs.metrics_sink(trace_file) as sink:
            assert obs_trace.write_trace(sink, final.trace) == 4
        finals.append(final)
        files.append((tap.read_bytes(), trace_file.read_bytes()))
    assert files[0] == files[1]
    got, want = (obs_trace.to_host(f.trace) for f in finals)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.cursor, want.cursor)
    _assert_leaves_equal(_strip_trace(finals[0]), _strip_trace(finals[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 3])
def test_trace_clamps_past_its_horizon_on_cuda(stride, cuda):
    """S + 2 emitted rounds into an S-slot buffer on the card: the writes
    past the last slot land on it (no device-side assert), the cursor
    counts every write, as on the CPU."""
    from go_avalanche_tpu_torch.obs import trace as obs_trace

    cfg = AvalancheConfig(finalization_score=12, trace_every=stride)
    slots = 3
    bufs = []
    for device in (cuda, torch.device("cpu")):
        state = av.with_trace(av.init(prng.key(5, device), 32, 256, cfg,
                                      device=device), cfg, slots * stride)
        final, _ = av.run_scan(state, cfg, n_rounds=(slots + 2) * stride,
                               device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        bufs.append(obs_trace.to_host(final.trace))
    assert bufs[0].data.shape[0] == slots and int(bufs[0].cursor) == slots + 2
    np.testing.assert_array_equal(bufs[0].data, bufs[1].data)


@pytest.mark.cuda
def test_fleet_trace_and_watchdog_on_cuda_match_cpu(cuda):
    """The fleet's [F, S, M] trace from trials run on the card equals the
    CPU's, and the watchdog passes a traced DAG run on the card with the
    finalized counts of the CPU run."""
    from go_avalanche_tpu_torch import fleet, obs

    cfg = AvalancheConfig(finalization_score=12, trace_every=1)
    res = [fleet.run_fleet("avalanche", cfg, fleet=3, n_nodes=32, n_txs=64,
                           n_rounds=10, device=device)
           for device in (cuda, torch.device("cpu"))]
    np.testing.assert_array_equal(res[0].trace.data, res[1].trace.data)
    assert res[0].trace_records() == res[1].trace_records()
    counts = []
    for device in (cuda, torch.device("cpu")):
        state = dag.with_trace(dag.init(
            prng.key(0, device), 64, torch.arange(128, dtype=torch.int32)
            // 2, cfg, device=device), cfg, 20)
        wd = obs.Watchdog(cfg)
        seen = []
        for _ in range(20):
            state = dag.round_step(state, cfg)[0]
            seen.append(wd.check(state))
        counts.append(seen)
    assert counts[0] == counts[1] and counts[0][-1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [["--round-engine", "megakernel"], [],
                                    ["--ingest-engine", "swar32"]],
                         ids=["megakernel", "u8", "swar32"])
def test_run_sim_cli_on_cuda_matches_cpu(engine, cuda):
    """`run_sim.main` on the card gives the CPU's result dict, launching
    the engine's kernel once a round."""
    from go_avalanche_tpu_torch import run_sim

    argv = ["--model", "avalanche", "--nodes", "64", "--txs", "128",
            "--k", "8", "--no-gossip", "--finalization-score", "24",
            "--max-rounds", "6", "--json"] + engine
    mk.launches = 0
    for name in pv.launches:
        pv.launches[name] = 0
    got = run_sim.main(argv + ["--device", "cuda"])
    assert mk.launches + sum(pv.launches.values()) == got["rounds"] > 0
    want = run_sim.main(argv + ["--device", "cpu"])
    assert got.pop("backend") == "cuda" and want.pop("backend") == "cpu"
    got.pop("elapsed_s"), want.pop("elapsed_s")
    assert got == want


@pytest.mark.cuda
def test_chunked_checkpoint_resume_on_cuda(cuda, tmp_path):
    """A chunked streaming run on the card saves in the background, is
    killed after its first save, and resumes leaf-equal to the
    uninterrupted run; the checkpoint restores on the CPU too."""
    import time

    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.models import streaming_dag as sdg
    from go_avalanche_tpu_torch.utils import checkpoint as ck

    cfg = AvalancheConfig(finalization_score=16)
    start = sdg.init(prng.key(2, cuda), 64, 8, sdg.make_set_backlog(
        torch.arange(256, dtype=torch.int32).reshape(128, 2)), cfg,
        device=cuda)
    full = sdg.run_chunked(start, cfg, max_rounds=12, chunk=4, device=cuda)
    path = tmp_path / "run.npz"
    seen = []

    class Killed(Exception):
        pass

    def kill(rounds, state):
        seen.append(rounds)
        if len(seen) == 2:
            while not path.exists():
                time.sleep(0.01)
            raise Killed

    with pytest.raises(Killed):
        sdg.run_chunked(start, cfg, max_rounds=12, chunk=4,
                        checkpoint_path=str(path), checkpoint_every_chunks=1,
                        progress=kill, device=cuda)
    resumed = ck.restore_checkpoint(str(path), start, max_transfer_bytes=4096,
                                    device=cuda)
    assert int(resumed.dag.base.round) == 4
    final = sdg.run_chunked(resumed, cfg, max_rounds=12, chunk=4,
                            device=cuda)
    on_cpu = ck.restore_checkpoint(str(path), start, device="cpu")
    for a, b in zip(*(ck._leaves(convert.streaming_dag_state_to_numpy(s))
                      for s in (final, full))):
        np.testing.assert_array_equal(a[1], b[1])
    for a, b in zip(*(ck._leaves(convert.streaming_dag_state_to_numpy(s))
                      for s in (on_cpu, resumed))):
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.cuda
def test_connector_on_cuda_matches_cpu(cuda):
    """The Connector's simulator on the card answers as on the CPU."""
    from go_avalanche_tpu_torch.connector import (ConnectorClient,
                                                  ConnectorServer)

    def session(device):
        with ConnectorServer(device=device) as srv, ConnectorClient(
                *srv.address) as c:
            out = []
            for model in ("avalanche", "dag", "streaming_dag", "backlog"):
                c.sim_init(64, 64, seed=1, k=4, finalization_score=8,
                           model=model)
                out += [tuple(c.sim_run(4)), tuple(c.sim_run(4))]
            c.sim_init(32, 256, model="backlog", window_sets=32,
                       arrival_mode="external", finalization_score=8)
            out += [tuple(c.sim_submit(40)), tuple(c.sim_run(10)),
                    tuple(c.sim_submit(0))]
            return out

    assert session("cuda") == session("cpu")


# ------------------------------------------------------------ sharded


def _sharded_start(n, t, cfg, device, seed=3):
    from go_avalanche_tpu_torch import convert

    pref = av.contested_init_pref(seed, n, t, device="cpu")
    return convert.state_to_numpy(av.init(prng.key(seed, "cpu"), n, t, cfg,
                                          init_pref=pref, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["u8", "swar32"])
def test_sharded_round_on_the_card_matches_the_cpu(engine, cuda):
    """A 1x1 mesh on the card launches the ingest kernel once a round
    and walks the CPU's trajectory."""
    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    cfg = AvalancheConfig(byzantine_fraction=0.2, ingest_engine=engine)
    start = _sharded_start(256, 512, cfg, cuda)
    mesh = make_mesh(1, 1)
    finals = {}
    for device in ("cpu", "cuda"):
        block = sharded.shard_state(convert.state_from_numpy(start, device),
                                    mesh)
        name = "vote_swar" if engine == "swar32" else "vote_u8"
        pv.launches[name] = 0
        block, tel = sharded.run_scan_sharded(mesh, block, cfg, 4)
        if device == "cuda":
            assert pv.launches[name] == 4
        finals[device] = convert.state_to_numpy(block)
    for a, b in zip(finals["cpu"].records, finals["cuda"].records):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_gloo_ranks_sharing_the_card_match_the_cpu(shape, cuda, tmp_path):
    """Two gloo ranks with their blocks on the one card (collectives
    staged through the host) walk the trajectory of the same mesh on
    the CPU."""
    import torch_ranks
    from go_avalanche_tpu_torch.parallel.ranks import RankPool

    knobs = dict(byzantine_fraction=0.2, drop_probability=0.1)
    start = _sharded_start(64, 96, AvalancheConfig(**knobs), cuda)
    pool = RankPool(2, str(tmp_path))
    try:
        on_cpu = pool.run(2, torch_ranks.avalanche_case, start, knobs, shape,
                          "scan", 4, "cpu")
        on_card = pool.run(2, torch_ranks.avalanche_case, start, knobs,
                           shape, "scan", 4, "cuda")
    finally:
        pool.close()
    for a, b in zip(on_cpu[0][0].records, on_card[0][0].records):
        np.testing.assert_array_equal(a, b)
    for name in on_cpu[0][1]:
        np.testing.assert_array_equal(on_cpu[0][1][name], on_card[0][1][name])


@pytest.mark.cuda
def test_sharded_dag_on_the_card_matches_the_cpu(cuda):
    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.parallel import sharded_dag
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    cfg = AvalancheConfig(byzantine_fraction=0.2)
    start = convert.dag_state_to_numpy(dag.init(
        prng.key(1, "cpu"), 128, torch.arange(256, dtype=torch.int32) // 2,
        cfg, device="cpu"))
    mesh = make_mesh(1, 1)
    finals = []
    for device in ("cpu", "cuda"):
        block = sharded_dag.shard_dag_state(
            convert.dag_state_from_numpy(start, device), mesh)
        block = sharded_dag.run_sharded_dag(mesh, block, cfg, max_rounds=60)
        finals.append(convert.dag_state_to_numpy(block))
    for a, b in zip(finals[0].base.records, finals[1].base.records):
        np.testing.assert_array_equal(a, b)
    assert int(finals[0].base.round) == int(finals[1].base.round)


@pytest.mark.cuda
def test_h100_knee_pick_against_the_real_allocation(cuda):
    """The card's knee table reads the card's memory and picks F = 8 at
    16384²; on the allocator, at 1024², 8 stacked trials hold exactly
    their analytic bytes and the in-place scan peaks at the loop model's
    stack plus one round's scratch (measured here), within the
    allocator's rounding."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.obs import knee, resources
    from go_avalanche_tpu_torch.parallel import sharded_fleet

    tab = knee.knee_table("h100", squares=(8192, 16384, 32768))
    assert tab["hbm_bytes"] == torch.cuda.get_device_properties(
        cuda).total_memory
    assert knee.select_fleet_shape("cuda", 1, 16384, 16384,
                                   tables={"h100": tab})["fleet"] == 8
    one, cfg = workload.flagship_state(1024, 1024, device=cuda)
    scratch = resources.memory_record(
        lambda s: av.round_step(s, cfg)[0], one)["temp_bytes"]
    state = resources.footprint(one)["total_bytes"]
    del one
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    stack, cfg = workload.fleet_flagship_state(8, 1024, 1024, device=cuda)
    assert sum(resources._storages(stack).values()) == 8 * state
    torch.cuda.reset_peak_memory_stats()
    sharded_fleet.fleet_scan_program(None, cfg, 1)(stack)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= knee.live_peak(8, state, scratch / state, "loop") \
        + resources.allocator_slack(stack)


@pytest.mark.cuda
def test_flagship_audit_on_the_card_is_clean(cuda):
    """The contract audit of the three flagship engines at 256 x 256 on
    the card: clean, one launch of each engine's kernel, no sync outside
    `sync.py` under CUDA's sync debug mode."""
    from go_avalanche_tpu_torch.analysis import audit

    for name in ("flagship", "flagship_swar32", "flagship_megakernel"):
        program = audit.pinned_program(
            name, dict(audit.PROGRAMS[name], nodes=256, txs=256), cuda)
        failures, rec = audit.audit(program)
        assert failures == []
        assert rec.kernels == program.kernels
        assert rec.debug_syncs == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", recorded.CELLS)
def test_recorded_study_cell_on_the_card(name, cuda):
    """`chip_smoke.py` phase 16 (a): a recorded cell of `examples/out/`
    reproduced on the card at its recorded shape, through `vote_u8` (the
    quorum-dial safety cell on its first seed); the skip semantics
    ingests through the plain engines, by the reference's design."""
    before = pv.launches["vote_u8"]
    row = recorded.replay(name, device="cuda", n_seeds=1)
    assert row["got"] == row["want"], row
    if name == "churn_skip":
        assert pv.launches["vote_u8"] == before
    else:
        assert pv.launches["vote_u8"] > before


# ------------------------------------------------- the exchange kernels

# (set size, T): T not a multiple of 8 where the set size allows, and the
# DAG cell's 10,000 (9,999 for sets of 3).
PACK_CASES = [(c, t) for c, ts in ((1, (13, 10000)), (2, (26, 10000)),
                                   (3, (21, 9999)), (5, (35, 10000)),
                                   (8, (40, 10000)), (16, (48, 10000)))
              for t in ts]


def _confidence(rng, n, t, device):
    """u16 confidence words, half of them drawn from a few values (0, 1,
    0x7FFF, 0x8000, 0xFFFF) so sets hold ties and words the int16 reads
    as negative."""
    words = np.where(rng.random((n, t)) < 0.5,
                     rng.choice([0, 1, 0x7FFF, 0x8000, 0xFFFF], (n, t)),
                     rng.integers(0, 0x10000, (n, t))).astype(np.uint16)
    return torch.from_numpy(words.view(np.int16)).to(device)


def _exchange_cfg(strategy: str, **kw) -> AvalancheConfig:
    return AvalancheConfig(byzantine_fraction=0.2,
                           adversary_strategy=AdversaryStrategy(strategy),
                           **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["flip", "oppose_majority"])
@pytest.mark.parametrize("c,t", PACK_CASES)
def test_prefs_pack_matches_plain_version(c, t, strategy, cuda):
    """Bit for bit against ``pack_bool_plane(preferred_in_set_fixed)``;
    under OPPOSE the minority colours against `minority_plane`, else an
    all-False ``[T]``.  Odd N; a view 2 bytes into its storage takes the
    general path."""
    cfg = _exchange_cfg(strategy)
    rng = np.random.default_rng(c * 100003 + t)
    whole = _confidence(rng, 37, t + 1, cuda)
    for conf in (whole[:, :t].contiguous(),
                 whole.reshape(-1)[1:1 + 37 * t].reshape(37, t)):
        before = ex.launches["prefs_pack"]
        packed, minority = ex.prefs_pack(conf, c, cfg)
        torch.cuda.synchronize()
        assert ex.launches["prefs_pack"] == before + 1
        prefs = dag.preferred_in_set_fixed(conf, c)
        assert torch.equal(packed, pack_bool_plane(prefs))
        if strategy == "oppose_majority":
            assert torch.equal(minority, adversary.minority_plane(prefs))
        else:
            assert minority.shape == (t,) and not minority.any()


@pytest.mark.cuda
def test_prefs_pack_at_the_dag_cells_shape(cuda):
    cfg = _exchange_cfg("oppose_majority")
    conf = _confidence(np.random.default_rng(10), 10000, 10000, cuda)
    packed, minority = ex.prefs_pack(conf, 2, cfg)
    prefs = dag.preferred_in_set_fixed(conf, 2)
    assert torch.equal(packed, pack_bool_plane(prefs))
    assert torch.equal(minority, adversary.minority_plane(prefs))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["flip", "oppose_majority"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n,t", [(37, 2048), (333, 10000), (5, 13)])
def test_vote_packs_matches_plain_version(n, t, k, strategy, cuda):
    """Against `fused_vote_packs`: self draws (draw 0), duplicate draws
    (the last repeats the first), random lie and responded masks."""
    cfg = _exchange_cfg(strategy, k=k, quorum=min(k, 7), window=8)
    rng = np.random.default_rng(n * k + t)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    peers = rng.integers(0, n, (n, k)).astype(np.int32)
    peers[:, 0] = np.arange(n)
    peers[:, -1] = peers[:, 0] if k > 1 else peers[:, -1]
    args = (pack_bool_plane(t_(rng.random((n, t)) < 0.5)), t_(peers),
            t_(rng.random((n, k)) < 0.8), t_(rng.random((n, k)) < 0.4))
    minority = t_(rng.random(t) < 0.5)
    before = ex.launches["vote_packs"]
    got = ex.vote_packs(*args, cfg, minority, t)
    torch.cuda.synchronize()
    assert ex.launches["vote_packs"] == before + 1
    want = ex.fused_vote_packs(*args, None, cfg, minority, t)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["flip", "oppose_majority"])
@pytest.mark.parametrize("fixed", [True, False])
def test_dag_rounds_kernel_route_match_plain_route(fixed, strategy, cuda,
                                                   monkeypatch):
    """20 DAG rounds through the exchange kernels against 20 through the
    plain path on the card: every counter of every round and every leaf.
    A contiguous partition launches both kernels a round, an arbitrary
    one `vote_packs` alone."""
    cfg = _exchange_cfg(strategy)
    n, t = 301, 1000
    cs = torch.arange(t, dtype=torch.int32) // 2
    if not fixed:
        cs = cs[torch.from_numpy(np.random.default_rng(2).permutation(t))]
    state = dag.init(prng.key(5, cuda), n, cs.to(cuda), cfg, n_sets=t // 2,
                     set_size=2 if fixed else None, device=cuda)
    before = dict(ex.launches)
    routed, rtel = state, []
    for _ in range(20):
        routed, tel = dag.round_step(routed, cfg)
        rtel.append([int(x) for x in tel])
    assert {k: ex.launches[k] - before[k] for k in before} == {
        "prefs_pack": 20 if fixed else 0, "vote_packs": 20}
    monkeypatch.setattr(ex, "vote_packs_route", lambda dev, c: False)
    monkeypatch.setattr(ex, "prefs_pack_route", lambda dev, c: False)
    plain, ptel = state, []
    for _ in range(20):
        plain, tel = dag.round_step(plain, cfg)
        ptel.append([int(x) for x in tel])
    assert rtel == ptel
    for g, w in zip((*routed.base.records, routed.base.finalized_at,
                     routed.base.alive, routed.base.key, routed.base.round),
                    (*plain.base.records, plain.base.finalized_at,
                     plain.base.alive, plain.base.key, plain.base.round)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["flip", "oppose_majority"])
def test_exchange_kernels_read_under_gather_prefs(strategy, cuda):
    """Under the profiler every exchange kernel of a DAG round is linked
    to a host op that started inside the round's `gather_prefs` span:
    the rule by which a span's device time is read
    (`round_profile._by_span`).  A bare ctypes launch links to none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = _exchange_cfg(strategy)
    n, t, rounds = 301, 1000, 3
    cs = (torch.arange(t, dtype=torch.int32) // 2).to(cuda)
    state = dag.init(prng.key(5, cuda), n, cs, cfg, n_sets=t // 2,
                     set_size=2, device=cuda)
    state = dag.round_step(state, cfg)[0]     # builds and loads the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            state = dag.round_step(state, cfg)[0]
        torch.cuda.synchronize()
    started, spans, kernels = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0:
            started[e.correlation_id()] = e.start_ns()
            if e.name() == "gather_prefs":
                spans.append((e.start_ns(), e.end_ns()))
        elif (e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()
              and ("prefs_pack_kernel" in e.name()
                   or "vote_packs_kernel" in e.name())):
            kernels.append((e.name(), e.linked_correlation_id()))
    assert len(spans) == rounds
    assert sum("prefs_pack_kernel" in name for name, _ in kernels) == rounds
    assert sum("vote_packs_kernel" in name for name, _ in kernels) == rounds
    for name, linked in kernels:
        at = started.get(linked)
        assert at is not None, f"{name[:60]} is linked to no host op"
        assert any(lo <= at < hi for lo, hi in spans), (
            f"{name[:60]} was launched outside gather_prefs")
