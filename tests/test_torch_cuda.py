"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where
`torch.cuda.is_available()` is false (a CUDA kernel has no CPU mode).
Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance 0: records and `changed` compared bit for bit.
"""

import numpy as np
import pytest
import torch

from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import dag
from go_avalanche_tpu_torch import prng
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
}
INGEST_KERNELS = {
    "vote_u8": (pv.register_packed_votes_cuda,
                pv.register_packed_votes_plain),
    "vote_swar": (pv.register_packed_votes_cuda_swar,
                  pv.register_packed_votes_swar_plain),
}


def _ingest_inputs(rng, n, t, cfg, device, pack_form, masked):
    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

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
    yes = t_(rng.integers(0, 256, (n, t), dtype=np.uint8))
    col = t_(rng.integers(0, 256, (n, 1), dtype=np.uint8))
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
