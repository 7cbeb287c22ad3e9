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
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.ops import megakernel as mk
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
