"""The bytes of the whole-round megakernel (`csrc/megakernel.cu`,
`mega_round_kernel<K, OPPOSE>`), and the least time one launch could
take on the card.

Frozen: a change here changes every `megakernel_roofline` share the
benchmark has recorded.

The kernel gathers the k peers' packed preferences, applies the round's
k votes to every record and writes new planes, out of place, so each
input is read once and each output written once:

- a record: votes, consider and confidence read (1 + 1 + 2 B) with the
  polled flag (1 B); votes, consider and confidence written (1 + 1 + 2
  B) with the changed flag (1 B): 10 B, polled or not, since the kernel
  passes an unpolled record through to the new planes;
- the packed preferences, one bit a record: N x T / 8 B;
- the peers (4 B), responded (1 B) and lie (1 B) planes: 6 B a draw,
  N x k draws;
- the minority bits, one a tx: T / 8 B.

That is `chip_smoke.megakernel_bound`'s count: at 16384 x 16384, k = 8,
2.719e9 B, 0.812 ms at 3.35 TB/s.  The count assumes new planes each
round, as the ingest kernels' does (`roofline.py`); a kernel that
updates the planes in place reads and writes less, and needs the count
redone, by a change to the benchmark, before its share is compared.
"""

from __future__ import annotations

from portbench import roofline

# The kernel, by a part of its symbol in the profiler's trace.
KERNEL = "mega_round_kernel"

BYTES_PER_RECORD = 10
BYTES_PER_DRAW = 6


def megakernel_bytes(nodes: int, txs: int, k: int) -> int:
    """Bytes one launch over ``[nodes, txs]`` records with k draws a
    node needs."""
    if nodes <= 0 or txs <= 0 or not 0 < k <= 8:
        raise ValueError(f"no launch over {nodes} x {txs}, k = {k}")
    return (BYTES_PER_RECORD * nodes * txs + nodes * txs // 8
            + BYTES_PER_DRAW * nodes * k + txs // 8)


def megakernel_bound_s(nodes: int, txs: int, k: int, card: str) -> float:
    """The least time one launch could take on `card`: its bytes over
    the peak bandwidth (its integer work, k vote steps a record, is far
    below the compute peak)."""
    return megakernel_bytes(nodes, txs, k) / roofline.hbm_bytes_per_s(card)
