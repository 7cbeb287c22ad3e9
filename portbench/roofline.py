"""The yardstick's peaks, the measured kernels' symbols and the bytes
each kernel needs.

Frozen: a change here changes every roofline share the benchmark has
recorded.

`PEAKS` are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W power limit; a run states the card's own limit beside every share.

The ingest kernels (`csrc/vote_u8.cu`, `csrc/vote_swar.cu`) apply one
round's k votes to every polled record and write new planes, out of
place, so every record of the launch is read and written once.  What
the inputs need:

- a polled record: votes, consider and confidence read (1 + 1 + 2 B),
  the yes pack and the update mask read (1 + 1 B), votes, consider and
  confidence written (1 + 1 + 2 B), the changed flag written (1 B):
  11 B;
- a record the round does not poll: the same without the yes pack, as
  the mask says to pass the record through to the new planes: 10 B;
- the consider pack, one byte a node broadcast over the txs: 1 B a
  node.

At 16384 x 16384 with every record polled that is 2.953e9 B, 0.881 ms
at 3.35 TB/s.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

# The ingest kernels, by a part of their symbols in the profiler's trace.
INGEST_KERNELS = ("vote_u8_kernel", "vote_swar_kernel")

INGEST_BYTES_PER_POLLED_RECORD = 11
INGEST_BYTES_PER_PASSED_RECORD = 10
INGEST_BYTES_PER_NODE = 1


def hbm_bytes_per_s(card: str) -> float:
    """The card's published memory bandwidth; `card` as
    `torch.cuda.get_device_name` gives it, one of `PEAKS`."""
    return PEAKS[card]["hbm_bytes_per_s"]


def ingest_bytes(polled_records: int, records: int, nodes: int) -> int:
    """Bytes one ingest launch needs: `records` records for `nodes`
    nodes, `polled_records` of them polled."""
    if not 0 <= polled_records <= records:
        raise ValueError(f"{polled_records} polled of {records} records")
    return (INGEST_BYTES_PER_POLLED_RECORD * polled_records
            + INGEST_BYTES_PER_PASSED_RECORD * (records - polled_records)
            + INGEST_BYTES_PER_NODE * nodes)


def ingest_bound_s(polled_records: int, records: int, nodes: int,
                   card: str) -> float:
    """The least time one launch could take on `card`: its bytes over
    the peak bandwidth (its integer work, k x 20 operations a record,
    is far below the compute peak)."""
    return ingest_bytes(polled_records, records, nodes) / hbm_bytes_per_s(card)
