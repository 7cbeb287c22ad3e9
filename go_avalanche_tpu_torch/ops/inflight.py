"""The in-flight query ring — `go_avalanche_tpu/ops/inflight.py`.

The reference Processor is asynchronous: every poll is an outstanding
query (`processor.go:235-243`), responses arrive when the network
delivers them, and requests older than `request_timeout_s` are reaped
unanswered (`processor.go:61-122`).  This module gives the ``[N, T]``
models and single-decree Snowball that lifecycle:

  * each round's k polls per node are ENQUEUED into a ring of depth
    ``timeout_rounds() + 1`` (`InflightState`), stamped with a
    per-(querier, draw) latency in rounds (`draw_latency`: fixed,
    geometric, coupled to the `latency_weight` plane, or a cluster-pair
    RTT matrix);
  * the DELIVERY pass walks the ring oldest age first each round: an
    entry whose latency equals its age gathers the responder's
    round-start preference and ingests through the three-plane
    `voterecord.register_packed_votes_present`; an entry still pending
    at age ``timeout_rounds()`` EXPIRES unanswered (it registers nothing
    under `cfg.skip_absent_votes`, else a delivered neutral);
  * the FAULT SCRIPT applies at send time: latency spikes add rounds
    (`apply_latency_spikes`), cuts (partitions, regional outages, static
    or drawn per simulation by `draw_fault_params`) stamp the
    never-delivers sentinel (`partition_cut`), and churn bursts toggle
    the alive plane (`apply_churn_bursts`).

Latency 0 (`latency_mode="fixed"`, `latency_rounds=0`) gives the
synchronous round's bits: the just-enqueued entry delivers in the same
round, reading the same preference plane with the same keys
(`_delivery_key`).  Three delivery engines give the same bits
(`cfg.inflight_engine`):

  walk          — every age, every round (`deliver_multi`, `deliver_1d`);
  walk_earlyout — the walk, skipping an age with nothing present; the
                  test is a host read per age (`sync.read`);
  coalesced     — the whole ring's masks at once, then only the active
                  ages: under fixed latency the one age that can
                  register is known on the host (`_static_single_age`,
                  no read), otherwise the per-age flags come back in one
                  host read per round (`sync.read_flags`).  Its
                  poll-mask plane is bit-packed (`packed_polled_width`).

An inactive age registers nothing on any engine, so each skip is a speed
choice only.  Everything here is plain PyTorch on the tensors' device;
no kernel of the JAX package lies on this path (the reference's own
present-plane ingest is plain jnp).  Every delivery engine takes the
issuing round's adversary-policy context (`ctx`, `ops/adversary.py`); the
timing and withhold policies stamp per-draw latencies, so under them the
coalesced drain has no single static age.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from go_avalanche_tpu_torch import prng, sync
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import adversary, exchange
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import (pack_bool_plane, pack_draws,
                                               popcount8, unpack_bool_plane)
from go_avalanche_tpu_torch.ops.sampling import cluster_ids

# fold_in constant deriving the latency stream from the round's sampling
# key, so turning latency on never perturbs another stream.
_LAT_FOLD = 0x1A7E
# fold_in constant deriving the stochastic fault-parameter stream from the
# simulation's init key.
_FAULT_PARAM_FOLD = 0x57CA
# fold_in constant of the churn-burst stream, folded into the churn key.
_BURST_FOLD = 0x0B57


class FaultParams(NamedTuple):
    """Realized parameters of the config's stochastic fault events
    (`cfg.stochastic_events()`), drawn once per simulation by
    `draw_fault_params`; int32 vectors indexed by the script order of
    each kind."""

    cut_start: torch.Tensor     # [Ec] stochastic_partition starts
    cut_end: torch.Tensor       # [Ec] end-exclusive heals
    cut_split: torch.Tensor     # [Ec] realized node-split index
    spike_start: torch.Tensor   # [Es] stochastic_spike starts
    spike_end: torch.Tensor     # [Es]
    spike_extra: torch.Tensor   # [Es] realized extra rounds
    region_start: torch.Tensor  # [Er] stochastic_regional_outage windows
    region_end: torch.Tensor    # [Er]
    region_cluster: torch.Tensor  # [Er] realized severed cluster


def _stochastic_split(cfg: AvalancheConfig, n_global: int,
                      frac: torch.Tensor) -> torch.Tensor:
    """Node-split index of a realized float32 partition fraction: the
    same floor(x + 0.5) cluster snap and interior clamps as
    `_partition_split`, one float32 operation at a time."""
    if cfg.n_clusters > 1:
        c = torch.floor(frac * cfg.n_clusters + 0.5).to(torch.int32)
        c = c.clamp(1, cfg.n_clusters - 1)
        return torch.div(c * n_global + cfg.n_clusters - 1, cfg.n_clusters,
                         rounding_mode="floor").to(torch.int32)
    return torch.floor(frac * n_global).to(torch.int32).clamp(1, n_global - 1)


def draw_fault_params(cfg: AvalancheConfig, key: torch.Tensor,
                      n_global: int) -> Optional[FaultParams]:
    """Realize the config's stochastic fault events from the init key;
    None when the script schedules none.  Per event, from
    ``split(fold_in(fold_in(key, 0x57CA), i), 3)``: start ~ U{lo..hi},
    length ~ U{lo..hi} (end = start + length), and the kind's parameter
    (a float32 frac ~ U(lo, hi) resolved to a split index, an extra
    latency or a cluster, each ~ U{lo..hi})."""
    events = cfg.stochastic_events()
    if not events:
        return None
    key = prng.fold_in(key, _FAULT_PARAM_FOLD)
    cut = {"start": [], "end": [], "split": []}
    spike = {"start": [], "end": [], "extra": []}
    region = {"start": [], "end": [], "cluster": []}
    for i, ev in enumerate(events):
        ks, kl, kp = prng.split(prng.fold_in(key, i), 3)
        (slo, shi), (llo, lhi) = ev[1], ev[2]
        start = prng.randint(ks, (), int(slo), int(shi) + 1)
        length = prng.randint(kl, (), int(llo), int(lhi) + 1)
        if ev[0] == "stochastic_partition":
            flo, fhi = ev[3]
            frac = prng.uniform(kp, (), float(flo), float(fhi))
            cut["start"].append(start)
            cut["end"].append(start + length)
            cut["split"].append(_stochastic_split(cfg, n_global, frac))
        elif ev[0] == "stochastic_regional_outage":
            clo, chi = ev[3]
            region["start"].append(start)
            region["end"].append(start + length)
            region["cluster"].append(prng.randint(kp, (), int(clo),
                                                  int(chi) + 1))
        else:                                   # stochastic_spike
            elo, ehi = ev[3]
            spike["start"].append(start)
            spike["end"].append(start + length)
            spike["extra"].append(prng.randint(kp, (), int(elo),
                                               int(ehi) + 1))

    def stack(xs):
        if not xs:
            return torch.zeros((0,), dtype=torch.int32, device=key.device)
        return torch.stack(xs).to(torch.int32)

    return FaultParams(cut_start=stack(cut["start"]),
                       cut_end=stack(cut["end"]),
                       cut_split=stack(cut["split"]),
                       spike_start=stack(spike["start"]),
                       spike_end=stack(spike["end"]),
                       spike_extra=stack(spike["extra"]),
                       region_start=stack(region["start"]),
                       region_end=stack(region["end"]),
                       region_cluster=stack(region["cluster"]))


class InflightState(NamedTuple):
    """Ring of pending queries, ``[D, rows, ...]`` planes with
    D = ``timeout_rounds() + 1``.  Slot ``r % D`` holds the queries
    sent in round r; an entry's age in round r' is ``r' - r``.

    `polled` is the send-time update mask: bool ``[D, rows, T]`` for the
    walk engines, uint8 ``[D, rows, packed_polled_width(T)]`` bit-packed
    for the coalesced engine, bool ``[D, rows]`` for Snowball either way.
    `lat` is clipped to ``[0, timeout_rounds()]``; the top value is the
    never-delivers sentinel.
    """

    peers: torch.Tensor      # int32 [D, rows, k] global peer ids
    lat: torch.Tensor        # int32 [D, rows, k] delivery age
    responded: torch.Tensor  # bool [D, rows, k] send-time alive/drop/self
    lie: torch.Tensor        # bool [D, rows, k] send-time lie mask
    polled: torch.Tensor     # see the class docstring


def enabled(cfg: AvalancheConfig) -> bool:
    """Is the in-flight ring on for this config?"""
    return cfg.async_queries()


def ring_depth(cfg: AvalancheConfig) -> int:
    """Slots in the ring: ages ``0 .. timeout_rounds()`` inclusive."""
    return cfg.timeout_rounds() + 1


def packed_polled_width(t: int, tx_shards: int = 1) -> int:
    """Bytes in the coalesced engine's bit-packed poll-mask plane: each
    of `tx_shards` contiguous tx blocks packs into ``ceil(t_local / 8)``
    bytes (``ceil(t / 8)`` with one shard)."""
    if tx_shards < 1 or t % tx_shards:
        raise ValueError(f"t={t} must divide into tx_shards={tx_shards}")
    return tx_shards * (-(-(t // tx_shards) // 8))


def repack_polled_for_shards(ring: Optional[InflightState], t: int,
                             tx_shards: int) -> Optional[InflightState]:
    """Re-lay a packed ring built for one shard for a tx-sharded mesh.

    `init` packs the poll-mask plane with the one-shard layout
    (``ceil(t/8)`` bytes); on a mesh whose per-shard width is not a
    multiple of 8 each tx shard packs its own columns into
    ``ceil(t_local/8)`` bytes (`packed_polled_width`).  The input must
    carry the one-shard layout.  A no-op where the two layouts are the
    same (``t/tx_shards`` a multiple of 8), for an unpacked ring (the
    walk engines) and for None.  The test is on alignment, not byte
    width: at t=26 over 2 shards both layouts take 4 bytes yet place
    the columns differently."""
    if ring is None or ring.polled.dtype != torch.uint8:
        return ring
    if tx_shards == 1 or (t // tx_shards) % 8 == 0:
        return ring
    pw = packed_polled_width(t, tx_shards)
    lead = tuple(ring.polled.shape[:-1])
    unpacked = unpack_bool_plane(ring.polled, t)
    blocks = unpacked.reshape(*lead, tx_shards, t // tx_shards)
    return ring._replace(polled=pack_bool_plane(blocks).reshape(*lead, pw))


def init_ring(cfg: AvalancheConfig, rows: int, t: Optional[int] = None,
              device="cuda") -> InflightState:
    """Empty ring on `device`: every slot pre-expired (lat = sentinel)
    with an all-zero update mask, so untouched slots register nothing.
    `t` None gives Snowball's bool ``[D, rows]`` mask."""
    d, k = ring_depth(cfg), cfg.k
    if t is None:
        polled = torch.zeros((d, rows), dtype=torch.bool, device=device)
    elif cfg.inflight_engine == "coalesced":
        polled = torch.zeros((d, rows, packed_polled_width(t)),
                             dtype=torch.uint8, device=device)
    else:
        polled = torch.zeros((d, rows, t), dtype=torch.bool, device=device)
    return InflightState(
        peers=torch.zeros((d, rows, k), dtype=torch.int32, device=device),
        lat=torch.full((d, rows, k), cfg.timeout_rounds(),
                       dtype=torch.int32, device=device),
        responded=torch.zeros((d, rows, k), dtype=torch.bool, device=device),
        lie=torch.zeros((d, rows, k), dtype=torch.bool, device=device),
        polled=polled,
    )


def _row_ids(rows: int, row_offset, device) -> torch.Tensor:
    return torch.arange(rows, dtype=torch.int32, device=device) + row_offset


@functools.lru_cache(maxsize=8)
def _rtt_table(matrix, device) -> torch.Tensor:
    """The ``[C, C]`` RTT matrix as int32 on `device`, filled there (no
    host-to-device copy, which would wait for the card) and kept."""
    return torch.stack([torch.stack([
        torch.full((), int(v), dtype=torch.int32, device=device)
        for v in row]) for row in matrix])


def draw_latency(key: torch.Tensor, cfg: AvalancheConfig,
                 peers: torch.Tensor, latency_weight: torch.Tensor,
                 n_global: int, row_offset=0) -> torch.Tensor:
    """Per-(querier, draw) response latency in rounds, int32 ``[rows, k]``
    clipped to ``[0, timeout_rounds()]``.

    fixed     — every draw takes `cfg.latency_rounds` ("none" reaches
                here only when a cut or spike turned the ring on: 0);
    geometric — ``floor(log1p(-u) / log1p(-p))`` in float32 with
                p = 1 / (1 + latency_rounds), u ~ U[0, 1) from
                ``fold_in(key, 0x1A7E)``; `prng.log1p_f32` is XLA:CPU's
                own log1p and the divisor is rounded to float32 first,
                as jax's weak typing does;
    weighted  — ``round(latency_rounds * (wmax - w[peer]) /
                max(wmax - wmin, 1e-9))``, round half to even;
    rtt       — ``cfg.rtt_matrix[cluster(querier)][cluster(peer)]``.

    `key` is the round's sampling key."""
    key = prng.fold_in(key, _LAT_FOLD)
    timeout = cfg.timeout_rounds()
    if cfg.latency_mode in ("none", "fixed"):
        base = cfg.latency_rounds if cfg.latency_mode == "fixed" else 0
        return torch.full(tuple(peers.shape), min(base, timeout),
                          dtype=torch.int32, device=peers.device)
    if cfg.latency_mode == "rtt":
        matrix = _rtt_table(cfg.rtt_matrix, peers.device)
        qc = cluster_ids(_row_ids(peers.shape[0], row_offset, peers.device),
                         cfg.n_clusters, n_global)
        pc = cluster_ids(peers, cfg.n_clusters, n_global)
        return matrix[qc.long()[:, None], pc.long()].clamp(0, timeout)
    if cfg.latency_mode == "geometric":
        if cfg.latency_rounds == 0:
            return torch.zeros(tuple(peers.shape), dtype=torch.int32,
                               device=peers.device)
        p = 1.0 / (1.0 + cfg.latency_rounds)
        u = prng.uniform(key, tuple(peers.shape))
        denom = torch.full((), math.log1p(-p), dtype=torch.float32,
                           device=peers.device)
        lat = torch.floor(prng.log1p_f32(-u) / denom).to(torch.int32)
        return lat.clamp(0, timeout)
    # weighted
    w = latency_weight[peers.long()]
    wmax = latency_weight.max()
    wmin = latency_weight.min()
    floor_ = torch.full((), 1e-9, dtype=torch.float32, device=peers.device)
    scale = (wmax - w) / torch.maximum(wmax - wmin, floor_)
    lat = torch.round(cfg.latency_rounds * scale).to(torch.int32)
    return lat.clamp(0, timeout)


def _partition_split(cfg: AvalancheConfig, n_global: int,
                     frac: float) -> int:
    """Static node-index split point of a partition event, snapped to
    the nearest interior cluster boundary on a clustered topology
    (floor(x + 0.5), the first id of that cluster)."""
    if cfg.n_clusters > 1:
        split_cluster = int(math.floor(frac * cfg.n_clusters + 0.5))
        split_cluster = max(1, min(split_cluster, cfg.n_clusters - 1))
        return -(-split_cluster * n_global // cfg.n_clusters)
    return max(1, min(int(math.floor(frac * n_global)), n_global - 1))


def _window(round_: torch.Tensor, start, end) -> torch.Tensor:
    return (round_ >= start) & (round_ < end)


def partition_cut(cfg: AvalancheConfig, round_: torch.Tensor, row_offset,
                  peers: torch.Tensor, n_global: int,
                  fault_params: Optional[FaultParams] = None
                  ) -> Optional[torch.Tensor]:
    """Bool ``[rows, k]``: draws severed by any cut event active this
    round (querier and peer on opposite sides of a partition's split, or
    exactly one endpoint in an outage's cluster); None when the merged
    script schedules no cut.  Stochastic cuts read their realized window
    and split from `fault_params`."""
    events = cfg.cut_events()
    n_sto = len(cfg.stochastic_cut_events())
    n_reg = len(cfg.stochastic_region_events())
    if not events and not n_sto and not n_reg:
        return None
    qids = _row_ids(peers.shape[0], row_offset, peers.device)
    cut = torch.zeros(tuple(peers.shape), dtype=torch.bool,
                      device=peers.device)
    for kind, start, end, param in events:
        active = _window(round_, start, end)
        if kind == "partition":
            split = _partition_split(cfg, n_global, param)
            qside, pside = qids < split, peers < split
        else:                                   # regional_outage
            qside = cluster_ids(qids, cfg.n_clusters, n_global) == param
            pside = cluster_ids(peers, cfg.n_clusters, n_global) == param
        cut = cut | (active & (qside[:, None] != pside))
    if (n_sto or n_reg) and fault_params is None:
        raise ValueError(
            "stochastic cut events need the realized FaultParams drawn "
            "at init (state.fault_params) — the caller must thread it "
            "through (every model round does)")
    for i in range(n_sto):
        active = _window(round_, fault_params.cut_start[i],
                         fault_params.cut_end[i])
        split = fault_params.cut_split[i]
        cut = cut | (active & ((qids < split)[:, None] != (peers < split)))
    if n_reg:
        qc = cluster_ids(qids, cfg.n_clusters, n_global)
        pc = cluster_ids(peers, cfg.n_clusters, n_global)
        for i in range(n_reg):
            active = _window(round_, fault_params.region_start[i],
                             fault_params.region_end[i])
            region = fault_params.region_cluster[i]
            cut = cut | (active & ((qc == region)[:, None] != (pc == region)))
    return cut


def apply_latency_spikes(lat: torch.Tensor, cfg: AvalancheConfig,
                         round_: torch.Tensor,
                         fault_params: Optional[FaultParams] = None
                         ) -> torch.Tensor:
    """Add every active latency_spike's extra rounds to this round's
    send-time draws, clipped back to ``[0, timeout_rounds()]`` (a spike
    past the timeout turns into the never-delivers sentinel)."""
    events = cfg.spike_events()
    n_sto = len(cfg.stochastic_spike_events())
    if not events and not n_sto:
        return lat
    zero = torch.zeros((), dtype=torch.int32, device=lat.device)
    extra = zero
    for _, start, end, rounds_ in events:
        extra = extra + torch.where(_window(round_, start, end),
                                    torch.full_like(zero, rounds_), zero)
    if n_sto and fault_params is None:
        raise ValueError(
            "stochastic_spike events need the realized FaultParams drawn "
            "at init (state.fault_params) — the caller must thread it "
            "through (every model round does)")
    for i in range(n_sto):
        active = _window(round_, fault_params.spike_start[i],
                         fault_params.spike_end[i])
        extra = extra + torch.where(active, fault_params.spike_extra[i], zero)
    return (lat + extra).clamp(0, cfg.timeout_rounds())


def apply_faults(lat: torch.Tensor, cfg: AvalancheConfig,
                 round_: torch.Tensor, row_offset, peers: torch.Tensor,
                 n_global: int,
                 fault_params: Optional[FaultParams] = None) -> torch.Tensor:
    """The fault script's send-time pass: latency spikes, then cuts
    (a severed draw takes the timeout sentinel and expires unanswered)."""
    lat = apply_latency_spikes(lat, cfg, round_, fault_params)
    cut = partition_cut(cfg, round_, row_offset, peers, n_global,
                        fault_params)
    if cut is None:
        return lat
    return torch.where(cut, torch.full_like(lat, cfg.timeout_rounds()), lat)


# The reference's back-compat spelling (`ops/inflight.py:610`), from
# when the only schedulable fault was the single partition; the same
# contract as `apply_faults`.
apply_partition = apply_faults


def apply_churn_bursts(alive: torch.Tensor, cfg: AvalancheConfig,
                       round_: torch.Tensor,
                       key: torch.Tensor) -> torch.Tensor:
    """Apply every churn_burst event: at its round each row toggles
    dead <-> alive with probability `frac`, from
    ``fold_in(fold_in(key, 0x0B57), i)`` on the round's churn key."""
    for i, (_, r, frac) in enumerate(cfg.churn_burst_events()):
        k = prng.fold_in(prng.fold_in(key, _BURST_FOLD), i)
        toggle = prng.bernoulli(k, frac, tuple(alive.shape))
        alive = alive ^ (toggle & (round_ == r))
    return alive


def enqueue(ring: InflightState, round_: torch.Tensor, peers: torch.Tensor,
            lat: torch.Tensor, responded: torch.Tensor, lie: torch.Tensor,
            polled: torch.Tensor) -> InflightState:
    """A new ring with this round's queries in slot ``round_ % D``; a
    packed poll-mask plane (coalesced engine) packs `polled` first."""
    d = ring.peers.shape[0]
    slot = torch.remainder(round_.to(torch.int64), d).reshape(1)
    if ring.polled.dtype == torch.uint8 and polled.dtype != torch.uint8:
        polled = pack_bool_plane(polled)

    def upd(plane, entry):
        return plane.index_copy(0, slot, entry.to(plane.dtype)[None])

    return InflightState(peers=upd(ring.peers, peers), lat=upd(ring.lat, lat),
                         responded=upd(ring.responded, responded),
                         lie=upd(ring.lie, lie),
                         polled=upd(ring.polled, polled))


def _delivery_key(key: torch.Tensor, d: int) -> torch.Tensor:
    """Per-age adversary key: the round key itself at age 0 (latency-0
    parity with the synchronous round), ``fold_in(key, d)`` older."""
    return key if d == 0 else prng.fold_in(key, d)


def _slot_entry(ring: InflightState, slot: torch.Tensor) -> InflightState:
    """The ring's planes at one slot (a one-element device index, so no
    host read)."""
    return InflightState(*(plane.index_select(0, slot)[0] for plane in ring))


def _walk_ages(ring: InflightState, cfg: AvalancheConfig,
               round_: torch.Tensor, earlyout: bool):
    """Yield ``(d, entry, consider, present)`` for every ring age, oldest
    first (``timeout_rounds() .. 0``): the slot's planes and the age's
    delivery masks.  With
    `earlyout` an age with nothing present is skipped, its test one host
    read (`sync.read`)."""
    timeout = cfg.timeout_rounds()
    depth = timeout + 1
    for d in range(timeout, -1, -1):
        slot = torch.remainder(round_.to(torch.int64) - d + depth,
                               depth).reshape(1)
        entry = _slot_entry(ring, slot)
        zeros = torch.zeros_like(entry.responded)
        deliver = entry.lat == d if d != timeout else zeros
        expire = entry.lat >= timeout if d == timeout else zeros
        consider = entry.responded & deliver
        present = deliver | expire
        if cfg.skip_absent_votes:
            present = present & consider
        if earlyout and not sync.read(present.any()):
            continue
        yield d, entry, consider, present


def _freeze_mask(polled: torch.Tensor, records: vr.VoteRecordState,
                 cfg: AvalancheConfig,
                 live_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The age's update mask: the stored poll mask, minus records
    finalized while the query was in flight, minus dead queriers."""
    mask = polled & ~vr.has_finalized(records.confidence, cfg)
    if live_rows is not None:
        mask = mask & (live_rows[:, None] if mask.ndim == 2 else live_rows)
    return mask


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 count as the int32 the reference's sum wraps to."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def deliver_multi(ring: InflightState, records: vr.VoteRecordState,
                  cfg: AvalancheConfig, packed_prefs: torch.Tensor,
                  minority_t: torch.Tensor, key: torch.Tensor,
                  round_: torch.Tensor, t: int,
                  live_rows: Optional[torch.Tensor] = None,
                  earlyout: bool = False,
                  ctx: Optional[adversary.PolicyCtx] = None) -> Tuple:
    """One round's delivery and expiry pass for the multi-target models,
    every age oldest first (``timeout_rounds() .. 0``): delivered
    entries gather `packed_prefs`, the round-start preference plane;
    expiring ones ingest their absence.  Each age's update mask is the
    stored poll mask minus records finalized in flight and, with
    `live_rows` (the round-start alive plane), dead queriers.  With
    `earlyout` (`deliver_multi_earlyout`) an age with nothing present is
    skipped.  `ctx` is the issuing round's adversary-policy context
    (None with the policy off).

    Returns ``(records, changed, votes_applied)``; `votes_applied` is
    the int32 count of delivered non-neutral ingests, wrapped as the
    reference's int32 sum wraps."""
    changed = torch.zeros(records.votes.shape, dtype=torch.bool,
                          device=records.votes.device)
    votes = torch.zeros((), dtype=torch.int64, device=changed.device)
    for d, entry, consider, present in _walk_ages(ring, cfg, round_,
                                                  earlyout):
        yes_pack, consider_pack = exchange.gather_vote_packs(
            packed_prefs, entry.peers, consider, entry.lie,
            _delivery_key(key, d), cfg, minority_t, t, ctx)
        update_mask = _freeze_mask(entry.polled, records, cfg, live_rows)
        records, ch = vr.register_packed_votes_present(
            records, yes_pack, consider_pack, pack_draws(present)[:, None],
            cfg.k, cfg, update_mask=update_mask)
        changed = changed | ch
        votes = votes + (popcount8(consider_pack).to(torch.int32)
                         * update_mask).sum(dtype=torch.int64)
    return records, changed, _wrap_i32(votes)


def deliver_multi_earlyout(*args, **kwargs) -> Tuple:
    """`deliver_multi`, skipping an age whose slot has nothing present;
    the test is one host read per age (`sync.read`)."""
    return deliver_multi(*args, earlyout=True, **kwargs)


def deliver_1d(ring: InflightState, records: vr.VoteRecordState,
               cfg: AvalancheConfig, prefs: torch.Tensor, key: torch.Tensor,
               round_: torch.Tensor,
               live_rows: Optional[torch.Tensor] = None,
               earlyout: bool = False,
               ctx: Optional[adversary.PolicyCtx] = None) -> Tuple:
    """`deliver_multi` for single-decree Snowball (``[N]`` records): the
    response gather is a row gather of the round-start ``[N]``
    preferences plus the 1-D adversary transform.  Returns
    ``(records, changed)``."""
    changed = torch.zeros(records.votes.shape, dtype=torch.bool,
                          device=records.votes.device)
    for d, entry, consider, present in _walk_ages(ring, cfg, round_,
                                                  earlyout):
        votes = adversary.apply_1d(_delivery_key(key, d),
                                   prefs[entry.peers.long()], entry.lie,
                                   cfg, prefs, ctx)
        update_mask = _freeze_mask(entry.polled, records, cfg, live_rows)
        records, ch = vr.register_packed_votes_present(
            records, pack_draws(votes), pack_draws(consider),
            pack_draws(present), cfg.k, cfg, update_mask=update_mask)
        changed = changed | ch
    return records, changed


def deliver_1d_earlyout(*args, **kwargs) -> Tuple:
    """`deliver_1d` with the per-age skip of `deliver_multi_earlyout`."""
    return deliver_1d(*args, earlyout=True, **kwargs)


# ---------------------------------------------------------------------------
# coalesced: one ring drain.


def _static_single_age(cfg: AvalancheConfig) -> Optional[int]:
    """The one ring age that can ever register under this config, or
    None when that is not known on the host.  With fixed latency (or a
    uniform RTT matrix) and no cut, spike or stochastic event, every
    entry carries the same latency ``min(latency, timeout)``: only that
    age delivers, or, at the timeout, only the expiry age registers.  An
    invariant of rings populated under the same config."""
    if cfg.cut_events() or cfg.spike_events() or cfg.stochastic_events():
        return None
    if cfg.adversary_policy in ("timing", "withhold_near_quorum"):
        return None
    if cfg.latency_mode == "fixed":
        return min(cfg.latency_rounds, cfg.timeout_rounds())
    if cfg.latency_mode == "rtt":
        entries = {entry for row in cfg.rtt_matrix for entry in row}
        if len(entries) == 1:
            return min(entries.pop(), cfg.timeout_rounds())
    return None


class _RingAgeView(NamedTuple):
    """Whole-ring per-age planes, oldest age first: processing index i
    is age ``timeout - i``."""

    slots: torch.Tensor     # int64 [D] processing index -> ring slot
    consider: torch.Tensor  # bool [D, rows, k] delivering and responded
    present: torch.Tensor   # bool [D, rows, k] window-shifting this round
    ages: torch.Tensor      # int32 [D]
    lat: torch.Tensor       # int32 [D, rows, k] slot-gathered latencies
    deliver: torch.Tensor   # bool [D, rows, k]
    expire: torch.Tensor    # bool [D, rows, k]


def _ring_age_view(ring: InflightState, cfg: AvalancheConfig,
                   round_: torch.Tensor) -> _RingAgeView:
    """The deliverable and expiry masks of the whole ring at once, from
    its (no-T) latency planes."""
    timeout = cfg.timeout_rounds()
    depth = timeout + 1
    ages = torch.arange(timeout, -1, -1, dtype=torch.int32,
                        device=ring.lat.device)
    slots = torch.remainder(round_.to(torch.int64) - ages, depth)
    lat = ring.lat.index_select(0, slots)
    responded = ring.responded.index_select(0, slots)
    a3 = ages[:, None, None]
    deliver = (lat == a3) & (a3 != timeout)
    expire = (lat >= timeout) & (a3 == timeout)
    consider = responded & deliver
    present = deliver | expire
    if cfg.skip_absent_votes:
        present = present & consider
    return _RingAgeView(slots=slots, consider=consider, present=present,
                        ages=ages, lat=lat, deliver=deliver, expire=expire)


def _vote_transition(votes, consider, confidence, yes_cnt, cons_cnt,
                     in_yes_raw, in_cons, pres, cfg: AvalancheConfig):
    """One present-gated window shift and confidence transition with the
    incremental yes/consider counters (uint8, wrapping as the
    reference's do); `confidence` is the widened int32 word."""
    top_bit = cfg.window - 1
    threshold = cfg.quorum - 1
    iy_raw = in_yes_raw.to(torch.uint8)
    ic = in_cons.to(torch.uint8)
    in_yes = iy_raw & ic

    evict_yes = ((votes & consider) >> top_bit) & 1
    evict_cons = (consider >> top_bit) & 1
    ny = yes_cnt + in_yes - evict_yes
    nc = cons_cnt + ic - evict_cons

    nv = (votes << 1) | iy_raw
    ncs = (consider << 1) | ic
    if cfg.window != 8:                         # uint8 shifts self-truncate
        window_mask = (1 << cfg.window) - 1
        nv = nv & window_mask
        ncs = ncs & window_mask

    yes = ny > threshold
    no = (nc - ny) > threshold
    conclusive = yes | no
    agree = ((confidence & 1) == 1) == yes
    saturated = (confidence >> 1) >= 0x7FFF
    conf_bumped = torch.where(saturated, confidence, confidence + 2)
    conf_new = torch.where(conclusive,
                           torch.where(agree, conf_bumped,
                                       yes.to(torch.int32)),
                           confidence)
    finalized_now = ((conf_bumped >> 1) == cfg.finalization_score) & agree
    ch = conclusive & (~agree | finalized_now) & pres

    return (torch.where(pres, nv, votes), torch.where(pres, ncs, consider),
            torch.where(pres, conf_new, confidence),
            torch.where(pres, ny, yes_cnt), torch.where(pres, nc, cons_cnt),
            ch)


def _active_ages(view: _RingAgeView, cfg: AvalancheConfig) -> list:
    """Processing indices of the ages to drain: the static single age
    under fixed latency (no host read), else the ages with anything
    present, read back in one host read."""
    single = _static_single_age(cfg)
    if single is not None:
        return [cfg.timeout_rounds() - single]
    flags = sync.read_flags(view.present.flatten(1).any(dim=1))
    return [i for i, f in enumerate(flags) if f]


def deliver_multi_coalesced(ring: InflightState, records: vr.VoteRecordState,
                            cfg: AvalancheConfig, packed_prefs: torch.Tensor,
                            minority_t: torch.Tensor, key: torch.Tensor,
                            round_: torch.Tensor, t: int,
                            live_rows: Optional[torch.Tensor] = None,
                            ctx: Optional[adversary.PolicyCtx] = None
                            ) -> Tuple:
    """One ring drain for the multi-target models; `deliver_multi`'s
    contract and bits.  The masks come from the whole ring at once
    (`_ring_age_view`) and only the active ages pay their gather and
    ingest, oldest first; confidence is re-read at every age, where the
    walk's per-age update mask reads it.  The per-slot transition is the
    incremental-counter form (`_vote_transition`) and the poll mask is
    read bit-packed."""
    if ring.polled.dtype != torch.uint8:
        raise ValueError(
            "the coalesced engine reads a bit-packed poll-mask ring: build "
            "the state under the same inflight_engine (init_ring)")
    k = cfg.k
    timeout = cfg.timeout_rounds()
    view = _ring_age_view(ring, cfg, round_)
    changed = torch.zeros(records.votes.shape, dtype=torch.bool,
                          device=records.votes.device)
    votes_applied = torch.zeros((), dtype=torch.int64, device=changed.device)
    for ai in _active_ages(view, cfg):
        d = timeout - ai
        entry = _slot_entry(ring, view.slots[ai:ai + 1])
        consider_i, present_i = view.consider[ai], view.present[ai]
        upd = unpack_bool_plane(entry.polled, t) & ~vr.has_finalized(
            records.confidence, cfg)
        if live_rows is not None:
            upd = upd & live_rows[:, None]
        rows = entry.peers.shape[0]
        cube = packed_prefs[entry.peers.reshape(rows * k).long()].reshape(
            rows, k, packed_prefs.shape[-1])
        votes_adv = adversary.apply_draw_planes(
            _delivery_key(key, d), unpack_bool_plane(cube, t), entry.lie,
            cfg, minority_t, ctx)                         # [rows, k, T]
        votes_applied = votes_applied + torch.where(
            upd, popcount8(pack_draws(consider_i))[:, None].to(torch.int32),
            0).sum(dtype=torch.int64)
        votes_w, cons_w = records.votes, records.consider
        confidence = vr.widen_confidence(records.confidence)
        yes_cnt = popcount8(votes_w & cons_w)
        cons_cnt = popcount8(cons_w)
        for j in range(k):
            pres = present_i[:, j][:, None] & upd
            (votes_w, cons_w, confidence, yes_cnt, cons_cnt,
             ch) = _vote_transition(
                votes_w, cons_w, confidence, yes_cnt, cons_cnt,
                votes_adv[:, j, :], consider_i[:, j][:, None], pres, cfg)
            changed = changed | ch
        records = vr.VoteRecordState(votes_w, cons_w,
                                     vr.narrow_confidence(confidence))
    return records, changed, _wrap_i32(votes_applied)


def deliver_1d_coalesced(ring: InflightState, records: vr.VoteRecordState,
                         cfg: AvalancheConfig, prefs: torch.Tensor,
                         key: torch.Tensor, round_: torch.Tensor,
                         live_rows: Optional[torch.Tensor] = None,
                         ctx: Optional[adversary.PolicyCtx] = None) -> Tuple:
    """`deliver_multi_coalesced` for single-decree Snowball."""
    k = cfg.k
    timeout = cfg.timeout_rounds()
    view = _ring_age_view(ring, cfg, round_)
    changed = torch.zeros(records.votes.shape, dtype=torch.bool,
                          device=records.votes.device)
    for ai in _active_ages(view, cfg):
        d = timeout - ai
        entry = _slot_entry(ring, view.slots[ai:ai + 1])
        consider_i, present_i = view.consider[ai], view.present[ai]
        votes_w, cons_w = records.votes, records.consider
        confidence = vr.widen_confidence(records.confidence)
        upd = entry.polled & ~vr.has_finalized(records.confidence, cfg)
        if live_rows is not None:
            upd = upd & live_rows
        votes_adv = adversary.apply_1d(_delivery_key(key, d),
                                       prefs[entry.peers.long()], entry.lie,
                                       cfg, prefs, ctx)
        yes_cnt = popcount8(votes_w & cons_w)
        cons_cnt = popcount8(cons_w)
        for j in range(k):
            pres = present_i[:, j] & upd
            (votes_w, cons_w, confidence, yes_cnt, cons_cnt,
             ch) = _vote_transition(
                votes_w, cons_w, confidence, yes_cnt, cons_cnt,
                votes_adv[:, j], consider_i[:, j], pres, cfg)
            changed = changed | ch
        records = vr.VoteRecordState(votes_w, cons_w,
                                     vr.narrow_confidence(confidence))
    return records, changed


def deliver_multi_engine(ring: InflightState, records: vr.VoteRecordState,
                         cfg: AvalancheConfig, packed_prefs: torch.Tensor,
                         minority_t: torch.Tensor, key: torch.Tensor,
                         round_: torch.Tensor, t: int,
                         live_rows: Optional[torch.Tensor] = None,
                         ctx: Optional[adversary.PolicyCtx] = None) -> Tuple:
    """`cfg.inflight_engine` dispatch of the multi-target delivery pass;
    the same bits whichever engine runs."""
    engine = {"walk": deliver_multi,
              "walk_earlyout": deliver_multi_earlyout,
              "coalesced": deliver_multi_coalesced}[cfg.inflight_engine]
    return engine(ring, records, cfg, packed_prefs, minority_t, key, round_,
                  t, live_rows=live_rows, ctx=ctx)


def deliver_1d_engine(ring: InflightState, records: vr.VoteRecordState,
                      cfg: AvalancheConfig, prefs: torch.Tensor,
                      key: torch.Tensor, round_: torch.Tensor,
                      live_rows: Optional[torch.Tensor] = None,
                      ctx: Optional[adversary.PolicyCtx] = None) -> Tuple:
    """`cfg.inflight_engine` dispatch of the single-decree delivery
    pass (Snowball)."""
    engine = {"walk": deliver_1d,
              "walk_earlyout": deliver_1d_earlyout,
              "coalesced": deliver_1d_coalesced}[cfg.inflight_engine]
    return engine(ring, records, cfg, prefs, key, round_,
                  live_rows=live_rows, ctx=ctx)


class RingTelemetry(NamedTuple):
    """Per-round int32 ring counters at (querier, draw) entry
    granularity."""

    deliveries: torch.Tensor  # responses delivered (responded, on time)
    expiries: torch.Tensor    # entries expired unanswered at the timeout
    occupancy: torch.Tensor   # entries still in flight after this round


def ring_telemetry(ring: Optional[InflightState], cfg: AvalancheConfig,
                   round_: torch.Tensor) -> RingTelemetry:
    """Ring counters of the round that just drained, from the engines'
    own age view; ages the ring has not been through yet
    (``age > round_``) read as empty.  None ring: zeros."""
    if ring is None:
        zero = torch.zeros((), dtype=torch.int32, device=round_.device)
        return RingTelemetry(zero, zero, zero)
    v = _ring_age_view(ring, cfg, round_)
    timeout = cfg.timeout_rounds()
    a3 = v.ages[:, None, None]
    sent = (v.ages <= round_)[:, None, None]
    pending = (v.lat > a3) & (a3 != timeout) & sent
    return RingTelemetry(
        deliveries=(v.consider & sent).sum(dtype=torch.int32),
        expiries=(v.expire & sent).sum(dtype=torch.int32),
        occupancy=pending.sum(dtype=torch.int32))


def clear_columns(ring: Optional[InflightState],
                  cols: torch.Tensor) -> Optional[InflightState]:
    """Drop pending updates for window columns being retired or refilled
    (bool ``[W]``, True = column re-assigned), so a response still in
    flight for the old occupant never lands on its replacement; a packed
    plane clears the same columns as bits.  None passes."""
    if ring is None:
        return None
    if ring.polled.dtype == torch.uint8:
        keep = ~pack_bool_plane(cols[None, :])[0]
        return ring._replace(polled=ring.polled & keep[None, None, :])
    return ring._replace(polled=ring.polled & ~cols[None, None, :])


def clear_rows(ring: Optional[InflightState], rows: torch.Tensor,
               peer_rows: Optional[torch.Tensor] = None
               ) -> Optional[InflightState]:
    """Drop pending updates for window rows being rotated out: `rows`
    (bool, True = row re-assigned) drops the departed queriers' stored
    poll masks, and `peer_rows` (default `rows`) clears `responded` on
    in-flight entries whose stored peer departed, so the replacement's
    preference is never delivered in its name.  None passes."""
    if ring is None:
        return None
    keep = ~rows
    polled_keep = keep[None, :, None] if ring.polled.ndim == 3 else keep[None]
    if ring.polled.dtype == torch.uint8:
        polled = ring.polled * polled_keep.to(torch.uint8)
    else:
        polled = ring.polled & polled_keep
    peer_gone = (rows if peer_rows is None else peer_rows)[ring.peers.long()]
    return ring._replace(polled=polled,
                         responded=ring.responded & keep[None, :, None]
                         & ~peer_gone)
