"""The mesh-sharded node-axis stream — `go_avalanche_tpu/parallel/sharded_node_stream.py`.

`models/node_stream` on this rank's block: the dense ``[W, T]`` window is
cut like the plain round's state (the inner round is
`parallel/sharded._local_round`), while the registry planes (``[R]``
stake and residency, the ``[W]`` slot-node map) stay replicated: 1M
nodes of registry metadata is MBs, little beside the window.

The churn pass runs on those replicated planes from the replicated
churn key with no shard folds, so every shard draws the same swaps:
it calls the dense scheduler's own draw, `models/node_stream.churn_swaps`
(a copy would break the contract).  Only the record rotation is
row-local: each node shard refreshes the rows of its block.  So the
dense and sharded schedulers agree leaf for leaf on the working set —
`slot_node`, `resident`, the stake plane, the churn counters and the
row-propensity plane — for one key, while the inner round keeps the
sharded drivers' per-shard streams.  Every rank repeats the draw's
Gumbel top-k over the registry.
"""

from __future__ import annotations

from typing import Tuple

import torch

from go_avalanche_tpu_torch.config import (AvalancheConfig, DEFAULT_CONFIG,
                                           inner_round_config)
from go_avalanche_tpu_torch.models import node_stream as ns_model
from go_avalanche_tpu_torch.models.backlog import stack_tree
from go_avalanche_tpu_torch.models.node_stream import (NodeStreamState,
                                                       NodeStreamTelemetry)
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.ops import inflight
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel import sharded
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.parallel.sharded import REPLICATED


def node_stream_state_specs(track_finality: bool = True,
                            with_inflight: bool = False,
                            with_fault_params: bool = False,
                            traced: bool = False) -> NodeStreamState:
    """The spec of every leaf of `NodeStreamState`: the window's
    `sharded.state_specs`, the registry planes replicated (every shard
    needs the whole hosting map and residency for the churn draw), the
    prior cut along txs."""
    return NodeStreamState(
        sim=sharded.state_specs(track_finality, with_inflight,
                                with_fault_params, traced),
        slot_node=REPLICATED,
        resident=REPLICATED,
        stake=REPLICATED,
        init_pref=(TXS_AXIS,),
        churn_key=REPLICATED,
        churned_in=REPLICATED,
        churned_out=REPLICATED,
    )


def specs_of(state: NodeStreamState) -> NodeStreamState:
    return node_stream_state_specs(*(
        x is not None for x in (state.sim.finalized_at, state.sim.inflight,
                                state.sim.fault_params, state.sim.trace)))


def shard_node_stream_state(state: NodeStreamState,
                            mesh) -> NodeStreamState:
    """This rank's block of the global node-stream `state`, on its
    device."""
    state = state._replace(sim=state.sim._replace(
        inflight=inflight.repack_polled_for_shards(
            state.sim.inflight, state.sim.records.votes.shape[1],
            mesh.shape[TXS_AXIS])))
    return sharded.map_specs(lambda x, s: sharded.block_of(x, s, mesh),
                             state, specs_of(state))


def gather_node_stream_state(state: NodeStreamState,
                             mesh) -> NodeStreamState:
    """The global node-stream state assembled from every rank's block,
    on every rank."""
    with C.bind(mesh):
        return sharded.map_specs(sharded.assemble, state, specs_of(state))


def _local_churn(state: NodeStreamState, cfg: AvalancheConfig
                 ) -> Tuple[NodeStreamState, torch.Tensor]:
    """The churn pass on this rank's block: the replicated draw, the
    row-local rotation (`models/node_stream.churn`)."""
    sim = state.sim
    if cfg.node_churn_rate <= 0.0:
        return state, torch.zeros((), dtype=torch.int32,
                                  device=state.slot_node.device)
    r = state.resident.shape[0]
    w_local = sim.records.votes.shape[0]
    offset = C.axis_index(NODES_AXIS) * w_local
    # The shared draw on the replicated planes, the same on every shard.
    swap, new_slot, resident, n_swapped, k_next = ns_model.churn_swaps(
        state, cfg)
    rows = swap[offset:offset + w_local, None]
    fresh = vr.init_state(state.init_pref[None, :])
    records = vr.VoteRecordState(*(torch.where(rows, f, p) for p, f in
                                   zip(sim.records, fresh)))
    new_sim = sim._replace(
        records=records,
        added=rows | sim.added,
        finalized_at=(None if sim.finalized_at is None
                      else torch.where(rows, -1, sim.finalized_at)),
        latency_weight=state.stake[new_slot.long()],          # [W]
        byzantine=ns_model._registry_byzantine(
            cfg, r, swap.device)[new_slot.long()],              # [W]
        alive=swap | sim.alive,                                 # [W]
        # The querier side takes this shard's rows; the polled-peer side
        # the whole swap mask (the ring's peers are global ids).
        inflight=inflight.clear_rows(sim.inflight, rows[:, 0],
                                     peer_rows=swap))
    return state._replace(
        sim=new_sim, slot_node=new_slot, resident=resident,
        churn_key=k_next, churned_in=state.churned_in + n_swapped,
        churned_out=state.churned_out + n_swapped), n_swapped


def _local_step(state: NodeStreamState, cfg: AvalancheConfig,
                n_global: int, n_tx_shards: int
                ) -> Tuple[NodeStreamState, NodeStreamTelemetry]:
    """Churn, then one sharded round (inside ``collectives.bind``)."""
    round_val = state.sim.round
    state, swapped = _local_churn(state, cfg)
    # The scheduler owns the trace plane: the inner round's taps are
    # silenced and the record (psum'd counters, replicated registry
    # stats) is written below.
    new_sim, round_tel = sharded._local_round(
        state.sim, inner_round_config(cfg), n_global, n_tx_shards)
    tel = NodeStreamTelemetry(
        round=round_tel, departed=swapped,
        resident_stake=ns_model._stake_share(state.resident, state.stake))
    new_sim = new_sim._replace(
        trace=obs_trace.write_round(new_sim.trace, cfg, round_val, tel))
    return state._replace(sim=new_sim), tel


# The reference's manifest (the churn is replicated work, so the surface
# is the inner round's), plus the inner round's psum over txs of the
# poll cap's search and the withhold gate, which it omits as
# `sharded.DECLARED_COLLECTIVES` says.
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", (NODES_AXIS,)),
    ("all_to_all", (NODES_AXIS,)),
    ("all_reduce", (NODES_AXIS,)),
    ("all_reduce", (TXS_AXIS,)),      # poll-cap counts, withhold gate
    ("all_reduce", (NODES_AXIS, TXS_AXIS)),
})


def make_sharded_node_stream_step(mesh,
                                  cfg: AvalancheConfig = DEFAULT_CONFIG,
                                  donate: bool = False):
    """A one-step churn and round over the mesh: ``step(block) ->
    (block, telemetry)`` on this rank's block
    (`shard_node_stream_state`); `donate` as in
    `sharded.make_sharded_round_step`.  The local round is phased
    whatever `cfg.round_engine` says, as the reference's."""
    n_tx = mesh.shape[TXS_AXIS]

    def step(state: NodeStreamState):
        with C.bind(mesh):
            return _local_step(state, cfg, state.slot_node.shape[0], n_tx)

    return step


def run_scan_sharded_node_stream(mesh, state: NodeStreamState,
                                 cfg: AvalancheConfig = DEFAULT_CONFIG,
                                 n_rounds: int = 100, donate: bool = False
                                 ) -> Tuple[NodeStreamState,
                                            NodeStreamTelemetry]:
    """`n_rounds` steps on this rank's block with the stacked telemetry
    (the registry never drains, so there is no run to settlement)."""
    step = make_sharded_node_stream_step(mesh, cfg, donate)
    rows = []
    for _ in range(n_rounds):
        state, tel = step(state)
        rows.append(tel)
    return state, stack_tree(rows)
