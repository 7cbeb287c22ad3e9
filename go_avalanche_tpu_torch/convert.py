"""Carry a simulator state between the JAX reference and the port.

`state_from_numpy` takes the reference state's leaves read as numpy
arrays — an `AvalancheSimState`-shaped NamedTuple or a mapping with the
same field names, records nested the same way, and the key as its two
uint32 words (`jax.random.key_data`) — and builds the port's state on a
device.  `state_to_numpy` goes back to the reference dtypes: uint8 vote
planes, uint16 confidence, bool masks, int32 ranks and stamps, float32
weights, and the key as two uint32 words.  `dag_state_from_numpy` and
`dag_state_to_numpy` do the same for the conflict-DAG state: its base
state, the int32 `conflict_set` and the `n_sets` / `set_size` statics.
`family_state_from_numpy` and `family_state_to_numpy` carry the
single-decree states (`SnowballState`, `SlushState`, `SnowflakeState`).
The async ring (`inflight`: int32 peers and latencies, bool responded
and lie masks, and the poll-mask plane, bool or bit-packed uint8) and
the realized stochastic fault parameters (`fault_params`, int32
vectors) travel with the avalanche, DAG and Snowball states, and so
with every scheduler state that wraps one; None stays None.  So does the
trace plane (`trace`, on the avalanche, DAG and Snowball states and so on
every scheduler's): its data and cursor travel as int32, its columns and
stride are copied.  `backlog_state_*`,
`streaming_dag_state_*` and `node_stream_state_*` carry the streaming
schedulers' states: the window state, the slot maps, the backlog and
outputs planes, the traffic plane (or None) and the registry planes.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from go_avalanche_tpu_torch import traffic as tf
from go_avalanche_tpu_torch.models import (backlog, dag, family, node_stream,
                                           snowball, streaming_dag)
from go_avalanche_tpu_torch.models.avalanche import (AvalancheSimState,
                                                     _device, move_leaves,
                                                     to_device)
from go_avalanche_tpu_torch.obs.trace import TraceBuffer
from go_avalanche_tpu_torch.ops.inflight import FaultParams, InflightState
from go_avalanche_tpu_torch.ops.voterecord import VoteRecordState

_DTYPES = {
    "added": torch.bool, "valid": torch.bool, "score_rank": torch.int32,
    "poll_order": torch.int32, "poll_order_inv": torch.int32,
    "byzantine": torch.bool, "alive": torch.bool,
    "latency_weight": torch.float32, "finalized_at": torch.int32,
    "round": torch.int32,
}


def _field(tree: Any, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dtype)


def _records_from_numpy(rec) -> VoteRecordState:
    confidence = np.asarray(_field(rec, "confidence"), np.uint16)
    return VoteRecordState(
        votes=_tensor(_field(rec, "votes"), torch.uint8),
        consider=_tensor(_field(rec, "consider"), torch.uint8),
        confidence=torch.from_numpy(confidence.view(np.int16).copy()))


def _key_from_numpy(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64))


def _optional(tree: Any, name: str):
    """Leaf `name`, or None where the tree has no such field."""
    if isinstance(tree, Mapping):
        return tree.get(name)
    return getattr(tree, name, None)


_RING_DTYPES = {"peers": torch.int32, "lat": torch.int32,
                "responded": torch.bool, "lie": torch.bool}


def _ring_from_numpy(tree):
    """The async ring from numpy leaves; the poll-mask plane keeps its
    layout (bool, or uint8 bit-packed for the coalesced engine)."""
    if tree is None:
        return None
    polled = np.array(_field(tree, "polled"))
    return InflightState(
        **{name: _tensor(_field(tree, name), dtype)
           for name, dtype in _RING_DTYPES.items()},
        polled=torch.from_numpy(polled))


def _fault_params_from_numpy(tree):
    if tree is None:
        return None
    return FaultParams(**{name: _tensor(_field(tree, name), torch.int32)
                          for name in FaultParams._fields})


def _trace_from_numpy(tree):
    """The trace plane from a reference buffer (or a mapping with its
    field names) with numpy data and cursor; None passes."""
    if tree is None:
        return None
    return TraceBuffer(
        data=_tensor(_field(tree, "data"), torch.int32),
        cursor=_tensor(_field(tree, "cursor"), torch.int32),
        columns=tuple((str(n), str(k)) for n, k in _field(tree, "columns")),
        stride=int(_field(tree, "stride")))


def _async_from_numpy(tree) -> dict:
    """The `inflight`, `fault_params` and `trace` leaves of a reference
    state."""
    return dict(
        inflight=_ring_from_numpy(_optional(tree, "inflight")),
        fault_params=_fault_params_from_numpy(
            _optional(tree, "fault_params")),
        trace=_trace_from_numpy(_optional(tree, "trace")))


def state_from_numpy(tree: Any, device="cuda") -> AvalancheSimState:
    """The port's state on `device` from the reference state's numpy
    leaves."""
    leaves = {name: (None if _field(tree, name) is None
                     else _tensor(_field(tree, name), dtype))
              for name, dtype in _DTYPES.items()}
    return to_device(AvalancheSimState(
        records=_records_from_numpy(_field(tree, "records")),
        key=_key_from_numpy(_field(tree, "key")), **leaves,
        **_async_from_numpy(tree)), device)


def state_to_numpy(state: AvalancheSimState) -> AvalancheSimState:
    """The state's leaves as numpy arrays in the reference dtypes (the
    same NamedTuple structure, so leaves compare field by field)."""
    def np_(x):
        return None if x is None else x.detach().cpu().numpy()

    rec = state.records
    return AvalancheSimState(
        records=VoteRecordState(np_(rec.votes), np_(rec.consider),
                                np_(rec.confidence).view(np.uint16)),
        **{name: np_(getattr(state, name)) for name in _DTYPES},
        key=np_(state.key).astype(np.uint32),
        inflight=_np_tree(state.inflight),
        fault_params=_np_tree(state.fault_params),
        trace=_np_tree(state.trace),
    )


def dag_state_from_numpy(tree: Any, device="cuda") -> dag.DagSimState:
    """The port's DAG state on `device` from the reference DAG state's
    numpy leaves (`base`, `conflict_set`) and statics."""
    state = dag.DagSimState(
        base=state_from_numpy(_field(tree, "base"), device="cpu"),
        conflict_set=_tensor(_field(tree, "conflict_set"), torch.int32),
        n_sets=int(_field(tree, "n_sets")),
        set_size=(None if _field(tree, "set_size") is None
                  else int(_field(tree, "set_size"))))
    return dag.to_device(state, device)


def dag_state_to_numpy(state: dag.DagSimState) -> dag.DagSimState:
    """The DAG state's leaves as numpy arrays in the reference dtypes."""
    return state._replace(base=state_to_numpy(state.base),
                          conflict_set=state.conflict_set.cpu().numpy())


_FAMILY_DTYPES = {
    "byzantine": torch.bool, "alive": torch.bool, "color": torch.bool,
    "finalized_at": torch.int32, "count": torch.int32,
    "accepted_at": torch.int32, "round": torch.int32,
}
FAMILY_STATES = {"snowball": snowball.SnowballState,
                 "slush": family.SlushState,
                 "snowflake": family.SnowflakeState}


def family_state_from_numpy(model: str, tree: Any, device="cuda"):
    """The port's single-decree state of `model` ("snowball", "slush"
    or "snowflake") on `device`, from the reference state's numpy
    leaves."""
    cls = FAMILY_STATES[model]
    leaves = {}
    for name in cls._fields:
        if name == "records":
            leaves[name] = _records_from_numpy(_field(tree, name))
        elif name == "key":
            leaves[name] = _key_from_numpy(_field(tree, name))
        elif name in ("inflight", "fault_params", "trace"):
            leaves[name] = _async_from_numpy(tree)[name]
        else:
            leaves[name] = _tensor(_field(tree, name), _FAMILY_DTYPES[name])
    state = cls(**leaves)
    if model == "snowball":
        return snowball.to_device(state, device)
    return family.to_device(state, device)


def family_state_to_numpy(state):
    """A single-decree state's leaves as numpy arrays in the reference
    dtypes (the same NamedTuple structure)."""
    def np_(x):
        return x.detach().cpu().numpy()

    leaves = {}
    for name in state._fields:
        x = getattr(state, name)
        if name == "records":
            leaves[name] = VoteRecordState(
                np_(x.votes), np_(x.consider),
                np_(x.confidence).view(np.uint16))
        elif name == "key":
            leaves[name] = np_(x).astype(np.uint32)
        else:
            leaves[name] = _np_tree(x)
    return type(state)(**leaves)


def _planes(cls, tree, dtypes: dict):
    """A NamedTuple `cls` of CPU tensors from numpy leaves, by field."""
    return cls(**{name: _tensor(_field(tree, name), dtypes[name])
                  for name in cls._fields})


def _np_tree(tree):
    """Every tensor leaf of a (nested) NamedTuple, or of a trace buffer,
    as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, TraceBuffer):
        return TraceBuffer(_np_tree(tree.data), _np_tree(tree.cursor),
                           tree.columns, tree.stride)
    if isinstance(tree, tuple):
        return type(tree)(*(_np_tree(x) for x in tree))
    return tree


_OUTPUT_DTYPES = {"settled": torch.bool, "accepted": torch.bool,
                  "accept_votes": torch.int32, "settle_round": torch.int32,
                  "admit_round": torch.int32}
_BACKLOG_DTYPES = {"score": torch.int32, "init_pref": torch.bool,
                   "valid": torch.bool}


def _traffic_from_numpy(tree):
    if tree is None:
        return None
    return tf.TrafficState(
        key=_key_from_numpy(_field(tree, "key")),
        arrived_idx=_tensor(_field(tree, "arrived_idx"), torch.int32),
        arrival_round=_tensor(_field(tree, "arrival_round"), torch.int32),
        lat_hist=_tensor(_field(tree, "lat_hist"), torch.int32))


def _traffic_to_numpy(traffic):
    if traffic is None:
        return None
    out = _np_tree(traffic)
    return out._replace(key=out.key.astype(np.uint32))


def _scheduler_leaves(tree) -> dict:
    return {name: _tensor(_field(tree, name), torch.int32)
            for name in ("slot_admit_round", "next_idx")}


def backlog_state_from_numpy(tree: Any,
                             device="cuda") -> backlog.BacklogSimState:
    """The port's backlog-scheduler state on `device` from the reference
    state's numpy leaves."""
    state = backlog.BacklogSimState(
        sim=state_from_numpy(_field(tree, "sim"), device="cpu"),
        slot_tx=_tensor(_field(tree, "slot_tx"), torch.int32),
        backlog=_planes(backlog.Backlog, _field(tree, "backlog"),
                        _BACKLOG_DTYPES),
        outputs=_planes(backlog.BacklogOutputs, _field(tree, "outputs"),
                        _OUTPUT_DTYPES),
        traffic=_traffic_from_numpy(_field(tree, "traffic")),
        **_scheduler_leaves(tree))
    return move_leaves(state, _device(device))


def backlog_state_to_numpy(state: backlog.BacklogSimState
                           ) -> backlog.BacklogSimState:
    """The backlog-scheduler state's leaves as numpy arrays in the
    reference dtypes."""
    return _np_tree(state)._replace(sim=state_to_numpy(state.sim),
                                    traffic=_traffic_to_numpy(state.traffic))


def streaming_dag_state_from_numpy(tree: Any, device="cuda"
                                   ) -> streaming_dag.StreamingDagState:
    """The port's streaming conflict-DAG state on `device` from the
    reference state's numpy leaves."""
    state = streaming_dag.StreamingDagState(
        dag=dag_state_from_numpy(_field(tree, "dag"), device="cpu"),
        slot_set=_tensor(_field(tree, "slot_set"), torch.int32),
        backlog=_planes(streaming_dag.SetBacklog, _field(tree, "backlog"),
                        _BACKLOG_DTYPES),
        outputs=_planes(streaming_dag.SetOutputs, _field(tree, "outputs"),
                        _OUTPUT_DTYPES),
        traffic=_traffic_from_numpy(_field(tree, "traffic")),
        **_scheduler_leaves(tree))
    return move_leaves(state, _device(device))


def streaming_dag_state_to_numpy(state: streaming_dag.StreamingDagState
                                 ) -> streaming_dag.StreamingDagState:
    """The streaming conflict-DAG state's leaves as numpy arrays in the
    reference dtypes."""
    return _np_tree(state)._replace(dag=dag_state_to_numpy(state.dag),
                                    traffic=_traffic_to_numpy(state.traffic))


def node_stream_state_from_numpy(tree: Any, device="cuda"
                                 ) -> node_stream.NodeStreamState:
    """The port's node-stream state on `device` from the reference
    state's numpy leaves."""
    state = node_stream.NodeStreamState(
        sim=state_from_numpy(_field(tree, "sim"), device="cpu"),
        slot_node=_tensor(_field(tree, "slot_node"), torch.int32),
        resident=_tensor(_field(tree, "resident"), torch.bool),
        stake=_tensor(_field(tree, "stake"), torch.float32),
        init_pref=_tensor(_field(tree, "init_pref"), torch.bool),
        churn_key=_key_from_numpy(_field(tree, "churn_key")),
        churned_in=_tensor(_field(tree, "churned_in"), torch.int32),
        churned_out=_tensor(_field(tree, "churned_out"), torch.int32))
    return move_leaves(state, _device(device))


def node_stream_state_to_numpy(state: node_stream.NodeStreamState
                               ) -> node_stream.NodeStreamState:
    """The node-stream state's leaves as numpy arrays in the reference
    dtypes."""
    out = _np_tree(state)
    return out._replace(sim=state_to_numpy(state.sim),
                        churn_key=out.churn_key.astype(np.uint32))
