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
single-decree states (`SnowballState`, `SlushState`, `SnowflakeState`);
the reference's async ring, fault parameters and trace plane, None in
the synchronous round, have no counterpart.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from go_avalanche_tpu_torch.models import dag, family, snowball
from go_avalanche_tpu_torch.models.avalanche import (AvalancheSimState,
                                                     to_device)
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


def state_from_numpy(tree: Any, device="cuda") -> AvalancheSimState:
    """The port's state on `device` from the reference state's numpy
    leaves."""
    leaves = {name: (None if _field(tree, name) is None
                     else _tensor(_field(tree, name), dtype))
              for name, dtype in _DTYPES.items()}
    return to_device(AvalancheSimState(
        records=_records_from_numpy(_field(tree, "records")),
        key=_key_from_numpy(_field(tree, "key")), **leaves), device)


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
            leaves[name] = np_(x)
    return type(state)(**leaves)
