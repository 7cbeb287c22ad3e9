"""Peer registry — layer L3 (`net.go:3-31`); the port's copy of
`go_avalanche_tpu/net.py`.

The reference's `Connman` is a pure membership map (no sockets, no transport);
ours is the same seam, kept as the host-side plugin boundary (SURVEY.md
section 2.4 item 6), with two additions the simulator needs: removal (churn)
and deterministic ordering (the reference's `NodesIDs` inherits Go map
iteration randomness; we return sorted IDs so runs are reproducible).
"""

from __future__ import annotations

from typing import Dict, List

from go_avalanche_tpu_torch.types import NodeID


class _Node:
    """Per-peer record (`net.go:3-9`); a latency weight for weighted sampling."""

    __slots__ = ("id", "latency_weight")

    def __init__(self, node_id: NodeID, latency_weight: float = 1.0) -> None:
        self.id = node_id
        self.latency_weight = latency_weight


class Connman:
    """Node membership registry (`net.go:11-31`)."""

    def __init__(self) -> None:
        self._nodes: Dict[NodeID, _Node] = {}

    def add_node(self, node_id: NodeID,
                 latency_weight: float = 1.0) -> None:
        """Register a peer (`net.go:21-23`)."""
        self._nodes[node_id] = _Node(node_id, latency_weight)

    def remove_node(self, node_id: NodeID) -> bool:
        """Deregister a peer (churn support; absent in the reference)."""
        return self._nodes.pop(node_id, None) is not None

    def nodes_ids(self) -> List[NodeID]:
        """All registered peer IDs, ascending (`net.go:25-31`, made
        deterministic)."""
        return sorted(self._nodes)

    def latency_weight(self, node_id: NodeID) -> float:
        return self._nodes[node_id].latency_weight

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node_id: NodeID) -> bool:
        return node_id in self._nodes

    # Reference-spelling aliases for drop-in familiarity.
    AddNode = add_node
    NodesIDs = nodes_ids
