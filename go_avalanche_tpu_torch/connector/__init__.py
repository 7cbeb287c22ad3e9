"""Host Connector boundary — the external-harness plugin seam; the port's
copy of `go_avalanche_tpu/connector/`, its simulator on torch.

SURVEY.md §2.4 item 6 / §7 phase 7: the reference's `Connman`/`Target` seam
kept as a host-side *service*, so harnesses in any language can drive the
framework the way `examples/basic-preconcensus/main.go` drives the Go
library: create nodes, `AddTargetToReconcile`, fetch polls, `query` peers
(gossip-on-poll included), `RegisterVotes`, observe `StatusUpdate`s — plus
remote control of the batched simulator (init / run / stats).

Wire format: a small length-prefixed binary protocol over TCP
(`protocol.py`), chosen over gRPC so that native clients need nothing but
sockets (`native/connector/` is a complete C++ client).
"""

from go_avalanche_tpu_torch.connector.client import ConnectorClient
from go_avalanche_tpu_torch.connector.server import ConnectorServer

__all__ = ["ConnectorClient", "ConnectorServer"]
