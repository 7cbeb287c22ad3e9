"""Golden byte frames of the Connector wire protocol for the vendored Go
client — the port's `go_avalanche_tpu/connector/go_fixtures.py`, built
from the port's `connector/protocol.py`.

The Go client (`go_avalanche_tpu/connector/go/client.go`) is held to the
protocol by golden frames: request fixtures are the exact frames it must
emit for a fixed argument set, reply fixtures are server frames it must
decode to fixed expected values (`client_test.go`).  The port speaks the
same protocol, so its frames equal the reference's byte for byte
(`tests/test_torch_connector_go.py` holds both, and the vendored
`testdata/`, to that).

    python -m go_avalanche_tpu_torch.connector.go_fixtures --out DIR

writes one ``<name>.bin`` per frame into DIR.
"""

from __future__ import annotations

import argparse
import os
import struct
from typing import Dict

from go_avalanche_tpu_torch.connector import protocol as proto


def build_fixtures() -> Dict[str, bytes]:
    """name -> full wire frame (length prefix included)."""
    f = {}
    # ---- requests (what the Go client must emit) ----
    f["req_ping"] = proto.pack_frame(proto.MsgType.PING)
    f["req_create_node"] = proto.pack_frame(
        proto.MsgType.CREATE_NODE, struct.pack("<q", 7))
    f["req_add_target"] = proto.pack_frame(
        proto.MsgType.ADD_TARGET, struct.pack("<qqBBq", 7, 65, 1, 1, 99))
    f["req_get_invs"] = proto.pack_frame(
        proto.MsgType.GET_INVS, struct.pack("<q", 7))
    f["req_query"] = proto.pack_frame(
        proto.MsgType.QUERY, struct.pack("<q", 3) + proto.pack_i64s([65, 66]))
    f["req_register_votes"] = proto.pack_frame(
        proto.MsgType.REGISTER_VOTES,
        struct.pack("<qqq", 1, 2, 3) + proto.pack_votes([(65, 0), (66, -1)]))
    f["req_is_accepted"] = proto.pack_frame(
        proto.MsgType.IS_ACCEPTED, struct.pack("<qq", 7, 65))
    f["req_get_confidence"] = proto.pack_frame(
        proto.MsgType.GET_CONFIDENCE, struct.pack("<qq", 7, 66))
    f["req_get_round"] = proto.pack_frame(
        proto.MsgType.GET_ROUND, struct.pack("<q", 7))
    f["req_sim_init_v2"] = proto.pack_frame(
        proto.MsgType.SIM_INIT,
        struct.pack("<IIIIIBdd", 100, 50, 1, 8, 128, 1, 0.2, 0.05)
        + struct.pack("<Bdd", 1, 0.35, 0.01))
    f["req_sim_init_v3"] = proto.pack_frame(
        proto.MsgType.SIM_INIT,
        struct.pack("<IIIIIBdd", 100, 50, 1, 8, 128, 1, 0.2, 0.05)
        + struct.pack("<Bdd", 1, 0.35, 0.01)
        + struct.pack("<BII", 2, 2, 16))
    f["req_sim_run"] = proto.pack_frame(
        proto.MsgType.SIM_RUN, struct.pack("<I", 250))
    f["req_shutdown"] = proto.pack_frame(proto.MsgType.SHUTDOWN)
    # ---- replies (what the Go client must decode) ----
    f["rep_pong"] = proto.pack_frame(proto.MsgType.PONG)
    f["rep_ok_true"] = proto.pack_frame(proto.MsgType.OK,
                                        struct.pack("<B", 1))
    f["rep_invs"] = proto.pack_frame(proto.MsgType.INVS,
                                     proto.pack_i64s([66, 65]))
    f["rep_votes"] = proto.pack_frame(
        proto.MsgType.VOTES, proto.pack_votes([(65, 0), (66, 1), (67, -1)]))
    f["rep_updates"] = proto.pack_frame(
        proto.MsgType.UPDATES, proto.pack_updates(True, [(65, 3), (66, 0)]))
    f["rep_i64_minus1"] = proto.pack_frame(proto.MsgType.I64,
                                           struct.pack("<q", -1))
    f["rep_sim_stats"] = proto.pack_frame(
        proto.MsgType.SIM_STATS,
        struct.pack("<Id4q", 250, 0.875, 1000, 8000, 3, 42))
    f["rep_error"] = proto.pack_frame(proto.MsgType.ERROR,
                                      proto.pack_error("boom"))
    return f


def write_fixtures(directory: str) -> None:
    """Write every fixture as ``<directory>/<name>.bin``."""
    os.makedirs(directory, exist_ok=True)
    for name, frame in build_fixtures().items():
        with open(os.path.join(directory, name + ".bin"), "wb") as fh:
            fh.write(frame)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True,
                        help="directory to write the .bin fixtures into")
    args = parser.parse_args(argv)
    write_fixtures(args.out)
    print(f"wrote {len(build_fixtures())} fixtures to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
