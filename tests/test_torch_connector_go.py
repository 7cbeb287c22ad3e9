"""The port's Go-client fixtures (`connector/go_fixtures.py`) against the
JAX package's and against the vendored `go_avalanche_tpu/connector/go/
testdata/` files, which this test only reads: every frame byte-equal,
every file written by `write_fixtures` byte-equal, and the reply frames
decoding through the port's protocol to the values `client_test.go`
expects.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import pytest

from go_avalanche_tpu.connector import go_fixtures as jfix
from go_avalanche_tpu_torch.connector import go_fixtures
from go_avalanche_tpu_torch.connector import protocol as proto

REPO = Path(__file__).resolve().parents[1]


def test_frames_equal_the_reference_and_the_vendored_files():
    got = go_fixtures.build_fixtures()
    assert got == jfix.build_fixtures()
    on_disk = sorted(os.listdir(jfix.TESTDATA_DIR))
    assert on_disk == sorted(f"{name}.bin" for name in got)
    for name, frame in got.items():
        with open(os.path.join(jfix.TESTDATA_DIR, name + ".bin"), "rb") as fh:
            assert fh.read() == frame, name


def test_write_fixtures_needs_a_directory_and_writes_the_files(tmp_path):
    with pytest.raises(TypeError):
        go_fixtures.write_fixtures()
    go_fixtures.write_fixtures(str(tmp_path / "out"))
    for name, frame in go_fixtures.build_fixtures().items():
        assert (tmp_path / "out" / f"{name}.bin").read_bytes() == frame


def test_module_cli_writes_to_out(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "go_avalanche_tpu_torch.connector.go_fixtures",
         "--out", str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"wrote 21 fixtures to {tmp_path}" in proc.stdout
    assert len(list(tmp_path.glob("*.bin"))) == 21
    proc = subprocess.run(
        [sys.executable, "-m", "go_avalanche_tpu_torch.connector.go_fixtures"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "--out" in proc.stderr


def test_frames_are_wellformed_and_decode_to_the_go_test_values():
    f = go_fixtures.build_fixtures()
    for name, frame in f.items():
        (length,) = struct.unpack(">I", frame[:4])
        assert length == len(frame) - 4, name
        assert frame[4] in set(proto.MsgType), name

    def payload(name):
        return f[name][5:]

    assert proto.unpack_i64s(payload("rep_invs"))[0] == [66, 65]
    assert proto.unpack_votes(payload("rep_votes"))[0] == [
        (65, 0), (66, 1), (67, -1)]
    assert proto.unpack_updates(payload("rep_updates")) == (
        True, [(65, 3), (66, 0)])
    assert struct.unpack("<Id4q", payload("rep_sim_stats")) == (
        250, 0.875, 1000, 8000, 3, 42)
    assert proto.unpack_error(payload("rep_error")) == "boom"
