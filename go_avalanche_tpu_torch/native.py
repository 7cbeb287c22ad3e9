"""ctypes bindings to the native C++ host runtime (`native/avalanche_host`) —
the port's copy of `go_avalanche_tpu/native.py`, bound onto the port's own
`config.py` and `types.py`.  The C++ library is framework-free and shared
unchanged by both packages, so no device is involved here.

The control plane of the framework is available in two interchangeable
implementations: the pure-Python `Processor` (`processor.py`) and this native
`libavalanche_host.so` (C++17, std::thread ticker), both with full reference
parity (`processor.go:11-248`, SURVEY.md §2.3) and both tested against the
same golden vectors.  The native runtime is for host-side deployments where
the per-query Python overhead matters (e.g. the Connector service fanning out
to thousands of external harness connections); the torch simulators remain
the device compute path either way.

The library is built by `make -C native` into `native/build/` (g++ only, no
deps); `ensure_built` does this on demand.  The binding is ctypes over the C
ABI in `native/avalanche_host/capi.cc`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

from go_avalanche_tpu_torch.config import AvalancheConfig, DEFAULT_CONFIG
from go_avalanche_tpu_torch.types import (
    Response,
    Status,
    StatusUpdate,
    Vote,
    normalize_err,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libavalanche_host.so")

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native library could not be built/loaded."""


@contextlib.contextmanager
def _build_lock():
    """Serialize builds between processes (parallel test workers): two
    makes writing one `.so` at once could leave a torn library."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with open(os.path.join(os.path.dirname(_LIB_PATH), ".build.lock"),
              "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def ensure_built(force: bool = False) -> str:
    """Build `libavalanche_host.so`; returns its path.

    Always invokes make — its dependency tracking makes this a no-op when
    the library is newer than the sources, and it means edited C++ sources
    are never silently served stale to a fresh process.  `force` does a
    clean rebuild.
    """
    try:
        with _build_lock():
            if force:
                subprocess.run(["make", "-C", _NATIVE_DIR, "clean"],
                               check=True, capture_output=True, text=True)
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "all"],
                check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        # No make on this machine: a prebuilt library is the only candidate
        # (and with no toolchain there can be no freshly-edited sources to
        # go stale against it).  Other OSErrors (EACCES, ENOMEM) propagate:
        # a toolchain exists there, so serving a stale .so is the hazard.
        if os.path.exists(_LIB_PATH):
            return _LIB_PATH
        raise NativeBuildError(
            f"no native toolchain and no prebuilt library: {e}") from e
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        # Raise even when a stale .so exists; silently serving it would run
        # pre-edit code after a broken edit.
        raise NativeBuildError(
            f"building native runtime failed: {detail}") from e
    return _LIB_PATH


def load_library() -> ctypes.CDLL:
    """Load (building on demand) the native runtime; cached.

    There is deliberately no force-reload flag: dlopen caches by path, so a
    rebuilt .so cannot be re-loaded into a process that already mapped it —
    use `ensure_built(force=True)` and a fresh process to pick up changes.
    """
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())

    u32, i32, i64, i8 = (ctypes.c_uint32, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_int8)
    p_i32, p_i64, p_u32, p_i8 = (ctypes.POINTER(i32), ctypes.POINTER(i64),
                                 ctypes.POINTER(u32), ctypes.POINTER(i8))

    lib.avh_vote_record_new.restype = u32
    lib.avh_vote_record_new.argtypes = [ctypes.c_int]
    lib.avh_vote_record_step.restype = u32
    lib.avh_vote_record_step.argtypes = [
        u32, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int, p_i32]
    lib.avh_vote_record_replay.restype = u32
    lib.avh_vote_record_replay.argtypes = [
        ctypes.c_int, p_i32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, p_u32, p_i32]

    lib.avh_processor_new.restype = ctypes.c_void_p
    lib.avh_processor_new.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64]
    lib.avh_processor_free.argtypes = [ctypes.c_void_p]
    lib.avh_set_stub_time.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.avh_use_real_clock.argtypes = [ctypes.c_void_p]
    lib.avh_add_node.argtypes = [ctypes.c_void_p, i64]
    lib.avh_node_ids.restype = ctypes.c_int
    lib.avh_node_ids.argtypes = [ctypes.c_void_p, p_i64, ctypes.c_int]
    lib.avh_add_target.restype = ctypes.c_int
    lib.avh_add_target.argtypes = [ctypes.c_void_p, i64, ctypes.c_int,
                                   ctypes.c_int, i64]
    lib.avh_set_target_valid.restype = ctypes.c_int
    lib.avh_set_target_valid.argtypes = [ctypes.c_void_p, i64, ctypes.c_int]
    lib.avh_get_round.restype = i64
    lib.avh_get_round.argtypes = [ctypes.c_void_p]
    lib.avh_is_accepted.restype = ctypes.c_int
    lib.avh_is_accepted.argtypes = [ctypes.c_void_p, i64]
    lib.avh_get_confidence.restype = ctypes.c_int
    lib.avh_get_confidence.argtypes = [ctypes.c_void_p, i64]
    lib.avh_outstanding_requests.restype = ctypes.c_int
    lib.avh_outstanding_requests.argtypes = [ctypes.c_void_p]
    lib.avh_get_invs.restype = ctypes.c_int
    lib.avh_get_invs.argtypes = [ctypes.c_void_p, p_i64, ctypes.c_int]
    lib.avh_suitable_node.restype = i64
    lib.avh_suitable_node.argtypes = [ctypes.c_void_p]
    lib.avh_register_votes.restype = ctypes.c_int
    lib.avh_register_votes.argtypes = [
        ctypes.c_void_p, i64, i64, p_i64, p_i32, ctypes.c_int,
        p_i64, p_i8, ctypes.c_int, p_i32]
    lib.avh_event_loop_tick.restype = ctypes.c_int
    lib.avh_event_loop_tick.argtypes = [ctypes.c_void_p]
    lib.avh_start.restype = ctypes.c_int
    lib.avh_start.argtypes = [ctypes.c_void_p]
    lib.avh_stop.restype = ctypes.c_int
    lib.avh_stop.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


class NativeVoteRecord:
    """Scalar vote record backed by the native kernel; oracle-compatible API
    (mirrors `utils.golden.ScalarVoteRecord`)."""

    def __init__(self, accepted: bool,
                 cfg: AvalancheConfig = DEFAULT_CONFIG) -> None:
        self._lib = load_library()
        self._cfg = cfg
        self._state = self._lib.avh_vote_record_new(1 if accepted else 0)

    @property
    def votes(self) -> int:
        return self._state & 0xFF

    @property
    def consider(self) -> int:
        return (self._state >> 8) & 0xFF

    @property
    def confidence(self) -> int:
        return (self._state >> 16) & 0xFFFF

    def is_accepted(self) -> bool:
        return (self.confidence & 1) == 1

    def get_confidence(self) -> int:
        return self.confidence >> 1

    def has_finalized(self) -> bool:
        return self.get_confidence() >= self._cfg.finalization_score

    def register_vote(self, err: int) -> bool:
        changed = ctypes.c_int32(0)
        self._state = self._lib.avh_vote_record_step(
            self._state, normalize_err(err), self._cfg.window,
            self._cfg.quorum, self._cfg.finalization_score,
            ctypes.byref(changed))
        return bool(changed.value)

    def status(self) -> Status:
        fin, acc = self.has_finalized(), self.is_accepted()
        if fin:
            return Status.FINALIZED if acc else Status.INVALID
        return Status.ACCEPTED if acc else Status.REJECTED


def native_replay(accepted: bool, errs: Sequence[int],
                  cfg: AvalancheConfig = DEFAULT_CONFIG,
                  ) -> List[Tuple[int, int, int, bool]]:
    """Replay a vote stream through the native kernel in one C call.

    Same trace format as `utils.golden.replay`:
    per-vote (votes, consider, confidence, changed).
    """
    lib = load_library()
    n = len(errs)
    errs_arr = (ctypes.c_int32 * n)(*[normalize_err(e) for e in errs])
    states = (ctypes.c_uint32 * n)()
    changed = (ctypes.c_int32 * n)()
    lib.avh_vote_record_replay(1 if accepted else 0, errs_arr, n,
                               cfg.window, cfg.quorum, cfg.finalization_score,
                               states, changed)
    return [(int(states[i]) & 0xFF, (int(states[i]) >> 8) & 0xFF,
             (int(states[i]) >> 16) & 0xFFFF, bool(changed[i]))
            for i in range(n)]


class NativeProcessor:
    """The native Processor, method-compatible with `processor.Processor`.

    Differences from the Python twin: targets are registered by their scalar
    attributes (hash / initial preference / validity / score) rather than a
    `Target` object — the native boundary keeps objects on the caller's side;
    `invalidate(hash)` replaces mutating a Target's is_valid.
    """

    def __init__(
        self,
        cfg: AvalancheConfig = DEFAULT_CONFIG,
        advance_round: bool = True,
        node_selection: str = "lowest",
        seed: int = 0,
    ) -> None:
        if node_selection not in ("lowest", "random"):
            raise ValueError("node_selection must be 'lowest' or 'random'")
        self._lib = load_library()
        self._cfg = cfg
        self._handle = self._lib.avh_processor_new(
            cfg.window, cfg.quorum, cfg.finalization_score,
            cfg.max_element_poll, cfg.time_step_s, cfg.request_timeout_s,
            1 if cfg.strict_validation else 0, 1 if advance_round else 0,
            1 if node_selection == "random" else 0, seed)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.avh_stop(self._h())
            self._lib.avh_processor_free(self._h())
            self._handle = None

    def _h(self):
        """Live handle, or a clean error after close() (never pass NULL —
        a closed handle must not reach the C ABI)."""
        if self._handle is None:
            raise RuntimeError("NativeProcessor is closed")
        return self._handle

    def __del__(self) -> None:  # best-effort; prefer close()
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "NativeProcessor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- clock ------------------------------------------------------------
    def set_stub_time(self, t: float) -> None:
        self._lib.avh_set_stub_time(self._h(), t)

    # --- membership -------------------------------------------------------
    def add_node(self, node_id: int) -> None:
        self._lib.avh_add_node(self._h(), node_id)

    def nodes_ids(self) -> List[int]:
        cap = 4096
        buf = (ctypes.c_int64 * cap)()
        n = self._lib.avh_node_ids(self._h(), buf, cap)
        if n > cap:
            cap = n
            buf = (ctypes.c_int64 * cap)()
            n = self._lib.avh_node_ids(self._h(), buf, cap)
        return [int(buf[i]) for i in range(min(n, cap))]

    # --- admission / state ------------------------------------------------
    def add_target_to_reconcile(self, target_hash: int, accepted: bool,
                                valid: bool = True, score: int = 1) -> bool:
        return bool(self._lib.avh_add_target(
            self._handle, target_hash, 1 if accepted else 0,
            1 if valid else 0, score))

    def invalidate(self, target_hash: int) -> bool:
        return bool(self._lib.avh_set_target_valid(self._h(),
                                                   target_hash, 0))

    def get_round(self) -> int:
        return int(self._lib.avh_get_round(self._h()))

    def is_accepted(self, target_hash: int) -> bool:
        return bool(self._lib.avh_is_accepted(self._h(), target_hash))

    def get_confidence(self, target_hash: int) -> int:
        c = self._lib.avh_get_confidence(self._h(), target_hash)
        if c < 0:
            raise KeyError(f"VoteRecord not found for hash {target_hash}")
        return c

    def outstanding_requests(self) -> int:
        return int(self._lib.avh_outstanding_requests(self._h()))

    # --- polls ------------------------------------------------------------
    def get_invs_for_next_poll(self) -> List[int]:
        cap = max(self._cfg.max_element_poll, 1)
        buf = (ctypes.c_int64 * cap)()
        n = self._lib.avh_get_invs(self._h(), buf, cap)
        return [int(buf[i]) for i in range(min(n, cap))]

    def get_suitable_node_to_query(self) -> int:
        return int(self._lib.avh_suitable_node(self._h()))

    # --- ingest -----------------------------------------------------------
    def register_votes(self, node_id: int, resp: Response,
                       updates: List[StatusUpdate]) -> bool:
        votes: Sequence[Vote] = resp.get_votes()
        n = len(votes)
        hashes = (ctypes.c_int64 * max(n, 1))(*[v.get_hash() for v in votes])
        errs = (ctypes.c_int32 * max(n, 1))(
            *[normalize_err(v.get_error()) for v in votes])
        # At most one status update per vote, so n slots always suffice.
        cap = max(n, 1)
        out_h = (ctypes.c_int64 * cap)()
        out_s = (ctypes.c_int8 * cap)()
        n_up = ctypes.c_int32(0)
        ok = self._lib.avh_register_votes(
            self._h(), node_id, resp.get_round(), hashes, errs, n,
            out_h, out_s, cap, ctypes.byref(n_up))
        for i in range(n_up.value):
            updates.append(StatusUpdate(int(out_h[i]), Status(int(out_s[i]))))
        return bool(ok)

    # --- event loop -------------------------------------------------------
    def event_loop(self) -> bool:
        return bool(self._lib.avh_event_loop_tick(self._h()))

    def start(self) -> bool:
        return bool(self._lib.avh_start(self._h()))

    def stop(self) -> bool:
        return bool(self._lib.avh_stop(self._h()))
