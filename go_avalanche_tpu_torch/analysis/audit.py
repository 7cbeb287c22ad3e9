"""Contract audit of the port's programs — the torch counterpart of
`go_avalanche_tpu/analysis/hlo_audit.py`.

The reference lowers each program and reads its StableHLO text.  The
port is eager and has no program text, so its audit runs ONE round of
the exact program, on the caller's device, under recorders, and judges
what the round did.  Each contract of the reference's `audit_text`
(`hlo_audit.py:332-452`) has a counterpart here:

  * **host-callback budget** (the reference's `PINNED_CALLBACK_BUDGET`,
    exactly 1 for `flagship_metrics`, else 0): the metrics-tap rows the
    round enqueues (`obs/sink.emit_round`, counted by a stand-in sink
    the audit installs), exactly the budget; the counted host reads
    (`sync.reads`) exactly the program's `HOST_READ_BUDGET`; and no
    synchronising op outside `sync.py` (`drift.SYNC_OPS`, on every
    device).  On CUDA every synchronising call of the round is also
    caught under ``torch.cuda.set_sync_debug_mode("warn")``, and one that
    does not come from `sync.py` fails; the sync debug mode exists only
    on CUDA, so on the CPU the contract rests on the dispatched ops and
    `sync.reads`.
  * **accelerator-kernel budget** (`PINNED_KERNEL_BUDGET`, the
    megakernel at most once a round): the launch counters of each
    hand-written kernel (`drift.kernel_launches`) a round, per kernel
    at most the program's budget (`round_kernels`: one launch of the
    megakernel, or one of the ingest kernel of `cfg.ingest_engine` per
    phased synchronous trial round, none on the async ring).  On CUDA
    the count must equal the budget; on the CPU the wrappers run their
    plain versions and the count is 0, a ceiling as in the reference.
  * **undeclared custom calls**: a launch of a kernel outside the
    program's budget (a ``kernel:`` class of `drift.op_histogram`).
  * **dtype budget** (`dtype_violations`): no float64 output of any
    op, and no int64 tensor of at least the ``[N, T]`` plane's elements,
    outside `DTYPE_SCOPES` — the port's documented uses: `prng`'s
    threefry word math in int64 and its XLA:CPU float32 steps emulated
    in float64 (ROADMAP.md, ground rules).  An op belongs to a scope
    when a frame of that module is on the Python stack above it.
  * **collectives**: a single-device program calls none; a sharded
    round's recorded ``(kind, axes)`` (`parallel/collectives.calls`)
    lie within its driver's `DECLARED_COLLECTIVES`, and over a driver's
    variants their union equals it (a declared entry no variant reaches
    is stale).
  * **all-gather plane guard**: no all-gather in the round whose result
    has at least the ``[N, T]`` plane's elements.  The end-of-run
    `sharded.assemble` (the global state an explicit all-gather, a
    difference by design) lies outside the audited round.
  * **donation**: on CUDA, `obs/resources.memory_record` of the round
    and `check_memory` (the state's allocated bytes and the live bytes
    after the round equal the analytic footprint: no clone survives);
    on the CPU, the output state's storages equal its analytic
    footprint, so no leaf is a view into a larger temporary.  A program
    that updates its state in place (the fleet scan) must return the
    same storages.  `streaming_step` is exempt (`PINNED_UNDONATED`).

Three tables sit under the recorders, each the port's own copy:
`PROGRAMS`, the 14 programs of `benchmarks/hlo_pin.PROGRAMS`, built at
`small_workload` shapes (`hlo_audit.py:459-481`) from the port's
`workload.py`; `_sharded_case`, the five sharded drivers' audit cases
on a 2x2 mesh with their async variants (`hlo_audit.py:761-866`); and
the sharded fleet's driver and scan pair on a 2x2 ``(trials, nodes)``
mesh (`:928-1025`).  The sharded audits need 4 ranks:
`run_sharded_audits` starts a pool of 4 gloo ranks (sharing the card
on CUDA) and runs them there.

The audited round runs on a copy of the caller's state (or a state the
audit builds) and its result is discarded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import warnings
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import torch

from go_avalanche_tpu_torch.analysis import drift

# ------------------------------------------------------------- programs

# The reference's pinned workloads (`benchmarks/hlo_pin.py:148-165`).
FLAGSHIP = dict(nodes=16384, txs=16384, rounds=20, k=8)
STREAMING = dict(nodes=4096, backlog_sets=20000, set_cap=2,
                 window_sets=1024)
FLEET_SMALL = dict(fleet=8, nodes=256, txs=256, rounds=20, k=8)
TRAFFIC = dict(nodes=4096, txs=65536, window=1024, rounds=32, k=8,
               rate=24.0)
FLEET_SHARDED = dict(FLEET_SMALL, mesh=[2, 2])
_FAULTS = [["partition", 5, 10, 0.5], ["latency_spike", 12, 15, 2]]

# program name -> workload (`benchmarks/hlo_pin.py:351-385`).
PROGRAMS: Dict[str, Dict] = {
    "flagship": dict(FLAGSHIP),
    "flagship_swar32": dict(FLAGSHIP, ingest="swar32"),
    "flagship_megakernel": dict(FLAGSHIP, round_engine="megakernel"),
    "flagship_async": dict(FLAGSHIP, latency=2),
    "flagship_async_coalesced": dict(FLAGSHIP, latency=2,
                                     inflight="coalesced"),
    "flagship_metrics": dict(FLAGSHIP, metrics_every=2),
    "flagship_faults": dict(FLAGSHIP, latency=2, faults=_FAULTS),
    "fleet_small": dict(FLEET_SMALL),
    "fleet_sharded": dict(FLEET_SHARDED),
    "flagship_stake": dict(FLAGSHIP, stake="zipf", clusters=4),
    "flagship_trace": dict(FLAGSHIP, latency=2, inflight="coalesced",
                           trace_every=2),
    "flagship_adversary": dict(FLAGSHIP, latency=2, inflight="coalesced",
                               adversary="split_vote", byzantine=0.125),
    "flagship_traffic": dict(TRAFFIC),
    "streaming_step": dict(STREAMING),
}

# Exact host-callback budget per program (absent: 0): the metrics tap's
# one row a round (`hlo_audit.py:439`).
PINNED_CALLBACK_BUDGET: Dict[str, int] = {"flagship_metrics": 1}

# The reference's accelerator-kernel budget (`hlo_audit.py:448`); the
# port's per-program budget is `round_kernels`, which agrees with it.
PINNED_KERNEL_BUDGET: Dict[str, Dict[str, int]] = {
    "flagship_megakernel": {"megakernel": 1},
}

# Programs whose state is not donated (`hlo_audit.py:454`).
PINNED_UNDONATED = frozenset({"streaming_step"})

# The port's counted host reads a round (`sync.py`) where the design
# has them (absent: 0); None where the count depends on the draw.
HOST_READ_BUDGET: Dict[str, Optional[int]] = {
    # split_vote's tie flag (`ops/adversary.policy_ctx`): one read a round.
    "flagship_adversary": 1,
    # `prng.poisson`'s accept/reject loop: one read an iteration.
    "flagship_traffic": None,
}

# Modules (or "module:function") whose ops may produce float64 or int64
# planes, and why.  Besides, an int64 tensor that becomes an index
# (`drift.INDEX_OPS`) is torch's index dtype, not a widened plane.
DTYPE_SCOPES: Dict[str, str] = {
    "prng": "threefry's 32-bit word math in int64 and XLA:CPU's float32 "
            "steps emulated in float64 (torch has no uint32 arithmetic; "
            "ROADMAP.md, ground rules)",
    "models.node_stream:_stake_share": "the resident stake share, each "
            "sum in float64 rounded once (within 3 ulp of the "
            "reference's float32 sum; ROADMAP.md Queue 3)",
}

# Audit shapes (`hlo_audit.py:464-467`): the same knobs, toy dims.
_SMALL_DIMS = dict(nodes=64, txs=64, rounds=2)
_SMALL_FLEET = dict(fleet=4, nodes=32, txs=32, rounds=2)
_SMALL_TRAFFIC = dict(nodes=64, txs=256, window=64, rounds=4, rate=4.0)
_SMALL_STREAMING = dict(nodes=64, backlog_sets=256, set_cap=2,
                        window_sets=32)


def small_workload(name: str) -> Dict:
    """The program's workload with its dimensions shrunk to audit shape
    (engine knobs untouched)."""
    workload = dict(PROGRAMS[name])
    if name in ("fleet_small", "fleet_sharded"):
        workload.update(_SMALL_FLEET)    # fleet_sharded keeps its mesh
    elif name == "flagship_traffic":
        workload.update(_SMALL_TRAFFIC)
    elif name == "streaming_step":
        workload.update(_SMALL_STREAMING)
    else:
        workload.update(_SMALL_DIMS)
    return workload


class AuditUnavailable(RuntimeError):
    """The audit cannot run here (e.g. not 4 ranks for the 2x2 mesh)."""


def ingest_kernel(cfg) -> str:
    return "vote_swar" if cfg.ingest_engine == "swar32" else "vote_u8"


def round_kernels(cfg, trial_rounds: int = 1,
                  dag: bool = False) -> Dict[str, int]:
    """The hand-written kernel launches a program makes in
    `trial_rounds` trial rounds: the megakernel once a round; the ingest
    kernel of `cfg.ingest_engine` once a round on the phased
    synchronous round, and nothing on the async ring or the absent-vote
    skip, whose ingest is plain by the reference's design.  Where
    `ops/exchange` routes to its kernels on the card, besides: `vote_packs`
    once for each exchange a round makes (one on the synchronous round,
    one for each ring age on the walk engines, at most that under
    `walk_earlyout`, none on the coalesced ring, which gathers its own
    cube), and on a `dag` round over a contiguous partition `prefs_pack`
    once."""
    from go_avalanche_tpu_torch.ops import exchange

    if cfg.round_engine == "megakernel":
        return {"megakernel": trial_rounds}
    card = torch.device("cuda")
    kernels: Dict[str, int] = {}
    if dag and exchange.prefs_pack_route(card, cfg):
        kernels["prefs_pack"] = trial_rounds
    exchanges = 1
    if cfg.async_queries():
        exchanges = (0 if cfg.inflight_engine == "coalesced"
                     else cfg.timeout_rounds() + 1)
    if exchanges and exchange.vote_packs_route(card, cfg):
        kernels["vote_packs"] = exchanges * trial_rounds
    if not (cfg.async_queries() or cfg.skip_absent_votes):
        kernels[ingest_kernel(cfg)] = trial_rounds
    return kernels


def scheduler_kernels(cfg, set_size: int, steps: int = 1,
                      sharded: bool = False) -> Dict[str, int]:
    """The streaming DAG scheduler's kernel launches in `steps` steps
    where `ops/scheduler` routes to them on the card: `refill` once a
    step unless the retire cap rewrites columns instead, and
    `settle_scan` once for a set size it takes, except on the sharded
    driver, whose settled test is its own."""
    from go_avalanche_tpu_torch.ops import scheduler

    card = torch.device("cuda")
    kernels: Dict[str, int] = {}
    if not sharded and scheduler.settle_scan_route(card, set_size):
        kernels["settle_scan"] = steps
    if cfg.stream_retire_cap is None and scheduler.refill_route(card):
        kernels["refill"] = steps
    return kernels


@dataclasses.dataclass
class Program:
    """One program to audit: ``step(state)`` is one round (returning
    the new state, or the state updated in place when `in_place`) and
    its budgets."""

    what: str
    step: Callable
    state: object
    plane_elems: int
    callbacks: int = 0
    host_reads: Optional[int] = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    exact_kernels: bool = True
    donated: bool = True
    in_place: bool = False
    mesh: object = None
    collectives: FrozenSet = frozenset()


def _device_of(tree) -> torch.device:
    from go_avalanche_tpu_torch.obs import resources

    for _, _, leaf, _ in resources._leaves(tree):
        return leaf.device
    if isinstance(tree, torch.Tensor):
        return tree.device
    return torch.device("cpu")


def copy_state(tree):
    """A copy of every tensor leaf of a state (the audited round must
    leave the caller's state as it was)."""
    from go_avalanche_tpu_torch.parallel import sharded_fleet

    return sharded_fleet._map(torch.clone, tree)


def flagship_program(name: str, workload: Dict, device="cuda") -> Program:
    """A flagship-family program of `PROGRAMS` at `workload`'s shape."""
    from go_avalanche_tpu_torch import workload as wl
    from go_avalanche_tpu_torch.models import avalanche as av

    state, cfg = wl.flagship_state(
        workload["nodes"], workload["txs"], workload["k"],
        workload.get("latency", 0), device=device,
        trace_rounds=workload["rounds"],
        inflight_engine=workload.get("inflight", "walk"),
        metrics_every=workload.get("metrics_every", 0),
        trace_every=workload.get("trace_every", 0),
        stake=workload.get("stake", "off"),
        clusters=workload.get("clusters", 1),
        adversary=workload.get("adversary", "off"),
        byzantine=workload.get("byzantine", 0.0),
        round_engine=workload.get("round_engine", "phased"),
        faults=workload.get("faults"))
    if workload.get("ingest", "u8") != "u8":
        cfg = dataclasses.replace(cfg, ingest_engine=workload["ingest"])
    return Program(
        what=name, step=lambda s: av.round_step(s, cfg)[0], state=state,
        plane_elems=workload["nodes"] * workload["txs"],
        callbacks=PINNED_CALLBACK_BUDGET.get(name, 0),
        host_reads=HOST_READ_BUDGET.get(name, 0),
        kernels=round_kernels(cfg), donated=name not in PINNED_UNDONATED)


def pinned_program(name: str, workload: Optional[Dict] = None,
                   device="cuda") -> Program:
    """The program `name` of `PROGRAMS` at `workload` (default: its
    audit shape), its state built on `device`.  `fleet_sharded` lays its
    trials over its workload's mesh when this process is one of a world
    of that many ranks, and otherwise runs as the one-rank collapse
    (the reference pins the collapse equal to `fleet_small`)."""
    from go_avalanche_tpu_torch import workload as wl
    from go_avalanche_tpu_torch.models import backlog, streaming_dag
    from go_avalanche_tpu_torch.parallel import sharded_fleet
    from go_avalanche_tpu_torch.parallel.mesh import world

    workload = dict(workload or small_workload(name))
    if name in ("fleet_small", "fleet_sharded"):
        state, cfg = wl.fleet_flagship_state(
            workload["fleet"], workload["nodes"], workload["txs"],
            workload["k"], device=device)
        mesh = None
        if name == "fleet_sharded":
            a, b = (int(x) for x in workload["mesh"])
            if world()[0] == a * b:
                mesh = sharded_fleet.make_fleet_mesh(a, b)
                state = sharded_fleet.shard_fleet_state(state, mesh)
        per_rank = workload["fleet"] // max(1, sharded_fleet.mesh_devices(
            mesh))
        return Program(
            what=name, step=sharded_fleet.fleet_scan_program(mesh, cfg, 1),
            state=state, plane_elems=workload["nodes"] * workload["txs"],
            kernels=round_kernels(cfg, per_rank), in_place=True,
            mesh=mesh)
    if name == "flagship_traffic":
        state, cfg = wl.traffic_backlog_state(
            workload["nodes"], workload["txs"], workload["window"],
            workload["k"], workload["rate"], device=device)
        return Program(
            what=name, step=lambda s: backlog.step(s, cfg)[0], state=state,
            plane_elems=workload["nodes"] * workload["window"],
            host_reads=HOST_READ_BUDGET[name], kernels=round_kernels(cfg))
    if name == "streaming_step":
        state, cfg = wl.northstar_state(
            workload["nodes"], workload["backlog_sets"],
            workload["set_cap"], workload["window_sets"],
            track_finality=False, device=device)
        return Program(
            what=name, step=lambda s: streaming_dag.step(s, cfg)[0],
            state=state, plane_elems=workload["nodes"]
            * workload["window_sets"] * workload["set_cap"],
            kernels={**round_kernels(cfg, dag=True),
                     **scheduler_kernels(cfg, workload["set_cap"])},
            donated=False)
    if name not in PROGRAMS:
        raise ValueError(f"unknown program {name!r}; programs: "
                         f"{', '.join(PROGRAMS)}")
    return flagship_program(name, workload, device)


# ------------------------------------------------------------ recording


class _TapCounter:
    """Stands in for the active metrics sink during the audited round:
    counts the tap rows it is handed."""

    def __init__(self):
        self.rows = 0

    def enqueue(self, columns, row) -> None:
        self.rows += 1


@dataclasses.dataclass
class Recording:
    """What one audited round did."""

    ops: list
    syncs: list
    indices: set
    taps: int
    reads: int
    kernels: Dict[str, int]
    calls: list
    debug_syncs: List[str]
    host_copies: List[str]

    @property
    def observed(self) -> FrozenSet:
        return frozenset((kind, axes) for kind, axes, _ in self.calls)


def _where(frame) -> str:
    return f"{frame.f_code.co_filename.rsplit('/', 2)[-1]}:{frame.f_lineno}"


@contextlib.contextmanager
def _host_copies(device: torch.device, caught: List[str]):
    """Inside the block, every tensor made on `device` from host data
    (`torch.tensor`, `torch.as_tensor`) and every host value assigned
    into a tensor on it (``x[i] = False``) is appended to `caught`, with
    where it was called: on CUDA each is a copy that waits for the
    card."""
    made = {"tensor": torch.tensor, "as_tensor": torch.as_tensor}
    setitem = torch.Tensor.__setitem__

    def watch(name):
        real = made[name]

        def wrapped(data, *args, **kwargs):
            out = real(data, *args, **kwargs)
            if not isinstance(data, torch.Tensor) and out.device == device:
                caught.append(f"torch.{name} at {_where(sys._getframe(1))}")
            return out
        return wrapped

    def assign(self, index, value):
        if not isinstance(value, torch.Tensor) and self.device == device:
            caught.append(f"a host value assigned into a tensor at "
                          f"{_where(sys._getframe(1))}")
        return setitem(self, index, value)

    torch.tensor, torch.as_tensor = watch("tensor"), watch("as_tensor")
    torch.Tensor.__setitem__ = assign
    try:
        yield
    finally:
        torch.tensor, torch.as_tensor = made["tensor"], made["as_tensor"]
        del torch.Tensor.__setitem__


@contextlib.contextmanager
def _sync_debug(cuda: bool, caught: List[str]):
    """On CUDA, every synchronising call inside the block that is not a
    counted read of `sync.py` is appended to `caught`."""
    if not cuda:
        yield
        return
    from go_avalanche_tpu_torch import sync

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            text = str(message)
            if "prototype feature" in text:
                return       # the mode's own notice when it is set
            if "called a synchronizing CUDA operation" not in text:
                shown(message, category, filename, lineno, file, line)
            elif not sync.reading:
                caught.append(f"{filename}:{lineno}: {message}")

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def record_round(step: Callable, state) -> Tuple[object, Recording]:
    """``step(state)`` once under every recorder; ``(its result, the
    recording)``."""
    from go_avalanche_tpu_torch import sync
    from go_avalanche_tpu_torch.obs import sink as obs_sink
    from go_avalanche_tpu_torch.parallel import collectives

    tap = _TapCounter()
    ops = drift.OpRecorder(tuple(DTYPE_SCOPES) + ("sync",))
    caught: List[str] = []
    copies: List[str] = []
    dev = _device_of(state)
    reads0 = sync.reads
    kernels0 = drift.kernel_launches()
    calls, collectives.calls = collectives.calls, []
    obs_sink._ACTIVE.append(tap)
    try:
        with _sync_debug(dev.type == "cuda", caught), \
                _host_copies(dev, copies), ops:
            out = step(state)
    finally:
        obs_sink._ACTIVE.remove(tap)
        calls, collectives.calls = collectives.calls, calls
    return out, Recording(
        ops=ops.ops, syncs=ops.syncs, indices=ops.indices, taps=tap.rows,
        reads=sync.reads - reads0, kernels=drift.kernel_delta(kernels0),
        calls=calls, debug_syncs=caught,
        host_copies=copies)


def dtype_violations(ops, plane_elems: int, indices=frozenset()
                     ) -> List[str]:
    """Every op output outside `DTYPE_SCOPES` that is float64, or int64
    with at least `plane_elems` elements and not an index (`indices`,
    positions in `ops`); one line per op class."""
    bad: Dict[Tuple[str, str], int] = {}
    for pos, (name, outs, scopes) in enumerate(ops):
        if any(s in DTYPE_SCOPES for s in scopes):
            continue
        for dtype, numel in outs:
            if dtype == torch.float64:
                kind = "float64"
            elif (dtype == torch.int64 and numel >= plane_elems
                  and pos not in indices):
                kind = f"int64 of {numel} elements"
            else:
                continue
            bad[(name, kind)] = bad.get((name, kind), 0) + 1
    return [f"{n} {name} output(s) of {kind} — the dtype budget forbids "
            f"float64 and int64 planes outside "
            f"{', '.join(DTYPE_SCOPES)} (u8/u16/i32/f32 engines; a wide "
            f"plane doubles its memory traffic)"
            for (name, kind), n in sorted(bad.items())]


def check_recording(rec: Recording, program: Program, cuda: bool
                    ) -> List[str]:
    """Every contract of the module docstring over one recorded round,
    bar donation (`check_donation`)."""
    what = program.what
    failures: List[str] = []
    if rec.taps != program.callbacks:
        failures.append(
            f"{what}: {rec.taps} metrics-tap row(s) a round, contract says "
            f"exactly {program.callbacks} — "
            + ("a tap leaked into an off-path program"
               if rec.taps > program.callbacks else
               "the declared tap vanished (stale contract?)"))
    if program.host_reads is not None and rec.reads != program.host_reads:
        failures.append(
            f"{what}: {rec.reads} counted host read(s) a round "
            f"(sync.reads), contract says exactly {program.host_reads}")
    for name, scopes in rec.syncs:
        if "sync" not in scopes:
            failures.append(
                f"{what}: {name} makes the host wait for the device "
                f"outside sync.py — an uncounted host read in the round")
    for line in rec.debug_syncs:
        failures.append(f"{what}: synchronising CUDA call outside "
                        f"sync.py: {line}")
    for line in rec.host_copies:
        failures.append(f"{what}: host data copied to the device in the "
                        f"round ({line}) — on CUDA the copy waits for the "
                        f"card; fill on the device instead")
    for name, got in sorted(rec.kernels.items()):
        cap = program.kernels.get(name)
        if cap is None:
            failures.append(
                f"{what}: undeclared kernel {name} launched {got} time(s) "
                f"— extend the program's kernel budget only with a "
                f"reviewed reason")
        elif got > cap:
            failures.append(
                f"{what}: {got} {name} launch(es) a round, the kernel "
                f"budget allows at most {cap} — an extra kernel entered "
                f"the program")
    if cuda and program.exact_kernels:
        for name, cap in sorted(program.kernels.items()):
            if rec.kernels.get(name, 0) < cap:
                failures.append(
                    f"{what}: {rec.kernels.get(name, 0)} {name} "
                    f"launch(es) a round on the card, the program's "
                    f"budget is {cap} — the kernel route vanished")
    failures.extend(f"{what}: {v}" for v in dtype_violations(
        rec.ops, program.plane_elems, rec.indices))
    if program.mesh is None:
        if rec.calls:
            kinds: Dict[str, int] = {}
            for kind, _, _ in rec.calls:
                kinds[kind] = kinds.get(kind, 0) + 1
            failures.append(f"{what}: single-device program calls "
                            f"collectives {kinds} — nothing may "
                            f"communicate here")
    else:
        for kind, axes in sorted(rec.observed - program.collectives):
            failures.append(
                f"{what}: UNDECLARED collective {kind} over axes "
                f"{'/'.join(axes)} — the driver's DECLARED_COLLECTIVES "
                f"manifest does not allow it")
        for kind, axes, elems in rec.calls:
            if kind == "all_gather" and elems >= program.plane_elems:
                failures.append(
                    f"{what}: all_gather over {'/'.join(axes)} of "
                    f"{elems} elements >= the unpacked [N, T] plane "
                    f"({program.plane_elems}) — gathering a full plane is "
                    f"the blow-up the packed-plane design exists to avoid")
    return failures


def check_donation(out, state, program: Program) -> List[str]:
    """The CPU half of the donation contract (module docstring)."""
    from go_avalanche_tpu_torch.obs import resources

    got = resources._storages(out)
    total = sum(got.values())
    analytic = resources.footprint(out)["total_bytes"]
    tol = max(int(0.02 * analytic), 2048)
    failures = []
    if abs(total - analytic) > tol:
        failures.append(
            f"{program.what}: the output state keeps {total} bytes of "
            f"storage alive, its analytic footprint is {analytic} (tol "
            f"{tol}) — "
            + ("a leaf is a view into a larger temporary"
               if total > analytic else "state planes share storage"))
    if program.in_place and set(got) != set(resources._storages(state)):
        failures.append(
            f"{program.what}: the program returned new storages — the "
            f"stacked state was not updated in place (the counterpart "
            f"of the reference's donated fleet scan)")
    return failures


def audit(program: Program) -> Tuple[List[str], Recording]:
    """One round of `program` under the recorders: ``(failures, the
    recording)``."""
    from go_avalanche_tpu_torch.obs import resources

    cuda = _device_of(program.state).type == "cuda"
    kept: Dict[str, object] = {}

    def round_(state):
        out, rec = record_round(program.step, state)
        kept["rec"] = rec
        if program.donated:
            kept["donation"] = check_donation(out, state, program)
        return out

    failures: List[str] = []
    if cuda and program.donated:
        analytic = resources.footprint(program.state)["total_bytes"]
        record = resources.memory_record(round_, program.state)
        # A toy state's many small leaves round up by more than the
        # default tolerance; a clone is caught by `check_donation` too.
        failures.extend(resources.check_memory(
            record, analytic, what=program.what,
            abs_tol=max(4096, resources.allocator_slack(program.state))))
    else:
        round_(program.state)
    rec = kept["rec"]
    failures = check_recording(rec, program, cuda) + failures
    failures.extend(kept.get("donation", []))
    return failures, rec


def audit_program(name: str, workload: Optional[Dict] = None,
                  device="cuda") -> List[str]:
    """The contract audit of one program of `PROGRAMS` at `workload`
    (default: its audit shape) on `device`."""
    from go_avalanche_tpu_torch.models.avalanche import _device

    return audit(pinned_program(name, workload, _device(device)))[0]


def audit_all_pinned(device="cuda") -> List[str]:
    """Every program of `PROGRAMS` at its audit shape."""
    failures = []
    for name in PROGRAMS:
        failures.extend(audit_program(name, device=device))
    return failures


# ------------------------------------------------------- sharded drivers

SHARDED_DRIVERS = ("avalanche", "dag", "backlog", "streaming_dag",
                   "node_stream")

# driver -> (module of parallel/, placement, step builder)
_DRIVER_MODULES = {
    "avalanche": ("sharded", "shard_state", "make_sharded_round_step"),
    "dag": ("sharded_dag", "shard_dag_state", "make_sharded_dag_round_step"),
    "backlog": ("sharded_backlog", "shard_backlog_state",
                "make_sharded_backlog_step"),
    "streaming_dag": ("sharded_streaming_dag", "shard_streaming_dag_state",
                      "make_sharded_streaming_dag_step"),
    "node_stream": ("sharded_node_stream", "shard_node_stream_state",
                    "make_sharded_node_stream_step"),
}

# The reference's async audit knobs (`hlo_audit.py:278-279`).
_ASYNC_KW = dict(latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
                 request_timeout_s=3.0)
# A poll cap below the audit shape's tx count: the port's manifests
# declare the cap's psum over txs, which the reference's omit (ROADMAP
# Queue 3), and this variant reaches it.
_CAPPED_KW = dict(max_element_poll=3)


def driver_module(driver: str):
    """The `parallel/` module of a driver name (or of a module name)."""
    name = _DRIVER_MODULES[driver][0] if driver in _DRIVER_MODULES \
        else driver
    return importlib.import_module(f"go_avalanche_tpu_torch.parallel.{name}")


def placement(module: str):
    """``(placement, step builder)`` of a sharded driver's module
    (``"sharded"``, ``"sharded_dag"``, ...)."""
    for name, place, make_step in _DRIVER_MODULES.values():
        if name == module:
            mod = driver_module(module)
            return getattr(mod, place), getattr(mod, make_step)
    raise ValueError(f"no sharded driver module {module!r}")


def _audit_mesh():
    """A 2x2 (nodes, txs) mesh over the running ranks."""
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh, world

    n = world()[0]
    if n != 4:
        raise AuditUnavailable(
            f"the sharded-driver audit needs 4 ranks for its 2x2 mesh, "
            f"found {n} — run it through `run_sharded_audits` (a pool of "
            f"4 ranks) or under torchrun --nproc-per-node 4")
    return make_mesh(2, 2)


def _sharded_case(driver: str, device="cuda"):
    """``(variants, declared manifest, [N, T] plane elements)`` of one
    sharded driver at audit shape; variants are ``(label, cfg, global
    state)``, the base variant first."""
    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.config import (AdversaryStrategy,
                                               AvalancheConfig)

    dev = device
    key = prng.key(0, dev)
    mod = driver_module(driver)
    if driver == "avalanche":
        from go_avalanche_tpu_torch.models import avalanche as av

        def variant(label, cfg):
            return label, cfg, av.init(key, 16, 8, cfg, device=dev)

        variants = [
            variant("base", AvalancheConfig()),
            variant("async", AvalancheConfig(
                byzantine_fraction=0.25,
                adversary_strategy=AdversaryStrategy.OPPOSE_MAJORITY,
                **_ASYNC_KW)),
            variant("capped", AvalancheConfig(**_CAPPED_KW)),
        ]
        return variants, mod.DECLARED_COLLECTIVES, 16 * 8
    if driver == "dag":
        from go_avalanche_tpu_torch.models import dag as dag_model

        cs = torch.arange(8, dtype=torch.int32, device=dev) // 2

        def variant(label, cfg):
            return label, cfg, dag_model.init(key, 16, cs, cfg, n_sets=4,
                                              set_size=2, device=dev)

        variants = [variant("base", AvalancheConfig()),
                    variant("async", AvalancheConfig(**_ASYNC_KW)),
                    variant("capped", AvalancheConfig(**_CAPPED_KW))]
        return variants, mod.DECLARED_COLLECTIVES, 16 * 8
    if driver == "backlog":
        from go_avalanche_tpu_torch.models import backlog as bl

        def variant(label, cfg):
            return label, cfg, bl.init(key, 16, 8, bl.make_backlog(
                torch.arange(32, dtype=torch.int32, device=dev)), cfg,
                device=dev)

        variants = [variant("base", AvalancheConfig())]
        return variants, mod.DECLARED_COLLECTIVES, 16 * 8
    if driver == "streaming_dag":
        from go_avalanche_tpu_torch.models import streaming_dag as sdg

        def variant(label, cfg):
            backlog = sdg.make_set_backlog(torch.arange(
                32, dtype=torch.int32, device=dev).reshape(16, 2))
            return label, cfg, sdg.init(key, 16, 8, backlog, cfg,
                                        device=dev)

        variants = [variant("base", AvalancheConfig())]
        return variants, mod.DECLARED_COLLECTIVES, 16 * 16
    if driver == "node_stream":
        from go_avalanche_tpu_torch.models import node_stream as ns

        ns_kw = dict(stake_mode="zipf", registry_nodes=32, active_nodes=16,
                     node_churn_rate=0.25)

        def variant(label, cfg):
            return label, cfg, ns.init(key, 8, cfg, device=dev)

        variants = [variant("base", AvalancheConfig(**ns_kw)),
                    variant("async", AvalancheConfig(**ns_kw, **_ASYNC_KW)),
                    variant("capped", AvalancheConfig(**ns_kw,
                                                      **_CAPPED_KW))]
        return variants, mod.DECLARED_COLLECTIVES, 16 * 8
    raise ValueError(f"unknown sharded driver {driver!r}; drivers: "
                     f"{', '.join(SHARDED_DRIVERS)}")


def sharded_program(driver: str, label: str, cfg, state, mesh, declared,
                    plane_elems: int) -> Program:
    """One round of `driver`'s step on this rank's block of `state`."""
    mod = driver_module(driver)
    _, place, make_step = _DRIVER_MODULES[driver]
    step = getattr(mod, make_step)(mesh, cfg)
    kernels = round_kernels(cfg)
    if driver == "streaming_dag":
        kernels.update(scheduler_kernels(cfg, state.dag.set_size,
                                         sharded=True))
    return Program(
        what=f"sharded:{driver}[{label}]", step=lambda b: step(b)[0],
        state=copy_state(getattr(mod, place)(state, mesh)),
        plane_elems=plane_elems,
        kernels=kernels, mesh=mesh, collectives=declared)


def audit_sharded(driver: str, device="cuda") -> List[str]:
    """The contract audit of one sharded driver on the 2x2 audit mesh
    (this process one of its 4 ranks): per variant every contract,
    across the variants the union of recorded collectives equal to the
    manifest."""
    mesh = _audit_mesh()
    variants, declared, plane_elems = _sharded_case(driver, device)
    failures: List[str] = []
    union: set = set()
    for label, cfg, state in variants:
        fails, rec = audit(sharded_program(driver, label, cfg, state, mesh,
                                           declared, plane_elems))
        failures.extend(fails)
        union |= rec.observed
    for kind, axes in sorted(declared - union):
        failures.append(
            f"sharded:{driver}: declared collective {kind} over axes "
            f"{'/'.join(axes)} never called in any audit variant — stale "
            f"manifest entry")
    return failures


def audit_all_sharded(device="cuda") -> List[str]:
    failures = []
    for driver in SHARDED_DRIVERS:
        failures.extend(audit_sharded(driver, device))
    return failures


def _fleet_audit_mesh():
    """A 2x2 ``(trials, nodes)`` fleet mesh over the running ranks."""
    from go_avalanche_tpu_torch.parallel import sharded_fleet
    from go_avalanche_tpu_torch.parallel.mesh import world

    n = world()[0]
    if n != 4:
        raise AuditUnavailable(
            f"the sharded-fleet audit needs 4 ranks for its 2x2 fleet "
            f"mesh, found {n} — run it through `run_sharded_audits`")
    return sharded_fleet.make_fleet_mesh(2, 2)


def audit_sharded_fleet(device="cuda") -> List[str]:
    """The contract audit of both programs of the sharded fleet on the
    2x2 fleet mesh (`parallel/sharded_fleet.py`): the driver
    (`fleet.compiled_fleet_program` on the mesh, the program `run_fleet`
    runs) calls only its declared collectives, and all of them; the
    scan (`fleet_scan_program`) calls none and updates its block in
    place."""
    from go_avalanche_tpu_torch import fleet as fl
    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch import workload as wl
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models.avalanche import _device
    from go_avalanche_tpu_torch.parallel import sharded_fleet

    dev = _device(device)
    mesh = _fleet_audit_mesh()
    declared = sharded_fleet.DECLARED_COLLECTIVES
    cfg = AvalancheConfig(finalization_score=16)
    driver = fl.compiled_fleet_program("avalanche", cfg, 16, 8, 2, 2, 0.5,
                                       True, 64, mesh=mesh, device=dev)
    failures, rec = audit(Program(
        what="sharded_fleet[driver]", step=driver,
        state=prng.split(prng.key(0, dev), 8), plane_elems=16 * 8,
        host_reads=None, kernels=round_kernels(cfg, 2 * 2), donated=False,
        mesh=mesh, collectives=declared))
    for kind, axes in sorted(declared - rec.observed):
        failures.append(
            f"sharded_fleet: declared collective {kind} over axes "
            f"{'/'.join(axes)} never called by the driver program — stale "
            f"manifest entry")
    state, bcfg = wl.fleet_flagship_state(8, 32, 32, device=dev)
    failures.extend(audit(Program(
        what="sharded_fleet[bench-scan]",
        step=sharded_fleet.fleet_scan_program(mesh, bcfg, 1),
        state=sharded_fleet.shard_fleet_state(state, mesh),
        plane_elems=32 * 32, kernels=round_kernels(bcfg, 2), in_place=True,
        mesh=mesh))[0])
    return failures


def sharded_rank_audits(device: str) -> List[str]:
    """Every sharded audit, on this rank of a world of 4."""
    return audit_all_sharded(device) + audit_sharded_fleet(device)


def run_sharded_audits(device="cuda", timeout: float = 600.0
                       ) -> List[str]:
    """The sharded audits in a pool of 4 spawned gloo ranks (sharing the
    card on CUDA); every rank's failures, each once."""
    import tempfile

    from go_avalanche_tpu_torch.parallel.ranks import RankPool

    with tempfile.TemporaryDirectory() as tmp:
        pool = RankPool(4, tmp)
        try:
            results = pool.run(4, sharded_rank_audits, str(device),
                               timeout=timeout)
        finally:
            pool.close()
    out: List[str] = []
    for failures in results:
        out.extend(f for f in failures if f not in out)
    return out


# --------------------------------------------------------- run_sim audit


def audit_run_sim(args, cfg, state=None, step=None, driver=None,
                  mesh=None) -> List[str]:
    """`run_sim --audit`: one round of the program the parsed flags
    select, before the runner runs it, on a copy of the runner's
    `state` under its `step` (``step(state, cfg) -> (state, ...)``; with
    `mesh`, this rank's block under ``step(block) -> (block, ...)`` of
    the sharded `driver` module, ``"sharded"``, ``"sharded_dag"``, ...).
    A fleet
    audits the program `fleet.compiled_fleet_program` gives the run,
    over the run's first key (one per rank on a mesh).  Counted host
    reads are reported, not pinned: they follow the config (the async
    ring's drains, a policy's tie flag, a Poisson draw)."""
    what = f"run_sim:{args.model}"
    if args.fleet is not None:
        from go_avalanche_tpu_torch import fleet as fl
        from go_avalanche_tpu_torch import prng
        from go_avalanche_tpu_torch.parallel import sharded_fleet

        fleet_mesh = args.fleet_mesh
        ranks = max(1, sharded_fleet.mesh_devices(fleet_mesh))
        program = fl.compiled_fleet_program(
            args.model, cfg, args.nodes, args.txs, args.max_rounds,
            args.conflict_size, args.yes_fraction, args.contested,
            args.slots, mesh=fleet_mesh, device=args.device_resolved)
        keys = prng.split(prng.key(args.seed, args.device_resolved),
                          args.fleet)[:ranks]
        sharded = ranks > 1
        return audit(Program(
            what=f"{what}@fleet{args.fleet}" + ("-mesh" if sharded else ""),
            step=program, state=keys, plane_elems=args.nodes * args.txs,
            host_reads=None, kernels=_model_kernels(args, cfg,
                                                    args.max_rounds),
            exact_kernels=False, donated=False,
            mesh=fleet_mesh if sharded else None,
            collectives=(sharded_fleet.DECLARED_COLLECTIVES if sharded
                         else frozenset())))[0]
    plane = _plane_elems(args, cfg)
    if mesh is not None:
        return audit(Program(
            what=what, step=lambda b: step(b)[0], state=copy_state(state),
            plane_elems=plane, host_reads=None,
            kernels=_model_kernels(args, cfg), exact_kernels=False,
            mesh=mesh,
            collectives=driver_module(driver).DECLARED_COLLECTIVES))[0]
    return audit(Program(
        what=what, step=lambda s: step(s, cfg)[0], state=copy_state(state),
        plane_elems=plane,
        callbacks=1 if cfg.metrics_every > 0 else 0, host_reads=None,
        kernels=_model_kernels(args, cfg), exact_kernels=False,
        donated=args.model == "avalanche"))[0]


def _model_kernels(args, cfg, rounds: int = 1) -> Dict[str, int]:
    """The run's model's kernel budget for `rounds` rounds: the family
    models (slush, snowflake) ingest no vote window; the streaming DAG's
    scheduler adds its own."""
    if args.model in ("slush", "snowflake"):
        return {}
    kernels = round_kernels(cfg, rounds,
                            dag=args.model in ("dag", "streaming_dag"))
    if args.model == "streaming_dag":
        kernels.update(scheduler_kernels(cfg, args.conflict_size, rounds))
    return kernels


def _plane_elems(args, cfg) -> int:
    """The run's unpacked ``[N, T]`` plane: the node stream's window of
    active nodes, the streaming DAG's window of sets, Snowball's one
    column."""
    if args.model in ("slush", "snowflake", "snowball"):
        return args.nodes
    if args.model == "node_stream":
        return cfg.active_nodes * args.txs
    if args.model == "backlog":
        return args.nodes * args.slots
    if args.model == "streaming_dag":
        return args.nodes * args.slots * args.conflict_size
    return args.nodes * args.txs
