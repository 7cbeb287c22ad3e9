"""The trial-sharded fleet — `go_avalanche_tpu/parallel/sharded_fleet.py`.

The fleet (`fleet.py`) runs whole dense sims one per key; this module
lays its trial axis over a ``(trials, nodes)`` mesh of ranks, so `D`
ranks each run ``F / D`` whole trials: a contiguous slice of the trial
keys in trials-major order (the order the reference's `FLEET_SPEC`
lays them out), each through the port's own `fleet._trial_fn`, with no
communication between trials.  Then

  * the per-trial outcome, telemetry and trace vectors are all-gathered
    over both axes, in mesh order, so every rank holds the ``[F]``
    vectors the dense fleet produces;
  * `FleetCounts` is psum'd, and `fleet.run_fleet` holds it against the
    gathered vectors.

Each trial runs the dense per-trial program unchanged, so the sharded
fleet is bit-identical to the dense fleet on the same seeds; nothing
here folds a rank index into a key.

The second program on the mesh is the reference's donated bench scan,
`fleet_scan_program`: a fleet-stacked flagship state
(`workload.fleet_flagship_state`, every leaf with a leading ``[F]``
trial axis), cut on that axis over both mesh axes (`FLEET_SPEC`,
`shard_fleet_state`), each rank scanning its ``F / D`` trials through
`models/avalanche.round_step` with no collective.  The reference vmaps
the trials and donates the stack; here the trials run one after another
and each round's new state is written back into the stacked leaves, so
after a round the live bytes are the stack's and no more.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from go_avalanche_tpu_torch.models.backlog import stack_tree
from go_avalanche_tpu_torch.obs import trace as obs_trace
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, Mesh, world

TRIALS_AXIS = "trials"
# The trial axis is laid over both mesh axes, trials-major.
FLEET_AXES = (TRIALS_AXIS, NODES_AXIS)
# The reference's ``P((trials, nodes))`` in the port's spec spelling
# (`obs/resources`): dimension 0 cut over both mesh axes, the rest whole.
FLEET_SPEC = (FLEET_AXES,)

# The reference's manifest: the per-trial vectors' gather and the
# counts' psum over the trial axes, nothing else (a collective touching
# an [N, T] plane would mean a trial leaked into another's stream).
DECLARED_COLLECTIVES = frozenset({
    ("all_gather", FLEET_AXES),
    ("all_reduce", FLEET_AXES),
})


class FleetCounts(NamedTuple):
    """The summary reduction psum'd over the trial axes, the same on
    every rank; `fleet.run_fleet` holds it against the gathered
    per-trial vectors."""

    trials: torch.Tensor      # int32 — global trial count
    violations: torch.Tensor  # int32 — sum of TrialOutcome.violation
    settled: torch.Tensor     # int32 — sum of TrialOutcome.settled
    stalled: torch.Tensor     # int32 — sum of TrialOutcome.stalled


def make_fleet_mesh(n_trial_shards: int, n_node_shards: int = 1) -> Mesh:
    """A ``(trials, nodes)`` mesh over every rank, row-major.  The
    trial axis spans both axes, so the 2-D spelling is a factorization
    of the rank count."""
    if n_trial_shards < 1 or n_node_shards < 1:
        raise ValueError(f"fleet mesh axes must be >= 1, got "
                         f"{n_trial_shards}x{n_node_shards}")
    need = n_trial_shards * n_node_shards
    have = world()[0]
    if have < need:
        raise ValueError(
            f"fleet mesh {n_trial_shards}x{n_node_shards} needs {need} "
            f"devices, found {have} — start {need} ranks (torchrun "
            f"--nproc-per-node {need})")
    if have > need:
        raise ValueError(
            f"fleet mesh {n_trial_shards}x{n_node_shards} takes every "
            f"rank, but {have} ranks are running — give a mesh of "
            f"{have} ranks")
    return Mesh(np.arange(need).reshape(n_trial_shards, n_node_shards),
                FLEET_AXES)


def mesh_devices(mesh) -> int:
    """Rank count of a fleet mesh (0 for None)."""
    return 0 if mesh is None else mesh.size


def check_fleet_divisible(fleet: int, mesh) -> None:
    """F must divide by the mesh's rank count: each rank runs exactly
    F/D whole sims."""
    d = mesh_devices(mesh)
    if fleet % d:
        raise ValueError(
            f"fleet ({fleet}) must divide by the fleet mesh's device "
            f"count ({d} = "
            f"{'x'.join(str(s) for s in mesh.ranks.shape)}"
            f" devices): the trial axis shards evenly — each device "
            f"runs F/D whole sims")


def _gather(tree):
    """Every leaf of a stacked tree all-gathered along its trial axis
    (inside ``collectives.bind``); None slots pass."""
    if tree is None:
        return None
    if isinstance(tree, obs_trace.TraceBuffer):
        return obs_trace.TraceBuffer(
            data=C.all_gather(tree.data, FLEET_AXES),
            cursor=C.all_gather(tree.cursor, FLEET_AXES),
            columns=tree.columns, stride=tree.stride)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_gather(x) for x in tree))
    return C.all_gather(tree, FLEET_AXES)


def fleet_driver_program(mesh, trial):
    """The sharded fleet driver `fleet.run_fleet(mesh=...)` runs:
    ``keys [F, 2] -> (TrialOutcome [F], FleetCounts, telemetry [F, R],
    trace [F, S, M] | None)``, the same on every rank.

    `trial` is the per-key whole-sim function (`fleet._trial_fn`, the
    one the dense fleet loops over).  This rank runs its contiguous
    ``F / D`` slice of `keys`, then gathers the stacked vectors and
    psums the counts."""

    def run(keys: torch.Tensor):
        per = keys.shape[0] // mesh.size
        pos = (mesh.coords[TRIALS_AXIS] * mesh.shape[NODES_AXIS]
               + mesh.coords[NODES_AXIS])
        outs, tels, traces = [], [], []
        for key in keys[pos * per:(pos + 1) * per]:
            outcome, tel, trace = trial(key)
            outs.append(outcome)
            tels.append(tel)
            traces.append(trace)
        outcome = stack_tree(outs)
        trace = None if traces[0] is None else obs_trace.stack_fleet(traces)
        dev = keys.device
        with C.bind(mesh):
            sums = C.psum(torch.stack([
                torch.full((), per, dtype=torch.int32, device=dev),
                outcome.violation.sum(dtype=torch.int32),
                outcome.settled.sum(dtype=torch.int32),
                outcome.stalled.sum(dtype=torch.int32)]), FLEET_AXES)
            outcome = _gather(outcome)
            tel = _gather(stack_tree(tels))
            trace = _gather(trace)
        return outcome, FleetCounts(*sums), tel, trace

    return run


def _map(fn, tree):
    """`fn` over every tensor leaf of a state (nested NamedTuples and
    trace buffers); None and plain ints pass."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, obs_trace.TraceBuffer):
        return dataclasses.replace(tree, data=fn(tree.data),
                                   cursor=fn(tree.cursor))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    return tree


def _pairs(dst, src):
    """``(dst leaf, src leaf)`` of two states of one layout."""
    if isinstance(dst, torch.Tensor):
        yield dst, src
    elif isinstance(dst, obs_trace.TraceBuffer):
        yield dst.data, src.data
        yield dst.cursor, src.cursor
    elif isinstance(dst, tuple) and hasattr(dst, "_fields"):
        for d, s in zip(dst, src):
            yield from _pairs(d, s)


def trial(state, i: int):
    """Trial `i` of a fleet-stacked state: views into the stacked
    leaves."""
    return _map(lambda x: x[i], state)


def write_trial(state, i: int, new) -> None:
    """Write one trial's state `new` into slot `i` of the stacked
    leaves, in place."""
    for dst, src in _pairs(state, new):
        dst[i].copy_(src)


def fleet_state_specs(state):
    """`FLEET_SPEC` over every leaf of a fleet-stacked state (each leaf
    carries the leading ``[F]`` trial axis), None slots kept: the spec
    tree `obs/resources.footprint` takes for the per-rank bytes."""
    if isinstance(state, (torch.Tensor, obs_trace.TraceBuffer)):
        return FLEET_SPEC
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(fleet_state_specs(x) for x in state))
    return state


def _position(mesh) -> int:
    """This rank's place along the trial axis, trials-major."""
    return (mesh.coords[TRIALS_AXIS] * mesh.shape[NODES_AXIS]
            + mesh.coords[NODES_AXIS])


def shard_fleet_state(state, mesh):
    """This rank's block of a fleet-stacked state: its contiguous
    ``F / D`` trials, trials-major.  On a one-rank mesh the state
    itself; otherwise the block owns its storage, so the global stack
    can be dropped."""
    n_trials = _first(state).shape[0]
    check_fleet_divisible(n_trials, mesh)
    if mesh.size == 1:
        return state
    per = n_trials // mesh.size
    pos = _position(mesh)
    return _map(lambda x: x[pos * per:(pos + 1) * per].clone(), state)


def _first(state) -> torch.Tensor:
    for leaf, _ in _pairs(state, state):
        return leaf
    raise ValueError("a fleet state needs at least one tensor leaf")


def fleet_scan_program(mesh, cfg, n_rounds: int):
    """The reference's donated `bench.py --fleet F --mesh A,B` program:
    ``run(block) -> block``, this rank scanning the ``F / D`` trials of
    its block (`shard_fleet_state`) through `models/avalanche.
    round_step` for `n_rounds` rounds, with no collective (trials never
    communicate).  Each round's new trial state is written back into
    the block's stacked leaves, so the block is updated in place (the
    counterpart of the reference's ``donate_argnums=0``) and the live
    bytes after a round are the block's.  On the card each trial's
    phased round launches the ingest kernel of `cfg.ingest_engine` once.
    A one-rank mesh (or None) is the dense loop, as the reference's
    `bench.fleet_program` collapses there.  The megakernel is refused
    with the reference's message (its `:225-226`)."""
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.parallel.sharded import _reject_round_engine

    _reject_round_engine(cfg)

    def run(block):
        for i in range(_first(block).shape[0]):
            for _ in range(n_rounds):
                new, _ = av.round_step(trial(block, i), cfg)
                write_trial(block, i, new)
                del new
        return block

    return run
