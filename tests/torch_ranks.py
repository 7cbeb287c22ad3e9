"""The port's side of the sharded tests, run in spawned gloo ranks.

The JAX side of a sharded test runs in the pytest process over its 8
virtual devices; the port's side runs in ranks that import torch and
the port only: a `RankPool` (`go_avalanche_tpu_torch/parallel/ranks.py`,
one pool per test module) hands each case function below to the first
`world` ranks, each in a fresh gloo process group over a `FileStore` in
the pool's directory (no TCP ports, so it works under xdist).  The case
functions take and return numpy trees (`convert.py`'s layout), so no
torch tensor crosses a process boundary.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- cases


def config(knobs: dict):
    """The port's config from plain knobs (enum values as strings)."""
    from go_avalanche_tpu_torch.config import (AdversaryStrategy,
                                               AvalancheConfig, VoteMode)

    kw = dict(knobs)
    if "adversary_strategy" in kw:
        kw["adversary_strategy"] = AdversaryStrategy(
            kw["adversary_strategy"])
    if "vote_mode" in kw:
        kw["vote_mode"] = VoteMode(kw["vote_mode"])
    return AvalancheConfig(**kw)


def _tel_numpy(tel):
    return None if tel is None else {f: getattr(tel, f).cpu().numpy()
                                     for f in tel._fields}


def avalanche_case(state_np, knobs: dict, mesh_shape, mode: str,
                   rounds: int, device: str = "cpu"):
    """The port's sharded avalanche drive on this rank: the global state
    from numpy, this rank's block, then `rounds` rounds of
    `run_scan_sharded` ("scan"), the step ("step"), or `run_sharded` to
    settlement with `rounds` as its cap ("run"); returns the gathered
    global state, the telemetry rows, the collectives one round
    recorded, and `sync.reads`.  With ``device="cuda"`` every rank's
    block lies on the one card (gloo ranks sharing it)."""
    from go_avalanche_tpu_torch import convert, sync
    from go_avalanche_tpu_torch.parallel import collectives, sharded
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    cfg = config(knobs)
    mesh = make_mesh(*mesh_shape)
    block = sharded.shard_state(
        convert.state_from_numpy(state_np, device=device), mesh)
    collectives.recorded.clear()
    sync.reads = 0
    tel = None
    if mode == "run":
        block = sharded.run_sharded(mesh, block, cfg, max_rounds=rounds)
    elif mode == "scan":
        block, tel = sharded.run_scan_sharded(mesh, block, cfg, rounds)
    else:
        step = sharded.make_sharded_round_step(mesh, cfg)
        rows = []
        for _ in range(rounds):
            block, t = step(block)
            rows.append(t)
        tel = sharded.stack_telemetry(rows)
    recorded = set(collectives.recorded)
    reads = sync.reads
    whole = sharded.gather_state(block, mesh)
    return (convert.state_to_numpy(whole), _tel_numpy(tel), recorded, reads)


def dag_case(state_np, knobs: dict, mesh_shape, mode: str, rounds: int,
             device: str = "cpu"):
    """`avalanche_case` for the DAG: "step" rounds or `run_sharded_dag`
    ("run")."""
    from go_avalanche_tpu_torch import convert, sync
    from go_avalanche_tpu_torch.parallel import (collectives, sharded,
                                                 sharded_dag)
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    cfg = config(knobs)
    mesh = make_mesh(*mesh_shape)
    block = sharded_dag.shard_dag_state(
        convert.dag_state_from_numpy(state_np, device=device), mesh)
    collectives.recorded.clear()
    sync.reads = 0
    tel = None
    if mode == "run":
        block = sharded_dag.run_sharded_dag(mesh, block, cfg,
                                            max_rounds=rounds)
    else:
        step = sharded_dag.make_sharded_dag_round_step(mesh, cfg)
        rows = []
        for _ in range(rounds):
            block, t = step(block)
            rows.append(t)
        tel = sharded.stack_telemetry(rows)
    recorded = set(collectives.recorded)
    reads = sync.reads
    whole = sharded_dag.gather_dag_state(block, mesh)
    return (convert.dag_state_to_numpy(whole), _tel_numpy(tel), recorded,
            reads)


# The streaming drivers: (sharded module, state carrier, placement,
# gather, step builder, scan driver, settle driver or None).
STREAMS = {
    "backlog": ("sharded_backlog", "backlog_state", "shard_backlog_state",
                "gather_backlog_state", "make_sharded_backlog_step",
                "run_scan_sharded_backlog", "run_sharded_backlog"),
    "streaming_dag": ("sharded_streaming_dag", "streaming_dag_state",
                      "shard_streaming_dag_state",
                      "gather_streaming_dag_state",
                      "make_sharded_streaming_dag_step",
                      "run_scan_sharded_streaming_dag",
                      "run_sharded_streaming_dag"),
    "node_stream": ("sharded_node_stream", "node_stream_state",
                    "shard_node_stream_state", "gather_node_stream_state",
                    "make_sharded_node_stream_step",
                    "run_scan_sharded_node_stream", None),
}


def stream_case(kind: str, state_np, knobs: dict, mesh_shape, mode: str,
                rounds: int, device: str = "cpu"):
    """A streaming driver on this rank: the global state of `kind` from
    numpy, this rank's block, then `rounds` steps ("step"), the scan
    driver ("scan") or the settle driver to settlement with `rounds` as
    its cap ("run"); returns the gathered global state, the telemetry
    (nested dicts), the collectives recorded and `sync.reads`."""
    import importlib

    from go_avalanche_tpu_torch import convert, sync, workload
    from go_avalanche_tpu_torch.models.backlog import stack_tree
    from go_avalanche_tpu_torch.parallel import collectives
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    mod_name, carrier, shard, gather, make_step, scan, settle = STREAMS[kind]
    mod = importlib.import_module(
        f"go_avalanche_tpu_torch.parallel.{mod_name}")
    cfg = config(knobs)
    mesh = make_mesh(*mesh_shape)
    block = getattr(mod, shard)(
        getattr(convert, f"{carrier}_from_numpy")(state_np, device=device),
        mesh)
    collectives.recorded.clear()
    sync.reads = 0
    tel = None
    if mode == "run":
        block = getattr(mod, settle)(mesh, block, cfg, max_rounds=rounds)
    elif mode == "scan":
        block, tel = getattr(mod, scan)(mesh, block, cfg, rounds)
    else:
        step = getattr(mod, make_step)(mesh, cfg)
        rows = []
        for _ in range(rounds):
            block, t = step(block)
            rows.append(t)
        tel = stack_tree(rows)
    recorded = set(collectives.recorded)
    reads = sync.reads
    whole = getattr(mod, gather)(block, mesh)
    return (getattr(convert, f"{carrier}_to_numpy")(whole),
            workload.numpy_tree(tel), recorded, reads)


def dcp_case(state_np, knobs: dict, mesh_shape, rounds: int, path: str,
             stage: str, device: str = "cpu"):
    """The DCP pair on the streaming DAG, on this rank.

    "save": `rounds` steps from `state_np`, then `save_checkpoint_dcp` to
    `path`; returns the gathered state.  "resume": restore `path` onto
    this mesh (the template a fresh placement of `state_np`), then
    `rounds` more steps; returns the gathered state.  "restore": restore
    onto this mesh and gather, no steps."""
    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh
    from go_avalanche_tpu_torch.utils import checkpoint

    cfg = config(knobs)
    mesh = make_mesh(*mesh_shape)
    block = ssd.shard_streaming_dag_state(
        convert.streaming_dag_state_from_numpy(state_np, device=device),
        mesh)
    step = ssd.make_sharded_streaming_dag_step(mesh, cfg)
    if stage in ("resume", "restore"):
        block = checkpoint.restore_checkpoint_dcp(path, block, mesh)
    if stage != "restore":
        for _ in range(rounds):
            block = step(block)[0]
    if stage == "save":
        checkpoint.save_checkpoint_dcp(path, block, mesh)
    return convert.streaming_dag_state_to_numpy(
        ssd.gather_streaming_dag_state(block, mesh))


def poll_cap_case(pollable, rank, cap: int, mesh_shape):
    """`sharded.global_capped_poll_mask` on this rank's block of the
    global bool ``[N, T]`` plane and int32 ``[T]`` ranks; the gathered
    global mask."""
    import torch

    from go_avalanche_tpu_torch.parallel import collectives as C
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import (NODES_AXIS, TXS_AXIS,
                                                      make_mesh)

    mesh = make_mesh(*mesh_shape)
    block = sharded.block_of(torch.from_numpy(pollable),
                             (NODES_AXIS, TXS_AXIS), mesh)
    rank_t = sharded.block_of(torch.from_numpy(rank), (TXS_AXIS,), mesh)
    # The orders the one-shard path reads (`init` keeps them).
    order = torch.from_numpy(np.argsort(rank).astype(np.int32))
    with C.bind(mesh):
        out = sharded.global_capped_poll_mask(block, rank_t, cap,
                                              mesh.shape[TXS_AXIS], order,
                                              torch.from_numpy(rank))
        return sharded.assemble(out, (NODES_AXIS, TXS_AXIS)).numpy()


def gossip_case(peers, polled, fused: bool, mesh_shape):
    """`sharded._gossip_heard_packed` on this rank's rows (all peers'
    ids global) and columns; the gathered, unpacked global plane."""
    import torch

    from go_avalanche_tpu_torch.ops.bitops import unpack_bool_plane
    from go_avalanche_tpu_torch.parallel import collectives as C
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import (NODES_AXIS, TXS_AXIS,
                                                      make_mesh)

    mesh = make_mesh(*mesh_shape)
    peers_b = sharded.block_of(torch.from_numpy(peers), (NODES_AXIS, None),
                               mesh)
    polled_b = sharded.block_of(torch.from_numpy(polled),
                                (NODES_AXIS, TXS_AXIS), mesh)
    with C.bind(mesh):
        heard = sharded._gossip_heard_packed(peers_b, polled_b,
                                             peers.shape[0], fused=fused)
        heard = unpack_bool_plane(heard, polled_b.shape[1])
        return sharded.assemble(heard, (NODES_AXIS, TXS_AXIS)).numpy()


FLEET_VECTORS = ("violations", "settled", "finality_round",
                 "finalized_fraction", "stalled", "cut_windows", "cut_split",
                 "spike_windows", "region_windows", "lat_percentiles",
                 "arrived")


def fleet_case(model: str, knobs: dict, kw: dict, mesh_shape):
    """`fleet.run_fleet` over a ``(trials, nodes)`` fleet mesh of the
    ranks; the result's vectors, telemetry, trace, summary row,
    realizations and recorded collectives."""
    from go_avalanche_tpu_torch import fleet
    from go_avalanche_tpu_torch.parallel import collectives
    from go_avalanche_tpu_torch.parallel.sharded_fleet import make_fleet_mesh

    mesh = make_fleet_mesh(*mesh_shape)
    collectives.recorded.clear()
    res = fleet.run_fleet(model, config(knobs), mesh=mesh, device="cpu",
                          **kw)
    trace = None if res.trace is None else (res.trace.data, res.trace.cursor)
    return ({name: getattr(res, name) for name in FLEET_VECTORS},
            res.telemetry, trace, res.summary(), res.realizations(),
            set(collectives.recorded))


def phase_grid_case(model: str, knobs: dict, grid: dict, kw: dict,
                    mesh_shape):
    """`fleet.run_phase_grid` over a fleet mesh of the ranks."""
    from go_avalanche_tpu_torch import fleet
    from go_avalanche_tpu_torch.parallel.sharded_fleet import make_fleet_mesh

    return fleet.run_phase_grid(model, config(knobs), grid,
                                mesh=make_fleet_mesh(*mesh_shape),
                                device="cpu", **kw)


def fleet_refusal_case(fleet_size: int, mesh_shape) -> str:
    """The message with which `run_fleet` refuses `fleet_size` trials on
    this fleet mesh."""
    from go_avalanche_tpu_torch import fleet
    from go_avalanche_tpu_torch.parallel.sharded_fleet import make_fleet_mesh

    try:
        fleet.run_fleet("snowball", config({}), fleet=fleet_size, n_nodes=8,
                        n_rounds=1, mesh=make_fleet_mesh(*mesh_shape),
                        device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def run_sim_case(argv):
    """`run_sim.main(argv)` on this rank; the result dict."""
    from go_avalanche_tpu_torch import run_sim

    return run_sim.main(list(argv))


def collectives_case(mesh_shape, seed: int):
    """Each collective on this rank's seeded inputs (uint8, int32 and
    bool blocks): the inputs and every result, for a numpy oracle."""
    import torch

    from go_avalanche_tpu_torch.parallel import collectives as C
    from go_avalanche_tpu_torch.parallel.mesh import (NODES_AXIS, TXS_AXIS,
                                                      make_mesh)

    mesh = make_mesh(*mesh_shape)
    rng = np.random.default_rng(seed + mesh.rank)
    n = mesh.shape[NODES_AXIS]
    inputs = {"u8": rng.integers(0, 256, (2 * n, 3)).astype(np.uint8),
              "i32": rng.integers(-9, 9, (2 * n, 3)).astype(np.int32),
              "bool": rng.random((2 * n, 3)) < 0.5}
    out = {}
    with C.bind(mesh):
        out["index"] = (C.axis_index(NODES_AXIS), C.axis_index(TXS_AXIS))
        for name, x in inputs.items():
            t = torch.from_numpy(x)
            out[name] = {
                "gather_nodes": C.all_gather(t, NODES_AXIS).numpy(),
                "gather_txs_dim1": C.all_gather(t, TXS_AXIS, dim=1).numpy(),
                "gather_both": C.all_gather(t, (NODES_AXIS,
                                                TXS_AXIS)).numpy(),
                "to_all_nodes": C.all_to_all(t, NODES_AXIS).numpy(),
            }
            if name != "bool":
                out[name]["psum_both"] = C.psum(
                    t, (NODES_AXIS, TXS_AXIS)).numpy()
                out[name]["psum_txs"] = C.psum(t, TXS_AXIS).numpy()
    return inputs, out, mesh.ranks


# ------------------------------------------------------ the contract audit


def audit_driver_case(driver: str, stale=None):
    """`analysis.audit.audit_sharded` of one driver on the 2x2 mesh of
    the ranks, on the CPU; with `stale`, a ``(kind, axes)`` entry no
    variant reaches planted in the driver's manifest.  The failures."""
    from go_avalanche_tpu_torch.analysis import audit

    mod = audit.driver_module(driver)
    declared = mod.DECLARED_COLLECTIVES
    if stale is not None:
        mod.DECLARED_COLLECTIVES = declared | {tuple(stale)}
    try:
        return audit.audit_sharded(driver, "cpu")
    finally:
        mod.DECLARED_COLLECTIVES = declared


def audit_fleet_case():
    """`analysis.audit.audit_sharded_fleet` on the 2x2 fleet mesh of the
    ranks, on the CPU."""
    from go_avalanche_tpu_torch.analysis import audit

    return audit.audit_sharded_fleet("cpu")


def footprint_case(dtypes: str = "reference"):
    """`parallel.footprint_cases` on the 2x2 audit mesh of the ranks, on
    the CPU: each driver's per-rank plane bytes."""
    from go_avalanche_tpu_torch import parallel
    from go_avalanche_tpu_torch.obs import resources

    return {name: resources.plane_bytes(case.state, case.specs, case.mesh,
                                        dtypes=dtypes)
            for name, case in parallel.footprint_cases(device="cpu").items()}


def fleet_scan_case(state_np, knobs: dict, mesh_shape, rounds: int):
    """`sharded_fleet.fleet_scan_program` over a fleet mesh of the
    ranks: this rank's block of the stacked state (`convert`'s numpy
    layout with a leading trial axis) scanned `rounds` rounds in place,
    then every block gathered in mesh order; the collectives the scan
    itself called."""
    import torch

    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.parallel import collectives as C
    from go_avalanche_tpu_torch.parallel import sharded_fleet as sf

    mesh = sf.make_fleet_mesh(*mesh_shape)
    block = sf.shard_fleet_state(
        convert.state_from_numpy(state_np, device="cpu"), mesh)
    ptrs = {x.data_ptr() for x in block.records}
    C.recorded.clear()
    out = sf.fleet_scan_program(mesh, config(knobs), rounds)(block)
    recorded = set(C.recorded)
    in_place = out is block and {x.data_ptr() for x in out.records} == ptrs
    with C.bind(mesh):
        whole = sf._map(lambda x: C.all_gather(x, sf.FLEET_AXES), out)
    return convert.state_to_numpy(whole), recorded, in_place
