"""Scale-out over `torch.distributed` — `go_avalanche_tpu/parallel/`.

  mesh               the ``(nodes, txs)`` rank mesh and its process groups
  collectives        all_gather / all_to_all / psum / axis_index on it
  runtime            process-group bring-up, the host-aware mesh
  sharded            the sharded avalanche round and its drivers
  sharded_dag        the sharded conflict-set DAG
  sharded_fleet      the trial-sharded Monte-Carlo fleet
  sharded_backlog    the sharded streaming backlog
  sharded_streaming_dag  the sharded streaming conflict DAG
  sharded_node_stream    the sharded node-axis stream
  ranks              a pool of spawned ranks taking one case at a time
  distributed_smoke  an N-process smoke of the sharded round

Each rank runs the reference's `shard_map` body for its own block; the
collectives are explicit calls.  A sharded state is saved and restored
with `utils/checkpoint.save_checkpoint_dcp` / `restore_checkpoint_dcp`.

Also home of the per-driver footprint registry (`footprint_cases`): for
each of the five sharded drivers, the audit-shape global state, its
spec tree and the step builder the contract audit runs
(`analysis/audit.py`) — what `obs/resources.sharded_driver_records`
needs to hold a rank's memory ledger of one round against the analytic
per-rank footprint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class FootprintCase:
    """One sharded driver's resource case: ``program_builder(mesh)`` is
    the step on this rank's block (``shard(state, mesh)``); ``(state,
    specs, mesh)`` feed `obs.resources.footprint` for the per-rank
    bytes."""

    driver: str
    mesh: object
    state: object
    specs: object
    shard: object            # (state, mesh) -> this rank's block
    program_builder: object  # mesh -> step(block) -> (block, telemetry)


def footprint_cases(drivers: Optional[Sequence[str]] = None,
                    device="cuda") -> Dict[str, FootprintCase]:
    """The five sharded drivers' cases on the 2x2 audit mesh, base
    variant each, on `device` — states, configs and step builders from
    the contract audit's case table (`analysis.audit._sharded_case`),
    so the resource plane accounts the audited programs.  Raises
    `analysis.audit.AuditUnavailable` unless 4 ranks run (the
    reference's `go_avalanche_tpu/parallel/__init__.py:75`)."""
    from go_avalanche_tpu_torch.analysis import audit

    mesh = audit._audit_mesh()
    out: Dict[str, FootprintCase] = {}
    for driver in (drivers or audit.SHARDED_DRIVERS):
        variants, _, _ = audit._sharded_case(driver, device)
        _, cfg, state = variants[0]  # the base variant
        mod = audit.driver_module(driver)
        _, place, make_step = audit._DRIVER_MODULES[driver]
        out[driver] = FootprintCase(
            driver=driver, mesh=mesh, state=state,
            specs=mod.specs_of(state), shard=getattr(mod, place),
            program_builder=lambda m, mod=mod, make=make_step, cfg=cfg:
                getattr(mod, make)(m, cfg))
    return out
