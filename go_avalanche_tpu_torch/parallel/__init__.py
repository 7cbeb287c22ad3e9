"""Scale-out over `torch.distributed` — `go_avalanche_tpu/parallel/`.

  mesh               the ``(nodes, txs)`` rank mesh and its process groups
  collectives        all_gather / all_to_all / psum / axis_index on it
  runtime            process-group bring-up, the host-aware mesh
  sharded            the sharded avalanche round and its drivers
  sharded_dag        the sharded conflict-set DAG
  sharded_fleet      the trial-sharded Monte-Carlo fleet
  distributed_smoke  an N-process smoke of the sharded round

Each rank runs the reference's `shard_map` body for its own block; the
collectives are explicit calls.  The streaming drivers (backlog,
streaming DAG, node stream) and the reference's `footprint_cases`
(which reads its XLA resource tooling) are not ported yet (ROADMAP.md
Queue 1, items 15 and 17).
"""
