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
The reference's `footprint_cases`, which reads its XLA resource
tooling, is not ported yet (ROADMAP.md Queue 1, item 17).
"""
