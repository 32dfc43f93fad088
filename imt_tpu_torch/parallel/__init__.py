"""Multi-GPU sharding over torch.distributed (``imt_tpu.parallel``'s
counterpart): ``sharded.py`` (meshes, sharded hashes and tree builds,
``ShardedIndexedMerkleTree``), ``local_plan.py`` (the shard-local
planner), ``collectives.py`` (the counted all-gather, psum and
point-to-point exchange) and ``collective_audit.py`` (the
N-independence audit)."""
