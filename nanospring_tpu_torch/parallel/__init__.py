"""Scale-out over ``torch.distributed``, one rank per device: the
counterpart of the JAX package's ``parallel/`` (a ``reads`` mesh axis,
``shard_map`` and XLA collectives).

- ``mesh.py``: the process group (``initialize``, ``Group``) and the
  collectives the other modules use;
- ``sharded_join.py``: the sketch join with two ragged all-to-all
  exchanges (value owner, then pair owner);
- ``pipeline.py``: ``compress_mesh``, the whole store in every rank;
- ``distributed.py``: ``compress_distributed``, each rank with its own
  FASTQ shard, and the per-rank entry point (``python -m``).

The reference's only parallelism is shared-memory OpenMP with a
lock-striped claim table (src/Consensus.cpp:256-277,444-468); here claims
are owner-computes over overlap components, with no locks.
"""
