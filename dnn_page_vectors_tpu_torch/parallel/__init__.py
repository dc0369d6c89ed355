"""Work across processes and hosts: for now only the partition split of
partitioned serving (``multihost.partition_shard_ranges``). The rest of
the JAX package's parallel/ (the mesh, sharding, ring attention and the
multi-host batching) waits for a machine with several cards (ROADMAP.md
queue 1, item 6)."""
