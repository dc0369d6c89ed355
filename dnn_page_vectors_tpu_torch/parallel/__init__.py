"""Work across processes and cards: the training mesh and its collectives
(``mesh``), the tensor-parallel split of the transformer's parameters
(``sharding``), ring attention over the mesh's seq group
(``ring_attention``), and ``multihost``'s process info, barriers and the
partition split of partitioned serving."""
