"""Distribution substrate of the port: the mesh, ``shard_map`` and the
sharding policies (``sharding``: every rank of a mesh on one device), the
embedding lookup, gradient compression and the roofline accounting of the
kernels (``roofline``).  Sharded search holds every shard on one device
(``core/index.ShardedIndex``)."""
