"""Distribution substrate of the port: the single-device embedding lookup
and the roofline accounting of the kernels (``roofline``).  Sharded search
holds every shard on one device (``core/index.ShardedIndex``)."""
