"""Distribution substrate of the port.  Only the single-device embedding
lookup is here; sharding waits for ``ShardedIndex``."""
