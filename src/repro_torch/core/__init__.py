"""Core engine of the port: metrics, scan, projection, embedding, VP tree,
index protocol and the InfinitySearch pipeline (``search``)."""
