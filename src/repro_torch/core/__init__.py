"""Core engine of the port: metrics, scan, projection, embedding, VP tree,
int8 quantisation, index protocol, the exact brute engine (``baselines``)
and the InfinitySearch pipeline (``search``)."""
