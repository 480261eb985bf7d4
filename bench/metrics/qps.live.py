"""Queries answered in the closed-loop window over the window's seconds
(the live cells: exact search under deletes)."""
from bench.harness.readers import closed_qps as read  # noqa: F401
