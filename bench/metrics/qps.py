"""Queries answered in the closed-loop window over the window's seconds
(the infinity engine's cells)."""
from bench.harness.readers import closed_qps as read  # noqa: F401
