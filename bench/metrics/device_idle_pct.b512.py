"""Share of the profiled half in which no kernel, copy or set ran on the
card (the b512 cells)."""
from bench.harness.readers import idle_pct as read  # noqa: F401
