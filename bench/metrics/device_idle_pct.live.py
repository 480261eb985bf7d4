"""Share of the profiled half in which no kernel, copy or set ran on the
card (the live cells)."""
from bench.harness.readers import idle_pct as read  # noqa: F401
