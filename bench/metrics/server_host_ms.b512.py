"""The server's host time per batch of the b512 cells: a ``query`` call's
wall time less its ``dispatch`` span (padding, the copy to the card, the
result back)."""
from bench.harness.readers import server_host_ms as read  # noqa: F401
