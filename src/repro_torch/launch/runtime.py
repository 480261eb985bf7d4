"""The async serving runtime and its HTTP front (``repro.launch.runtime``'s
``ServingRuntime`` and ``start_http_front``) — not ported yet: both raise
``NotImplementedError`` naming their ROADMAP item.  ``launch/serve``'s
``SearchServer`` serves direct ``query`` / ``serve`` calls meanwhile."""
from __future__ import annotations

from repro_torch.core import index as index_lib

RUNTIME_ITEM = "ROADMAP.md Queue 1 item 4 (launch/runtime.py)"


class ServingRuntime:
    """Admission queue, batcher and circuit breaker in front of a
    ``SearchServer`` — waits for its port."""

    def __init__(self, *args, **kwargs):
        raise index_lib.not_ported("launch.runtime.ServingRuntime", RUNTIME_ITEM)


def start_http_front(*args, **kwargs):
    """The HTTP front of ``ServingRuntime`` — waits for its port."""
    raise index_lib.not_ported("launch.runtime.start_http_front", RUNTIME_ITEM)
