"""Entry points of the port: ``serve`` (``SearchServer`` and its CLI)."""
