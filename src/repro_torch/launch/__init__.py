"""Entry points of the port: ``serve`` (``SearchServer`` and its CLI),
``train`` and ``mesh`` (the mesh builders)."""
