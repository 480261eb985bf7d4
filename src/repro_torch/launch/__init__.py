"""Entry points of the port: ``serve`` (``SearchServer`` and its CLI),
``train``, ``mesh`` (the mesh builders), ``cells`` (the (arch x shape x
mesh) cell table) and ``dryrun`` (cells run on meta tensors over the
production mesh)."""
