"""Model substrate of the port: parameter declarations (``params``), the
recsys family (``recsys``), the GCN (``gnn``, ``sampler``) and the dense
LM transformer (``layers``, ``attention``, ``transformer``)."""
