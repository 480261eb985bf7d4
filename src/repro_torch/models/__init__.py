"""Model substrate of the port: parameter declarations (``params``) and the
recsys family (``recsys``).  The LM and GNN families wait for their
slices."""
