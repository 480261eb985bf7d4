"""Synthetic datasets (copied from the JAX package, numpy only)."""
