"""Embedding-bag kernel (port of ``repro.kernels.bag``): ``ops`` dispatches,
``bag`` binds ``csrc/bag.cu``, ``ref`` is the plain version."""
