"""Tiled pairwise-distance kernel (port of ``repro.kernels.pdist``): ``ops``
dispatches, ``pdist`` binds ``csrc/pdist.cu``, ``ref`` is the plain version."""
