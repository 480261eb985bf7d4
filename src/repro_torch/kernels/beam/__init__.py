"""The beam's level loop over a flattened VP tree on the card
(``core/vptree.search_beam``): ``beam`` binds ``csrc/beam.cu``; its plain
version is ``core/vptree.beam_levels``.  No TPU kernel stands behind it:
the JAX package's beam is one ``jax.jit`` program, and the eager port paid
a launch for each op."""
