"""The exact re-score of gathered candidate lists on the card
(``core/scan.topk_candidates``): ``rescore`` binds ``csrc/rescore.cu``; its
plain version is ``core/scan._select_candidates`` over the gathered rows.
No TPU kernel stands behind it: the JAX package's ``topk_candidates`` is jnp
under ``vmap``, and the eager port paid ~7 passes over a (B, C, d) gather."""
