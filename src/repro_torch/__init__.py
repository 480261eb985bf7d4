"""PyTorch + CUDA port of the Infinity Search engine (``repro``'s twin).

Mirrors the layout of the JAX package ``repro`` and holds itself to it in
``tests/test_torch_*.py``: the same numpy inputs go through both packages.
This package imports ``torch``, numpy and the standard library only — never
``jax`` and never anything under ``repro``.

Entry points (``core.search.InfinityIndex.build``, ``core.index.build``,
``core.baselines.BruteIndex.build``, ``core.quant.QuantStore.build`` and
the loaders in ``convert``) take ``device=`` and default to CUDA; see
``device.py``.  The hand-written Hopper kernels live in ``csrc/`` and are
bound in ``kernels/``.
"""
