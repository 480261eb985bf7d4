"""Fused distance + streaming top-k kernels (port of ``repro.kernels.topk``:
the f32 matmul and cube regimes, and the int8 corpus-code regime): ``ops``
dispatches, ``topk`` binds ``csrc/topk.cu`` and ``csrc/topk_int8.cu``,
``ref`` holds the plain versions."""
