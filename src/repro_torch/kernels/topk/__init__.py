"""Fused distance + streaming top-k kernel (port of ``repro.kernels.topk``,
f32 matmul regime): ``ops`` dispatches, ``topk`` binds ``csrc/topk.cu``,
``ref`` is the plain version."""
