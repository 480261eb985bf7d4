"""(min, combine) semiring matmul kernel (port of ``repro.kernels.qpath``):
``ops`` dispatches, ``qpath`` binds ``csrc/qpath.cu``, ``ref`` is the plain
version."""
