"""Public semiring-matmul entry: the CUDA kernel for CUDA tensors, the
plain row-blocked version for CPU tensors (never a fallback for a CUDA
tensor).  Each call reports its work to an open ``dist/roofline``
capture."""
from __future__ import annotations

import torch

from repro_torch.dist import roofline
from repro_torch.kernels.qpath.qpath import qpath_matmul_cuda
from repro_torch.kernels.qpath.ref import qpath_matmul_ref


@roofline.reports(lambda a: roofline.qpath_work(a.A.shape[0], a.A.shape[1], a.B.shape[1]))
def qpath_matmul(
    A: torch.Tensor, B: torch.Tensor, *, mode: str = "minmax", row_block: int = 32
) -> torch.Tensor:
    """``row_block`` bounds the plain version's intermediate; the kernel
    tiles on its own."""
    if A.is_cuda:
        return qpath_matmul_cuda(A, B, mode=mode)
    return qpath_matmul_ref(A, B, mode=mode, row_block=row_block)
