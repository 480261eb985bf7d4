"""The yardstick's peaks and work counts, copied from the program's
``dist/roofline.py`` so that a change to the program cannot move them.

Peaks: one H100 SXM, NVIDIA's published dense rates at the full 700 W
(a card set below that limit runs slower under load: the device line of
every run gives the limit).  Work: what a selection of the k nearest rows
needs, counted from the shapes, the same whatever computes it: every
input byte read once, every output byte written once.
"""
from __future__ import annotations

F32_FLOPS = 67e12  # f32 on the CUDA cores; an FMA counts as two
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BW = 3.35e12  # bytes per second


def knn_work(m: int, n: int, d: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of the k nearest of n rows of width d for m queries
    in f32: 2*m*n*d flops (the cross term), the queries and rows read once
    (4 bytes an element) and the (distance, id) lists written once."""
    return 2.0 * m * n * d, 4.0 * (m * d + n * d) + 8.0 * m * k


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the f32 compute
    bound and the memory bound."""
    return max(flops / F32_FLOPS, nbytes / HBM_BW)
