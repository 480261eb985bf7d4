"""ctypes binding of ``csrc/rescore.cu`` — the exact top-k of gathered
candidate lists in one launch, a block a query: each alive row read once,
scored in the metric's pair form, the stable top-k kept on the chip
(replaces the (B, C, d) gather, pair-form and sort passes of
``core/scan.topk_candidates``'s plain version; no TPU kernel stands behind
it)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dist import roofline
from repro_torch.kernels import _build
from repro_torch.kernels.pdist.pdist import CUBE_METRICS, MATMUL_METRICS, METRIC_CODES

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: the metrics the kernel scores (``kernels/topk.SUPPORTED``'s)
SUPPORTED = MATMUL_METRICS + CUBE_METRICS
#: must match ``csrc/rescore.cu``: candidates whose distances sit in shared
#: memory (past it a (B, 2C) scratch), survivors sorted in shared memory
#: (past it a (B, min(k, C)) scratch), and the widest query row
DIST_SMEM = 8192
SORT_WORDS = 4096
MAX_DIM = 16384


def _refuse(what: str):
    raise ValueError(f"rescore kernel: {what}")


def _check(t: torch.Tensor, name: str, dtypes, device) -> None:
    if t.device != device:
        _refuse(f"{name} is on {t.device}, the queries on {device}")
    if t.dtype not in dtypes:
        _refuse(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != 2:
        _refuse(f"{name} must have 2 dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        _refuse(f"{name} must be contiguous")


@roofline.reports(lambda a: roofline.rescore_work(a.cand, a.X.shape[1], a.k))
def rescore_cuda(
    Q: torch.Tensor,
    cand: torch.Tensor,
    X: torch.Tensor,
    *,
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``core/scan.topk_candidates`` on CUDA tensors, by the kernel: Q (B,
    d) f32, cand (B, C) int32 or int64 ids into X (n, d) f32, -1 (or any id
    outside [0, n)) for none -> (idx (B, k) int32, -1 where the distance is
    +inf; dists (B, k) f32 ascending, ties to the earlier position).  Any
    k >= 1; past C the lists are padded with (+inf, -1).  One counted launch
    on the current stream, no host sync.  Raises, before any launch, on a
    metric it does not score, a tensor off the queries' device, of another
    dtype or not contiguous, mismatched shapes, and CPU tensors."""
    if metric not in SUPPORTED:
        _refuse(f"takes {', '.join(SUPPORTED)}; got metric {metric!r}")
    k = int(k)
    if k < 1:
        _refuse(f"takes k >= 1, got {k}")
    dev = Q.device
    _check(Q, "Q", (torch.float32,), dev)
    _check(cand, "cand", (torch.int32, torch.int64), dev)
    _check(X, "X", (torch.float32,), dev)
    (B, d), C, n = Q.shape, cand.shape[1], X.shape[0]
    if cand.shape[0] != B or X.shape[1] != d:
        _refuse(f"shape mismatch: Q {tuple(Q.shape)}, cand {tuple(cand.shape)}, "
                f"X {tuple(X.shape)}")
    if not 1 <= d <= MAX_DIM:
        _refuse(f"takes 1 <= d <= {MAX_DIM}, got {d}")
    if not Q.is_cuda:
        _refuse("takes CUDA tensors")
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_i, out_d
    want = min(k, C)
    # past DIST_SMEM, each list's distances and visiting order
    dist = torch.empty(B * 2 * C, dtype=torch.float32, device=dev) if C > DIST_SMEM else None
    words = torch.empty(B * want, dtype=torch.int64, device=dev) if want > SORT_WORDS else None
    aligned = d % 4 == 0 and X.data_ptr() % 16 == 0
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("rescore", _ARGTYPES)
    err = fn(Q.data_ptr(), cand.data_ptr(), X.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
             ptr(dist), ptr(words), B, C, n, d, k, METRIC_CODES[metric],
             int(cand.dtype == torch.int64), int(aligned), _build.stream_handle(dev))
    _build.check(err, "rescore")
    _build.note_launch("rescore")
    return out_i, out_d
