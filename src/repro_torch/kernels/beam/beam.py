"""ctypes binding of ``csrc/beam.cu`` — every level of the beam over a
flattened VP tree in one launch, a block per query (replaces the written-out
tensor ops of ``core/vptree.beam_levels``; no TPU kernel stands behind it)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])

#: what the kernel takes (``csrc/beam.cu``); no size is bounded: a query's
#: state lives in shared memory where it fits and in global scratch where not
LIMITS = ("the beam kernel takes beam_width, k and bucket_cap >= 1, q >= 1 or q = inf, "
          "and in vector mode euclidean rows")


def _refuse(what: str):
    raise ValueError(f"beam kernel: {what}")


def _check(t: torch.Tensor, name: str, dtypes, device, dim: int) -> None:
    if t.device != device:
        _refuse(f"{name} is on {t.device}, the queries on {device}")
    if t.dtype not in dtypes:
        _refuse(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != dim:
        _refuse(f"{name} must have {dim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        _refuse(f"{name} must be contiguous")


def beam_cuda(
    flat,
    queries: torch.Tensor,
    *,
    q: float,
    k: int,
    beam_width: int,
    bucket_cap: int,
    X: Optional[torch.Tensor] = None,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
):
    """``core/vptree.beam_levels`` on CUDA tensors, by the kernel: one
    counted launch on the current stream, no host sync.  Raises, before any
    launch, on a tensor off the queries' device, of another dtype or not
    contiguous, and outside what the kernel takes (``LIMITS``)."""
    W, K, Bcap = int(beam_width), int(k), int(bucket_cap)
    if not (W >= 1 and K >= 1 and Bcap >= 1):
        _refuse(f"{LIMITS}; got beam_width {W}, k {K}, bucket_cap {Bcap}")
    if not q >= 1.0:
        _refuse(f"{LIMITS}; got q {q}")
    dev = queries.device
    f32, i32 = (torch.float32,), (torch.int32,)
    _check(queries, "queries", f32, dev, 2)
    for name in ("mu", "rad_in", "rad_out"):
        _check(getattr(flat, name), name, f32, dev, 1)
    for name in ("child_in", "child_out", "perm"):
        _check(getattr(flat, name), name, i32, dev, 1)
    nodes = flat.mu.shape[0]
    if any(getattr(flat, name).shape[0] != nodes
           for name in ("child_in", "child_out", "rad_in", "rad_out")):
        _refuse("the tree's node arrays differ in length")
    B, width = queries.shape
    if X is None:
        if width != flat.perm.shape[0]:
            _refuse(f"rows mode takes (B, n) rows, n = {flat.perm.shape[0]}; "
                    f"got {tuple(queries.shape)}")
        centroids = None
    else:
        if metric != "euclidean":
            _refuse(f"{LIMITS}; got metric {metric!r}")
        _check(X, "X", f32, dev, 2)
        centroids = flat.centroids
        if centroids is None:
            _refuse("vector mode needs the tree's centroids")
        _check(centroids, "centroids", f32, dev, 2)
        if X.shape[1] != width or centroids.shape[1] != width:
            _refuse(f"dimension mismatch: queries {tuple(queries.shape)}, X {tuple(X.shape)}, "
                    f"centroids {tuple(centroids.shape)}")
    if valid is not None:
        _check(valid, "valid", (torch.bool, torch.uint8), dev, 1)
    if not queries.is_cuda:
        _refuse("takes CUDA tensors")
    best_d = torch.empty((B, K), dtype=torch.float32, device=dev)
    best_i, buf, c_trav, c_cent = (torch.empty(shape, dtype=torch.int64, device=dev)
                                   for shape in ((B, K), (B, Bcap), (B,), (B,)))
    if B == 0:
        return best_d, best_i, buf, c_trav, c_cent
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("beam_levels", _ARGTYPES)
    err = fn(queries.data_ptr(), ptr(X), ptr(centroids), flat.mu.data_ptr(),
             flat.child_in.data_ptr(), flat.child_out.data_ptr(), flat.rad_in.data_ptr(),
             flat.rad_out.data_ptr(), flat.perm.data_ptr(), ptr(valid), best_d.data_ptr(),
             best_i.data_ptr(), buf.data_ptr(), c_trav.data_ptr(), c_cent.data_ptr(),
             B, width, W, K, Bcap, int(flat.depth), ctypes.c_float(q),
             _build.stream_handle(dev))
    _build.check(err, "beam_levels")
    _build.note_launch("beam/levels")
    return best_d, best_i, buf, c_trav, c_cent
