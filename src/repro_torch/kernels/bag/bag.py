"""ctypes binding of ``csrc/bag.cu`` — the embedding bag on the card
(replaces ``repro/kernels/bag/bag.py:_bag_kernel``), its launch plan, and
its backward (``bag_backward``: the gradient with respect to an f32 table,
which has no TPU kernel: JAX gets it as XLA's scatter-add)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bag.ref import TABLE_DTYPES, check_args, check_backward_args

#: must match ``csrc/bag.cu``: the most threads a block takes, the chunk
#: lengths G the kernel is instanced for (gathers a thread keeps in flight
#: before it folds them), the dynamic shared memory a block may ask for
MAX_THREADS = 256
CHUNKS = (4, 8, 16, 40)
SMEM_BYTES = 48 * 1024
WARP = 32
#: the warp path's reach: at most WARP_OUTPUTS outputs (B x D), and a bag
#: of at most WARP_GATHERS gathers (S x D: two loads a lane, issued at
#: once).  At D = 1, S = 39 it read faster than the thread path up to 4096
#: bags and slower from 8192; at D = 10 (390 gathers a bag) slower at
#: every batch from 1 to 4096 bags (tools/profile_bag.py on an H100;
#: PERF.md section 6)
WARP_OUTPUTS = 4096
WARP_GATHERS = 2 * WARP

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_BACKWARD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


class BagPlan(NamedTuple):
    """How ``bag_f32`` launches: ``threads`` per block (whole warps) and the
    ``bags`` consecutive bags a block owns.  With ``warp``, one warp a bag
    (``bag_warp_kernel``: every gather of the bag in flight at once,
    ``chunk`` = S).  Else one thread an output (``bag_kernel``): the
    ``chunk`` of gathers a thread issues before it folds them and the ids
    of a bag staged at a time (``window``: S, or less with one bag a
    block).  ``smem_bytes``: the dynamic shared memory either takes."""
    threads: int
    bags: int
    chunk: int
    window: int
    smem_bytes: int
    warp: bool = False


def staged_words(n: int) -> int:
    """Shared words one staged span of n words takes (``bag.cu:staged_words``):
    up to 3 words of alignment offset, in whole 16-byte chunks."""
    return (n + 6) & ~3


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, S: int, D: int, sms: int, *, weighted: bool = False) -> BagPlan:
    """The launch of a (B, S) bag over a D-wide table on a card of ``sms``
    SMs: ``warp_plan`` for few outputs of small bags (``WARP_OUTPUTS``,
    ``WARP_GATHERS``), else ``thread_plan``."""
    if max(B, 1) * D <= WARP_OUTPUTS and S * D <= WARP_GATHERS:
        return warp_plan(B, S, D, sms)
    return thread_plan(B, S, D, sms, weighted=weighted)


def _warp_words(S: int, D: int) -> int:
    """Shared words of one bag on the warp path: its ids, weights and S x D
    gathered values."""
    return S * (D + 2)


def warp_plan(B: int, S: int, D: int, sms: int) -> BagPlan:
    """One warp a bag, as many warps a block as keep a block on every SM
    (up to ``MAX_THREADS``), within the shared-memory budget."""
    words = _warp_words(S, D)
    warps = max(1, min(MAX_THREADS // WARP, B // sms,
                       SMEM_BYTES // (4 * words) if words else MAX_THREADS))
    return BagPlan(WARP * warps, warps, S, max(S, 1), 4 * words * warps, True)


def thread_plan(B: int, S: int, D: int, sms: int, *, weighted: bool = False) -> BagPlan:
    """One thread an output.  Where the B x D outputs give every SM a full
    block, blocks of ``MAX_THREADS``; else blocks of as few whole warps as
    spread the outputs over the SMs.  The chunk is the shortest of
    ``CHUNKS`` that holds the window (all of a bag's gathers in flight at
    once where S <= 40).  A block owns as many bags as its threads cover,
    fewer where their ids (and weights) would pass ``SMEM_BYTES``; one bag
    whose ids pass it is staged a window at a time."""
    elems = max(B, 1) * D
    full = elems >= MAX_THREADS * sms
    threads = MAX_THREADS if full else max(WARP, _round_up(_cdiv(elems, sms), WARP))
    arrays = 2 if weighted else 1
    cap = SMEM_BYTES // (4 * arrays) - 6  # words of one staged array
    s1 = max(S, 1)
    bags = max(1, min(threads // D, cap // s1))
    window = s1 if bags * s1 <= cap else cap
    threads = min(threads, _round_up(bags * D, WARP))
    chunk = next((g for g in CHUNKS if g >= window), CHUNKS[-1])
    return BagPlan(threads, bags, chunk, window, 4 * staged_words(bags * window) * arrays)


#: the typed C entry and each device's SM count, looked up once (a serve
#: step calls the bag once; its host time is part of the step's)
_FN: dict = {}
_SMS: dict = {}


def _sms(device) -> int:
    key = device.index
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[key]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def embedding_bag_cuda(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
    plan: Optional[BagPlan] = None,
) -> torch.Tensor:
    """table (V, D) f32, bf16 or f16, ids (B, S), weights (B, S) or None,
    all CUDA -> (B, D) f32, by the CUDA kernel.  The table is read in its
    own dtype (no f32 copy); ids are taken as int32 (a copy when they are
    not).  ``plan`` forces a launch (default: ``launch_plan``)."""
    check_args(table, ids, weights, combine)
    if table.dtype not in TABLE_DTYPES:
        raise ValueError(f"embedding_bag_cuda takes an f32, bf16 or f16 table, "
                         f"got {table.dtype}")
    if not (table.is_cuda and ids.is_cuda and (weights is None or weights.is_cuda)):
        raise ValueError("embedding_bag_cuda takes CUDA tensors")
    # each conversion only where needed: a serve step pays its host time
    if not table.is_contiguous():
        table = table.contiguous()
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    if weights is not None and (weights.dtype != torch.float32
                                or not weights.is_contiguous()):
        weights = weights.float().contiguous()
    B, S = ids.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    if plan is None:
        plan = launch_plan(B, S, D, _sms(table.device), weighted=weights is not None)
    fn = _FN.get("bag_f32")
    if fn is None:
        fn = _FN["bag_f32"] = _build.function("bag_f32", _ARGTYPES)
    # the kernel's dtype code is the position in TABLE_DTYPES (bag.cu:TableDtype)
    err = fn(table.data_ptr(), TABLE_DTYPES.index(table.dtype), ids.data_ptr(),
             None if weights is None else weights.data_ptr(), out.data_ptr(),
             B, S, D, int(combine == "mean"), plan.threads, plan.bags, plan.chunk,
             plan.window, int(plan.warp), _build.stream_handle(table.device))
    _build.check(err, "bag_f32")
    _build.note_launch("bag")
    return out


def embedding_bag_backward_cuda(
    grad_out: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_rows: int,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """grad_out (B, D) f32, ids (B, S), weights (B, S) or None, all CUDA ->
    the dense (num_rows, D) f32 gradient of the bag with respect to its
    table, by the ``bag_backward`` kernel (f32 atomics: equal to
    ``embedding_bag_backward_ref`` to rounding, not bit for bit)."""
    check_backward_args(grad_out, ids, weights, combine)
    if grad_out.dtype != torch.float32:
        raise ValueError(f"embedding_bag_backward_cuda takes an f32 output gradient, "
                         f"got {grad_out.dtype}")
    if not (grad_out.is_cuda and ids.is_cuda and (weights is None or weights.is_cuda)):
        raise ValueError("embedding_bag_backward_cuda takes CUDA tensors")
    if not grad_out.is_contiguous():
        grad_out = grad_out.contiguous()
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    if weights is not None and (weights.dtype != torch.float32
                                or not weights.is_contiguous()):
        weights = weights.float().contiguous()
    B, S = ids.shape
    D = grad_out.shape[1]
    grad = torch.zeros((num_rows, D), dtype=torch.float32, device=grad_out.device)
    if B == 0 or S == 0 or D == 0:
        return grad
    fn = _FN.get("bag_backward")
    if fn is None:
        fn = _FN["bag_backward"] = _build.function("bag_backward", _BACKWARD_ARGTYPES)
    err = fn(grad_out.data_ptr(), ids.data_ptr(),
             None if weights is None else weights.data_ptr(), grad.data_ptr(),
             B, S, D, int(combine == "mean"), MAX_THREADS,
             _build.stream_handle(grad_out.device))
    _build.check(err, "bag_backward")
    _build.note_launch("bag_backward")
    return grad
