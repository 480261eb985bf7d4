"""Roofline accounting for the port: the work of each kernel launch,
counted analytically, against an H100's peaks.

The JAX package derives flops and bytes from optimized XLA HLO
(``repro.dist.roofline``); the port has no HLO.  Instead each kernel entry
(``kernels/*/ops.py``) reports, per call, the operations it does and the
bytes it must move to the capture open on its thread (``counting``), with
the formulas below, which ``chip_smoke.py``'s bounds are built from too:

* topk, f32 matmul family: 2·m·n·d flops at the f32 rate; bytes 4·(m·d +
  n·d) + 8·m·k (+ n mask bytes);
* topk, cube family (manhattan / chebyshev) and pdist's cube family: two
  f32 instructions per (i, j, l) at the f32 instruction rate;
* topk, int8: 2·m·n·d int8 operations; bytes m·d + n·d + 4·(2m + n) +
  8·m·k (+ n);
* the merge of a scan's split lists (``chip_smoke.py``'s merge rows): one
  f32 instruction per (row, output, list); bytes the entries it reads and
  its output;
* pdist, matmul family: 2·m·n·d flops; bytes 4·(m·d + n·d + m·n);
* qpath: two f32 instructions per (i, j, l) in every mode; bytes 4·(m·k
  + k·n + m·n);
* bag: two f32 instructions per (bag, id, column); bytes the distinct
  32-byte table sectors its ids name, the ids (and weights) and the
  output;
* the bag's backward: two f32 instructions per (bag, id, column) (the
  product and its add); bytes the ids (and weights), the output gradient
  g and the dense (V, D) table gradient written once.

A kernel's plain version (the CPU path) runs with the torch dispatch
modes suspended, so ``core/profile``'s counters of the torch work outside
the kernels never count it twice.  The peaks are the H100 SXM's published
dense rates; one device, so the collective term is 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import types
from typing import Optional

# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 and int8 on
# the tensor cores, HBM bandwidth
F32_FLOPS = 67e12  # an FMA counts as two flops
F32_INSTR = F32_FLOPS / 2  # f32 lane instructions per second
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BW = 3.35e12
#: operation kind -> peak rate (per second)
RATES = {"f32": F32_FLOPS, "f32_instr": F32_INSTR, "bf16": BF16_FLOPS, "int8": INT8_OPS}


@dataclasses.dataclass
class Work:
    """What the kernels of one captured run reported."""

    ops: float = 0.0  # operations of every kind
    t_compute_s: float = 0.0  # sum of ops / the rate of their kind
    hbm_bytes: float = 0.0
    launches: int = 0

    def add(self, ops: float, kind: str, nbytes: float) -> None:
        self.ops += ops
        self.t_compute_s += ops / RATES[kind]
        self.hbm_bytes += nbytes
        self.launches += 1


class _Local(threading.local):
    # a class default: reading a missing attribute of a plain
    # threading.local raises inside getattr, ~0.8 us a kernel call
    work: Optional[Work] = None


_LOCAL = _Local()


@contextlib.contextmanager
def counting():
    """Collect the work every kernel call on this thread reports while the
    block runs; yields the ``Work``."""
    prev = _LOCAL.work
    _LOCAL.work = work = Work()
    try:
        yield work
    finally:
        _LOCAL.work = prev


def reports(work_of):
    """Decorate a kernel entry.  Under a capture open on this thread the
    entry reports ``work_of(a)`` — the call's (ops, kind, bytes), ``a`` its
    arguments by name with the defaults applied — to the capture and runs
    with the torch dispatch modes suspended; outside a capture the call
    goes straight through after one thread-local read."""

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            work = _LOCAL.work
            if work is None:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes

            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            work.add(*work_of(types.SimpleNamespace(**bound.arguments)))
            with _disable_current_modes():
                return fn(*args, **kwargs)

        return entry

    return wrap


# ---------------------------------------------------------------------------
# per-kernel work
# ---------------------------------------------------------------------------

def topk_work(m: int, n: int, d: int, k: int, *, cube: bool, masked: bool,
              live: Optional[int] = None) -> tuple:
    """``live``: the rows the mask passes, where the caller counts the work
    this mask's data needs (every row scanned when None); a mask costs its
    n bytes either way."""
    r = n if live is None else live
    return (2 * m * r * d, "f32_instr" if cube else "f32",
            4 * (m * d + r * d) + 8 * m * k + (n if masked else 0))


def topk_int8_work(m: int, n: int, d: int, k: int, *, masked: bool,
                   live: Optional[int] = None) -> tuple:
    r = n if live is None else live
    return (2 * m * r * d, "int8",
            m * d + r * d + 4 * (2 * m + r) + 8 * m * k + (n if masked else 0))


def merge_work(m: int, k: int, splits: int, reads: int) -> tuple:
    """The merge of ``splits`` sorted lists a row into its k best: one
    comparison per (row, output, list), the ``reads`` (distance, id) entries
    the merge takes in and the (m, k) output."""
    return m * k * splits, "f32_instr", 8 * reads + 8 * m * k


def pdist_work(m: int, n: int, d: int, *, cube: bool) -> tuple:
    return 2 * m * n * d, "f32_instr" if cube else "f32", 4 * (m * d + n * d + m * n)


def qpath_work(m: int, kd: int, n: int) -> tuple:
    return 2 * m * kd * n, "f32_instr", 4 * (m * kd + kd * n + m * n)


def bag_work(ids, D: int, *, weighted: bool, elem: int, reuse: bool = True) -> tuple:
    """The distinct 32-byte sectors of the table rows ``ids`` names (a row
    several lookups share is read once; with ``reuse=False`` every lookup's
    sectors), the ids (and weights) and the (B, D) output; this reads the
    ids back, so it runs only under a capture."""
    import torch

    B, S = ids.shape
    row = elem * D
    start = ids.clamp_min(0).long().reshape(-1) * row
    first, last = start // 32, (start + row - 1) // 32
    span = int((last - first).max()) + 1 if start.numel() else 0
    sectors = torch.cat([(first + j)[first + j <= last] for j in range(span)]) \
        if span else start
    read = int(torch.unique(sectors).numel()) if reuse else int(sectors.numel())
    return (2 * B * S * D, "f32_instr",
            32 * read + 4 * B * S * (2 if weighted else 1) + 4 * B * D)


def bag_backward_work(ids, D: int, num_rows: int, *, weighted: bool) -> tuple:
    """The bag's backward over (B, S) ``ids`` into a (``num_rows``, D)
    gradient: each input read once (ids, weights, g) and the dense output
    written once."""
    B, S = ids.shape
    return (2 * B * S * D, "f32_instr",
            4 * B * S * (2 if weighted else 1) + 4 * B * D + 4 * num_rows * D)
