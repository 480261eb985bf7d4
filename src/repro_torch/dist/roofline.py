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
  g and the dense (V, D) table gradient written once;
* rescore (the exact top-k of gathered candidate lists): two f32
  instructions per (alive candidate, column); bytes the distinct alive
  rows read once, the queries, the ids and the (B, k) lists written.

A kernel's plain version (the CPU path) runs with the torch dispatch
modes suspended, so ``core/profile``'s counters of the torch work outside
the kernels never count it twice.  The peaks are the H100 SXM's published
dense rates; one device, so the collective term of a kernel is 0.

The dry-run (``launch/dryrun``), JAX's roofline of whole steps: JAX reads
flops, bytes and collectives from the optimized HLO; the port counts them
while a step runs once on meta tensors.  ``OpCounter`` counts every torch
op's flops, the bytes it reads and writes and the peak of live bytes;
``collecting()`` gathers the bytes of the collectives ``dist/sharding``
runs into a ``CollectiveStats``; ``roofline_terms`` is JAX's three-term
roofline with the H100's peaks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import types
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 and int8 on
# the tensor cores, HBM bandwidth
F32_FLOPS = 67e12  # an FMA counts as two flops
F32_INSTR = F32_FLOPS / 2  # f32 lane instructions per second
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BW = 3.35e12
#: operation kind -> peak rate (per second)
RATES = {"f32": F32_FLOPS, "f32_instr": F32_INSTR, "bf16": BF16_FLOPS, "int8": INT8_OPS}
# NVLink 4 on the H100 SXM5 (NVIDIA's H100 datasheet: 900 GB/s a GPU, both
# directions together), taken one direction, for the collective term.
# Nominal: no mesh across several cards has measured it.
NVLINK_BW = 450e9


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


def rescore_work(cand, d: int, k: int) -> tuple:
    """The exact top-k of (B, C) gathered candidate lists over rows of d
    floats: every alive candidate (id >= 0) scored; bytes the distinct
    alive rows read once (a row several lists share counts once, as the
    bag's sectors do), the queries, the ids and the (B, k) lists; this
    reads the ids back, so it runs only under a capture."""
    B = cand.shape[0]
    alive = cand[cand >= 0]
    rows = int(torch.unique(alive).numel())
    return (2 * alive.numel() * d, "f32_instr",
            4 * rows * d + 4 * B * d + cand.numel() * cand.element_size() + 8 * B * k)


# ---------------------------------------------------------------------------
# whole steps: collectives, op counts, the three-term roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    """The bytes of the collectives of a run, per kind, in the convention
    of JAX's ``parse_collectives`` (``repro/dist/roofline.py``): each
    collective the program issues counts once, with the bytes of the
    result one device holds (all-reduce: its operand's size; all-gather:
    the gathered tensor; reduce-scatter: its slice), under the HLO's
    names.  ``dist/sharding`` records every ``psum`` (all-reduce) and
    ``all_gather`` (all-gather) it completes, and, where the result takes
    part in autograd, its transpose as the backward would issue it (psum:
    an all-reduce of the same size; all_gather: a reduce-scatter down to
    the operand).  The port's loops are Python loops, already unrolled, so
    ``loop_trip_counts`` stays empty."""

    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    total_bytes: float = 0.0
    count: int = 0
    loop_trip_counts: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + int(nbytes)
        self.total_bytes += float(nbytes)
        self.count += 1

    def record(self, kind: str, operand, result) -> None:
        """One completed collective (``psum`` or ``all_gather``)."""
        if kind == "psum":
            self.add("all-reduce", result.nbytes)
            if result.requires_grad:
                self.add("all-reduce", result.nbytes)
        else:
            self.add("all-gather", result.nbytes)
            if result.requires_grad:
                self.add("reduce-scatter", operand.nbytes)


_COLLECTING: list = []  # the open ``collecting()`` blocks' stats
_ACTIVE: list = []  # the open OpCounters (once more while one decomposes)
#: the weight of the ops counted now (``weighted``): one rank's ops stand
#: for every rank's under ``dist/sharding``'s run of a meta mesh
_WEIGHT = [1]


def charge(nbytes: float, ops: int) -> None:
    """Count work no op of this run does, for every open ``OpCounter``:
    what a weighted rank stands for beyond its own ops."""
    for counter in dict.fromkeys(_ACTIVE):
        counter.bytes += nbytes
        counter.ops += ops


def push_weight(w: int) -> None:
    _WEIGHT.append(w)


def pop_weight() -> None:
    _WEIGHT.pop()


@contextlib.contextmanager
def weighted(w: int):
    """Count every op run in the block ``w`` times (``OpCounter``)."""
    push_weight(w)
    try:
        yield
    finally:
        pop_weight()


def current_collectives() -> Optional[CollectiveStats]:
    """The stats of the innermost ``collecting()`` block, if one is open."""
    return _COLLECTING[-1] if _COLLECTING else None


@contextlib.contextmanager
def collecting():
    """Gather the bytes of every collective ``shard_map`` completes while
    the block runs; yields the ``CollectiveStats``."""
    stats = CollectiveStats()
    _COLLECTING.append(stats)
    try:
        yield stats
    finally:
        _COLLECTING.remove(stats)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """A torch dispatch mode that counts, over the ops run while it is
    active (``with OpCounter() as c``), on any device, meta tensors
    included, and in every ``shard_map`` rank (``dist/sharding`` enters
    the caller's modes in each):

    * ``flops`` — ``torch.utils.flop_counter``'s formulas (the matmul,
      convolution and attention families; ``dot_ops`` counts those ops);
    * ``bytes`` — every tensor an op reads and writes, each once per op;
      a view moves nothing and counts 0;
    * ``peak_bytes`` — the peak of the bytes the ops allocated that are
      still referenced (by the caller or by autograd's saved tensors),
      tracked by weak references to the outputs' storages; memory that
      existed before the block is not in it.

    Each op counts ``weighted``'s weight times (1 outside it).
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.dot_ops = 0
        self.live = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._kinds: dict = {}  # op -> (is a view, which outputs are new)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _decompose(self, func, args, kwargs):
        """A composite op (einsum, reshape, ``to``: they reach the mode
        whole under inference mode) as the ops it is made of, counted."""
        with self:
            return func.decompose(*args, **kwargs)

    def _free(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = flop_registry.get(func.overloadpacket)
        if count is None:
            out = self._decompose(func, args, kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = (
                func.is_view, [r.alias_info is None for r in func._schema.returns])
        is_view, new = kind
        w = _WEIGHT[-1]
        self.ops += w
        if is_view:
            return out
        moved = sum(t.nbytes for t in _tensors((args, kwargs)))
        for t, alloc in zip(out if isinstance(out, (tuple, list)) else (out,), new):
            if not isinstance(t, torch.Tensor):
                continue
            moved += t.nbytes
            if alloc:
                storage = t.untyped_storage()
                n = storage.nbytes() * w
                with self._lock:
                    self.live += n
                    self.peak_bytes = max(self.peak_bytes, self.live)
                weakref.finalize(storage, self._free, n)
        self.bytes += moved * w
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out) * w
            self.dot_ops += w
        return out


def roofline_terms(cost: dict, coll: CollectiveStats, *, chips: int,
                   model_flops: Optional[float] = None, kind: str = "bf16") -> dict:
    """JAX's three-term roofline (``repro/dist/roofline.roofline_terms``):
    compute, HBM and collective time per chip, the dominant term and its
    share of their sum, and ``useful_flops_ratio`` = model_flops / (flops
    x chips).  ``cost`` holds per-chip ``flops`` and ``bytes accessed``;
    the rates are the H100's: ``RATES[kind]`` (JAX: one bf16 peak),
    ``HBM_BW`` and ``NVLINK_BW``."""
    flops = float(cost.get("flops", 0.0))
    mem_bytes = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / RATES[kind]
    t_memory = mem_bytes / HBM_BW
    t_collective = coll.total_bytes / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    dominant = max(terms, key=terms.get)
    total = max(t_compute + t_memory + t_collective, 1e-30)
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "roofline_fraction": terms[dominant] / total,
    }
    if model_flops:
        out["useful_flops_ratio"] = float(model_flops) / max(flops * chips, 1e-30)
    return out
