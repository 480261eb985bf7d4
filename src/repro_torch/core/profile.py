"""Roofline profiles of the port's search programs — port of
``repro.core.profile``.

The JAX package lowers each jitted program to optimized HLO and counts its
flops and bytes there.  The port has no HLO, so a capture runs the program
once with every piece of its work counted:

* each kernel call reports its operations and bytes analytically
  (``dist/roofline``: the formulas of ``chip_smoke.py``'s bounds), with
  its own rate — f32 flops, f32 instructions or int8 operations;
* the torch products outside the kernels (Phi's layers, the IVF probes'
  gathers, the rerank's pair distances, the merges) are counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (at the f32 rate) and by a
  dispatch mode that adds up the bytes of every tensor an op writes (a
  view writes none) — the counterpart of JAX's instruction-output bytes.

Predicted time is the larger of compute (the sum of each count over its
peak) and memory (bytes over the H100's HBM rate); one device, so the
collective term is 0.  Measured time is the median of timed calls after a
warm-up (CUDA events on the card, the wall clock on the CPU).
``pct_of_peak`` = predicted / measured; above 1.05 a count is wrong, and
the capture raises instead of reporting it.

Captured profiles land in a process-wide registry (``profiles()``), as
telemetry gauges (``roofline_*{program=...}``) when telemetry is on, and
as a JSON block through ``as_row()`` — JAX's fields and keys.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import telemetry as telem
from repro_torch.dist import roofline

#: a profile whose predicted time exceeds the measured by more than this
#: factor counted more work than the program did
PCT_LIMIT = 1.05
#: aten ops counted as dots (JAX's ``dot_count`` counts HLO dots)
_DOTS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "_int_mm", "linear")


@dataclasses.dataclass
class ProgramProfile:
    """One program's roofline accounting."""

    name: str
    labels: dict
    flops: float            # kernel operations + torch products' flops
    hbm_bytes: float        # kernel bytes + bytes the torch ops wrote
    intensity: float        # flops / byte
    dot_count: int          # kernel launches + torch matmul calls
    t_compute_s: float      # each count over its peak, summed
    t_memory_s: float       # bytes / HBM_BW
    t_collective_s: float   # 0: one device
    t_predicted_s: float    # max of the three terms
    dominant: str           # which term bounds the program
    t_measured_s: Optional[float] = None
    pct_of_peak: Optional[float] = None  # predicted / measured

    def as_row(self) -> dict:
        """The JSON block bench rows carry."""
        out = {
            "program": self.name,
            "flops": float(self.flops),
            "hbm_bytes": float(self.hbm_bytes),
            "intensity": round(float(self.intensity), 4),
            "dot_count": int(self.dot_count),
            "t_predicted_s": float(self.t_predicted_s),
            "dominant": self.dominant,
        }
        if self.t_measured_s is not None:
            out["t_measured_s"] = float(self.t_measured_s)
            out["pct_of_peak"] = float(self.pct_of_peak)
        return out


#: process-wide capture registry: (name, sorted label items) -> profile
_PROGRAMS: dict = {}


def _key(name: str, labels: Optional[dict]):
    return (name, tuple(sorted((labels or {}).items())))


def reset() -> None:
    _PROGRAMS.clear()


def profiles(name: Optional[str] = None) -> list[ProgramProfile]:
    """Captured profiles, optionally filtered by program name."""
    return [p for p in _PROGRAMS.values() if name is None or p.name == name]


def export_gauges(prof: ProgramProfile) -> None:
    """Publish one profile as telemetry gauges (no-op when telemetry is
    off)."""
    if not telem.enabled():
        return
    labels = {"program": prof.name, **prof.labels}
    telem.set_gauge("roofline_flops", prof.flops, **labels)
    telem.set_gauge("roofline_hbm_bytes", prof.hbm_bytes, **labels)
    telem.set_gauge("roofline_intensity", prof.intensity, **labels)
    telem.set_gauge("roofline_predicted_s", prof.t_predicted_s, **labels)
    if prof.t_measured_s is not None:
        telem.set_gauge("roofline_measured_s", prof.t_measured_s, **labels)
        telem.set_gauge("roofline_pct_of_peak", prof.pct_of_peak, **labels)


class _WrittenBytes(TorchDispatchMode):
    """Bytes of every tensor an aten op writes (views write none) and the
    number of matmul-type calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t._is_view():
                self.bytes += t.numel() * t.element_size()
        if func.overloadpacket.__name__ in _DOTS:
            self.dots += 1
        return out


def _device_of(args) -> torch.device:
    for a in tree_leaves(args):
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _measure(fn, args, kwargs, device: torch.device, iters: int = 5) -> float:
    """Median seconds of ``iters`` calls after one warm-up: CUDA events on
    the card, the wall clock on the CPU."""
    fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def _count(fn, *args, **kwargs):
    """Run ``fn`` once with every piece of its work counted; returns
    (kernel ``Work``, torch flops, torch bytes written, torch dots)."""
    with roofline.counting() as work, FlopCounterMode(display=False) as flops, \
            _WrittenBytes() as written:
        fn(*args, **kwargs)
    return work, float(flops.get_total_flops()), float(written.bytes), written.dots


def capture_jit(name: str, fn, *args, labels: Optional[dict] = None,
                measure: bool = True, measured_s: Optional[float] = None,
                force: bool = False, export: bool = True,
                **kwargs) -> ProgramProfile:
    """Profile one call of ``fn(*args, **kwargs)``.

    A warm-up call runs first (lazy state — the beam's flattened tree, a
    store's device view — is built outside the count), then one counted
    call with telemetry suspended, then (by default) the timed calls.
    Re-captures of the same (name, labels) return the cached profile
    unless ``force`` or a fresh ``measured_s`` is supplied.  Raises when
    ``pct_of_peak`` exceeds ``PCT_LIMIT``."""
    key = _key(name, labels)
    cached = _PROGRAMS.get(key)
    if cached is not None and not force and measured_s is None:
        return cached
    device = _device_of((args, kwargs))
    was_on = telem.enabled()
    telem.disable()  # the counted call must not sync counters to the host
    try:
        fn(*args, **kwargs)
        work, t_flops, t_bytes, t_dots = _count(fn, *args, **kwargs)
        if measured_s is None and measure:
            measured_s = _measure(fn, args, kwargs, device)
    finally:
        if was_on:
            telem.enable()
    flops = work.ops + t_flops
    nbytes = work.hbm_bytes + t_bytes
    terms = {"compute": work.t_compute_s + t_flops / roofline.F32_FLOPS,
             "memory": nbytes / roofline.HBM_BW, "collective": 0.0}
    dominant = max(terms, key=terms.get)
    t_pred = terms[dominant]
    pct = (t_pred / measured_s) if measured_s else None
    if pct is not None and pct > PCT_LIMIT:
        raise RuntimeError(
            f"{name}: predicted {t_pred:.3e} s is {pct:.3f}x the measured "
            f"{measured_s:.3e} s — a work count is wrong")
    prof = ProgramProfile(
        name=name, labels=dict(labels or {}), flops=flops, hbm_bytes=nbytes,
        intensity=flops / max(nbytes, 1.0), dot_count=work.launches + t_dots,
        t_compute_s=terms["compute"], t_memory_s=terms["memory"],
        t_collective_s=0.0, t_predicted_s=t_pred, dominant=dominant,
        t_measured_s=measured_s, pct_of_peak=pct,
    )
    _PROGRAMS[key] = prof
    if export:
        export_gauges(prof)
    return prof


def capture_search(index, Q, *, k: int = 10, budget: Optional[int] = None,
                   filter=None, engine: Optional[str] = None,
                   labels: Optional[dict] = None, measure: bool = True,
                   force: bool = False, **search_kw) -> ProgramProfile:
    """Profile a registry engine's whole batched search: one
    ``index.search`` call at this batch — for a sharded index every shard's
    search and the merge, for infinity the beam and the rerank, for
    quantized engines the int8 scan — is the program."""
    eng = engine or getattr(index, "registry_name", type(index).__name__)
    if not isinstance(Q, torch.Tensor):
        from repro_torch.core import index as index_lib

        Q = torch.as_tensor(Q, dtype=torch.float32,
                            device=index_lib.corpus_of(index).device)
    lbl = {"engine": eng, "batch": int(Q.shape[0]), "k": int(k), **(labels or {})}

    def run(Qb):
        return index.search(Qb, k=k, budget=budget, filter=filter, **search_kw)

    return capture_jit(f"search:{eng}", run, Q, labels=lbl, measure=measure,
                       force=force)
