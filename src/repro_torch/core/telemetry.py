"""Search telemetry subsystem: counters, histograms, spans, trace export.

It keeps ``repro.core.telemetry``'s registry, names and exposition (the
CPU tests hold ``metrics_text()`` and ``summary()`` to the JAX package's),
in its own process-wide registry, so the two packages never share
counters.  One thing is the port's own: a span is also a range on
``torch.profiler``'s clock.

The registry answers the question the flat ``stats()`` dict cannot:
*which stage* of a query spent the comparisons and the milliseconds.  In
metric-space search the budget currency is distance evaluations (the
paper's App. F.1 accounting), so the registry is built around labeled
counters — ``comparisons_total{engine=...,stage=...,q=...}`` — next to
log-spaced latency histograms and a bounded in-memory trace ring.

Three primitives:

* ``Counter`` / ``Gauge`` / ``Histogram`` — labeled metrics held in the
  module ``REGISTRY``.  Histograms use fixed log-spaced latency buckets
  (``LATENCY_BUCKETS_S``) so two runs' distributions are always mergeable.
  Use through the convenience entry points ``count`` / ``set_gauge`` /
  ``observe``, which are no-ops (one branch) while telemetry is disabled.
* ``span(name, **labels)`` — a context manager around a stage.  While
  telemetry is on it records the stage's wall time into the
  ``stage_seconds`` histogram (labeled ``stage=name``) and appends a Chrome
  ``trace_event`` to the trace ring.  While ``torch.profiler`` collects,
  on or off, it opens a profiler range ``repro_torch.<name>``, which the
  profiler records as a ``user_annotation`` on the clock of its ATen ops,
  CUDA runtime calls and kernels.  The span closes — histogram observed,
  trace event emitted (``error=True`` when its body raised), range ended —
  even when the body raises.  ``span(name, sync=dev)`` puts the device
  work of its body inside the time: while telemetry is on and the body
  raised nothing, the span synchronises ``dev`` before it reads the
  clock.  Telemetry off, or only the profiler collecting, nothing is
  synchronised, so the profiler sees the program's unsynchronised flow.
* the trace ring — a fixed-capacity ring of ``trace_event`` dicts,
  exported by ``dump_trace(path)`` as Chrome/Perfetto-loadable JSON.
  Overflow overwrites the oldest events (``dropped`` is reported), so
  sustained traffic holds memory flat.

Global switch: ``enable()`` / ``disable()`` (or env ``REPRO_TELEMETRY=1``).
Disabled, ``count`` / ``set_gauge`` / ``observe`` return after a single
flag branch, and ``span`` after that flag and the profiler's own flag —
no locks, no allocation — and instrumented code paths are
behavior-identical (bit-exact search ids) to an uninstrumented build:
recording only observes values the search already computed.

Exposition: ``metrics_text()`` renders the registry in Prometheus text
exposition format (``search_latency_bucket{le=...}``,
``comparisons_total{stage=...}``, ...); ``snapshot()`` returns the same
data as a nested dict (what ``SearchServer.stats()['telemetry']`` and the
``BENCH_*.json`` stamps embed).

Naming note: this module is ``repro_torch.core.telemetry`` and nothing
else — ``repro_torch.core.metrics`` is the *dissimilarity* registry
(euclidean, cosine, ...), an unrelated namespace.

``scan_dispatch_total{regime=...}`` counts CALLS of ``core/scan``'s scans
(the JAX package counts traces of its jitted scans), with regimes ``cuda``
/ ``torch`` (the f32 kernel or its plain version, by the tensors' device)
and ``cuda_quant`` / ``torch_quant`` (the int8 scan);
``topk_wide_select_total{family=matmul|cube}`` counts those f32 kernel
calls at k > 512 that select from the scan's written-out distances.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.device import sync

__all__ = [
    "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram", "Registry",
    "REGISTRY", "enabled", "enable", "disable", "reset",
    "count", "set_gauge", "observe", "span",
    "counter_series", "histogram_series", "counter_total",
    "snapshot", "summary", "metrics_text", "dump_trace",
    "trace_events", "set_trace_cap", "q_label",
]

#: fixed log-spaced latency buckets (seconds): 100us .. 10s in a
#: 1-2.5-5 decade ladder, +Inf implied.  Fixed — never derived from data —
#: so histograms from any two runs/processes merge bucket-by-bucket.
LATENCY_BUCKETS_S = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)

_ENABLED = os.environ.get("REPRO_TELEMETRY", "") not in ("", "0", "false")
_LOCK = threading.RLock()
_T0 = time.perf_counter()  # trace timestamps are microseconds since import


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Flip the global switch.  Enabling mid-run is safe: metrics simply
    start accumulating from here; nothing retroactive is synthesized."""
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def _label_key(labels: dict) -> tuple:
    """Canonical hashable identity of a label set (values stringified)."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic labeled counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._vals: dict[tuple, float] = {}

    def inc(self, value: float = 1, **labels) -> None:
        if not _ENABLED:
            return
        key = _label_key(labels)
        with _LOCK:
            self._vals[key] = self._vals.get(key, 0) + value

    def series(self) -> list[tuple[dict, float]]:
        with _LOCK:
            return [(dict(k), v) for k, v in sorted(self._vals.items())]

    def total(self, **match) -> float:
        """Sum over every label set containing all of ``match``."""
        m = {k: str(v) for k, v in match.items()}
        with _LOCK:
            return sum(
                v for k, v in self._vals.items()
                if all(dict(k).get(mk) == mv for mk, mv in m.items())
            )

    def _reset(self) -> None:
        self._vals.clear()


class Gauge(Counter):
    """Labeled last-value gauge (same storage, set instead of add)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        with _LOCK:
            self._vals[_label_key(labels)] = value


class Histogram:
    """Labeled histogram over fixed bucket upper bounds (+Inf implied)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = LATENCY_BUCKETS_S):
        self.name, self.help = name, help
        self.buckets = tuple(buckets)
        # per label set: [bucket counts ... , +Inf count], sum, count
        self._vals: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        key = _label_key(labels)
        with _LOCK:
            rec = self._vals.get(key)
            if rec is None:
                rec = self._vals[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            counts, _, _ = rec
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            rec[1] += value
            rec[2] += 1

    def series(self) -> list[tuple[dict, dict]]:
        with _LOCK:
            return [
                (dict(k), {"buckets": list(rec[0]), "sum": rec[1],
                           "count": rec[2]})
                for k, rec in sorted(self._vals.items())
            ]

    def _reset(self) -> None:
        self._vals.clear()


class Registry:
    """Name -> metric, with get-or-create accessors (kind-checked)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        # lock-free fast path: dict reads are atomic in CPython, and a hit
        # of the right kind needs no mutation — this runs per count()/
        # observe() on the serving hot path
        m = self._metrics.get(name)
        if type(m) is cls:
            return m
        with _LOCK:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> dict:
        with _LOCK:
            return dict(self._metrics)

    def reset(self) -> None:
        # drop metrics entirely (not just their series): a reset registry
        # must be indistinguishable from a fresh one — names re-register on
        # the next write, and no call site caches metric objects
        with _LOCK:
            self._metrics.clear()


REGISTRY = Registry()


# ---------------------------------------------------------------------------
# trace ring (Chrome trace_event format, Perfetto-loadable)
# ---------------------------------------------------------------------------

class _TraceRing:
    def __init__(self, cap: int = 8192):
        self.cap = int(cap)
        self._buf: list[dict] = []
        self._pos = 0
        self.dropped = 0

    def append(self, ev: dict) -> None:
        with _LOCK:
            if len(self._buf) < self.cap:
                self._buf.append(ev)
            else:  # overwrite the oldest: memory stays flat under load
                self._buf[self._pos] = ev
                self._pos = (self._pos + 1) % self.cap
                self.dropped += 1

    def events(self) -> list[dict]:
        with _LOCK:
            return self._buf[self._pos:] + self._buf[: self._pos]

    def clear(self) -> None:
        with _LOCK:
            self._buf.clear()
            self._pos = 0
            self.dropped = 0


_TRACE = _TraceRing()


def set_trace_cap(cap: int) -> None:
    """Resize the trace ring (drops buffered events)."""
    global _TRACE
    with _LOCK:
        _TRACE = _TraceRing(cap)


def trace_events() -> list[dict]:
    return _TRACE.events()


def _trace_event(name: str, ts_us: float, dur_us: float, args: dict) -> None:
    _TRACE.append({
        "name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": args,
    })


# ---------------------------------------------------------------------------
# instrument entry points (all no-ops behind one branch while disabled)
# ---------------------------------------------------------------------------

def count(name: str, value: float = 1, help: str = "", **labels) -> None:
    if not _ENABLED:
        return
    REGISTRY.counter(name, help).inc(value, **labels)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    if not _ENABLED:
        return
    REGISTRY.gauge(name, help).set(value, **labels)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    if not _ENABLED:
        return
    REGISTRY.histogram(name, help).observe(value, **labels)


class _NullSpan:
    """The disabled path: one shared object, no per-call allocation."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: prefix of the spans' ranges in a ``torch.profiler`` trace
RANGE_PREFIX = "repro_torch."
#: whether a ``torch.profiler`` (or the autograd profiler) is collecting
_profiling = torch._C._autograd._profiler_enabled


def _range(name: str):
    """The span's profiler range (``user_annotation`` in the trace)."""
    return record_function(RANGE_PREFIX + name)


class _LiveSpan:
    """Plain-class context manager (no generator machinery: this sits on
    the per-query serving path, where the <5% overhead budget lives)."""

    __slots__ = ("name", "labels", "dev", "t0", "ts", "rng")

    def __init__(self, name: str, labels: dict, dev):
        self.name, self.labels, self.dev = name, labels, dev

    def __enter__(self):
        self.rng = _range(self.name) if _profiling() else None
        if self.rng is not None:
            self.rng.__enter__()
        self.t0 = time.perf_counter()
        self.ts = (self.t0 - _T0) * 1e6
        return self

    def __exit__(self, etype, exc, tb):
        # __exit__ IS the close-on-exception guarantee: the histogram
        # observation, the trace event and the range's end land either way
        if etype is None and self.dev is not None:
            sync(self.dev)
        dur = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(etype, exc, tb)
        args = dict(self.labels)
        if etype is not None:
            args["error"] = True
        observe("stage_seconds", dur, stage=self.name, **self.labels)
        _trace_event(self.name, self.ts, dur * 1e6, args)
        return False


def span(name: str, *, sync=None, **labels):
    """Time a stage: ``with telemetry.span("dispatch", engine="nsw"): ...``.

    Telemetry on: records the wall time into ``stage_seconds{stage=name,
    **labels}`` and appends one complete ('X') trace event; on exception
    the span still closes, with ``error: true`` in the event args.  With
    ``sync=dev`` a body that raised nothing has its work on ``dev``
    synchronised before the clock is read.  While ``torch.profiler``
    collects, on or off, the span is also the profiler range
    ``repro_torch.<name>`` (which never synchronises).  Both off: the
    shared null span."""
    if _ENABLED:
        return _LiveSpan(name, labels, sync)
    if _profiling():
        return _range(name)
    return _NULL_SPAN


# ---------------------------------------------------------------------------
# read-side: series access, snapshot tree, Prometheus text, trace dump
# ---------------------------------------------------------------------------

def counter_series(name: str) -> list[tuple[dict, float]]:
    m = REGISTRY.metrics().get(name)
    return m.series() if isinstance(m, Counter) else []


def histogram_series(name: str) -> list[tuple[dict, dict]]:
    m = REGISTRY.metrics().get(name)
    return m.series() if isinstance(m, Histogram) else []


def counter_total(name: str, **match) -> float:
    m = REGISTRY.metrics().get(name)
    return m.total(**match) if isinstance(m, Counter) else 0.0


def snapshot() -> dict:
    """The registry as a nested dict tree (stats()/BENCH embedding)."""
    out: dict = {"enabled": _ENABLED, "counters": {}, "gauges": {},
                 "histograms": {}}
    for name, m in sorted(REGISTRY.metrics().items()):
        if isinstance(m, Histogram):
            out["histograms"][name] = {
                _label_str(_label_key(lbl)): rec for lbl, rec in m.series()
            }
        elif isinstance(m, Gauge):
            out["gauges"][name] = {
                _label_str(_label_key(lbl)): v for lbl, v in m.series()
            }
        elif isinstance(m, Counter):
            out["counters"][name] = {
                _label_str(_label_key(lbl)): v for lbl, v in m.series()
            }
    out["trace"] = {"events": len(_TRACE.events()),
                    "dropped": _TRACE.dropped, "cap": _TRACE.cap}
    return out


def summary() -> dict:
    """Compact snapshot for benchmark stamps: histogram bucket arrays are
    collapsed to count/sum/mean — the breakdown, not the full distribution."""
    snap = snapshot()
    hists = {}
    for name, series in snap["histograms"].items():
        hists[name] = {
            lbl: {"count": rec["count"], "sum": round(rec["sum"], 6),
                  "mean": round(rec["sum"] / rec["count"], 6)
                  if rec["count"] else 0.0}
            for lbl, rec in series.items()
        }
    return {"counters": snap["counters"], "gauges": snap["gauges"],
            "histograms": hists, "trace": snap["trace"]}


def _esc(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(lbl: dict, extra: Optional[dict] = None) -> str:
    items = {**lbl, **(extra or {})}
    if not items:
        return ""
    inner = ",".join(f'{k}="{_esc(str(v))}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt_val(v: float) -> str:
    return repr(int(v)) if float(v) == int(v) else repr(float(v))


def metrics_text() -> str:
    """Prometheus text exposition format (version 0.0.4) of the registry.

    Histograms expand to cumulative ``<name>_bucket{le=...}`` series plus
    ``<name>_sum`` / ``<name>_count``; counters/gauges render one line per
    label set.  Served by ``examples/serve_search.py --metrics-port``."""
    lines: list[str] = []
    for name, m in sorted(REGISTRY.metrics().items()):
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, Histogram):
            for lbl, rec in m.series():
                cum = 0
                for ub, c in zip(m.buckets, rec["buckets"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lbl, {'le': repr(float(ub))})} {cum}"
                    )
                cum += rec["buckets"][-1]
                lines.append(
                    f"{name}_bucket{_fmt_labels(lbl, {'le': '+Inf'})} {cum}"
                )
                lines.append(f"{name}_sum{_fmt_labels(lbl)} {repr(rec['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(lbl)} {rec['count']}")
        else:
            for lbl, v in m.series():
                lines.append(f"{name}{_fmt_labels(lbl)} {_fmt_val(v)}")
    return "\n".join(lines) + "\n"


def dump_trace(path: str) -> str:
    """Write the trace ring as Chrome ``trace_event`` JSON — open it in
    Perfetto (ui.perfetto.dev) or chrome://tracing for the flamegraph."""
    payload = {
        "traceEvents": _TRACE.events(),
        "displayTimeUnit": "ms",
        "metadata": {"dropped_events": _TRACE.dropped,
                     "ring_capacity": _TRACE.cap},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def reset() -> None:
    """Zero every metric and clear the trace ring (tests / bench cells)."""
    REGISTRY.reset()
    _TRACE.clear()


def q_label(q) -> str:
    """Canonical string form of the q knob for labels ('inf', '2.0', ...)."""
    try:
        import math as _math

        return "inf" if _math.isinf(float(q)) else str(float(q))
    except (TypeError, ValueError):
        return str(q)
