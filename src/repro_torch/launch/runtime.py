"""Overload-safe async serving runtime — port of ``repro.launch.runtime``.

``SearchServer`` answers one batch at a time; this module puts a bounded,
deadline-aware admission queue and a continuous batcher in front of it:

* **Bounded admission** — ``submit`` enqueues one request; when the queue
  is at capacity it raises ``Rejected(reason="capacity")`` with a
  ``retry_after_s`` hint.  While the circuit breaker is open, submits
  fast-fail with ``Rejected(reason="breaker")`` and the breaker's
  remaining cooldown.
* **Continuous batching** — a single batcher thread drains the queue into
  buckets keyed ``(k, filter-view)``; a bucket flushes when it reaches
  ``max_batch`` or its oldest request has waited ``flush_ms``
  (size-or-timeout), and dispatches through ``SearchServer.query`` — the
  same pow2 padding, device sync and ``ServedResult`` as a direct call, on
  the server's device.
* **Load shedding** — requests whose deadline lapsed while queued are shed
  before compute with ``outcome="shed_expired"``; dispatch order within a
  bucket is EDF (earliest deadline first).  Every submitted request
  resolves to a ``ServedResult`` or a raised error.
* **Watermark backpressure** — queue depth above ``high_watermark`` walks
  the server's health SERVING -> DEGRADED and tightens the comparison
  budget down ``core/backoff.degraded_budget``'s pow2 ladder; below
  ``low_watermark`` (and with no dead shard) the budget and health
  recover.
* **Circuit breaking** — ``core/backoff.CircuitBreaker`` wraps dispatch:
  consecutive dispatch faults or whole-batch deadline misses trip it open,
  queued work fast-fails (``outcome="shed_breaker"``), and a half-open
  probe closes it once the engine answers in time again.  The chaos plan's
  ``slow_search`` site fires at dispatch.

``start_http_front`` serves the runtime over a socket (stdlib
``ThreadingHTTPServer``): POST /search answers 200, or 429 / 503 with
``Retry-After`` on admission rejection, or 504 when the request was shed;
GET /healthz and /metrics.

Telemetry (when ``core/telemetry`` is enabled): ``queue_depth``,
``batch_fill``, ``queue_wait_seconds``, ``admission_total{outcome=}``,
``shed_total{reason=}``, ``batches_formed_total``, ``breaker_state``,
``breaker_trips_total``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.core import backoff as backoff_lib
from repro_torch.core import probes as probes_lib
from repro_torch.core import telemetry as telem
from repro_torch.launch.serve import SearchServer, ServedResult

#: ``batch_fill`` histogram buckets: batch sizes, not seconds — registered
#: explicitly so ``telem.observe`` reuses them instead of latency buckets.
BATCH_FILL_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class Rejected(Exception):
    """Admission refused — the request never entered the queue.

    ``reason`` is ``"capacity"`` (queue full) or ``"breaker"`` (circuit
    open); ``retry_after_s`` is the client backoff hint (maps to the HTTP
    ``Retry-After`` header in ``start_http_front``)."""

    def __init__(self, reason: str, retry_after_s: float = 0.0):
        super().__init__(f"rejected: {reason} (retry after "
                         f"{retry_after_s:.3f}s)")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class Ticket:
    """Handle for one submitted request — ``result()`` blocks for its
    ``ServedResult`` (or re-raises the dispatch error)."""

    __slots__ = ("_future", "seq")

    def __init__(self, future: Future, seq: int):
        self._future = future
        self.seq = seq

    def result(self, timeout: Optional[float] = None) -> ServedResult:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()


class _Request:
    __slots__ = ("q", "k", "dl_abs", "deadline_ms", "filter", "t_submit",
                 "seq", "future")

    def __init__(self, q, k, dl_abs, deadline_ms, filter, seq):
        self.q = q
        self.k = k
        self.dl_abs = dl_abs  # absolute monotonic expiry, or None
        self.deadline_ms = deadline_ms
        self.filter = filter
        self.t_submit = time.monotonic()
        self.seq = seq
        self.future: Future = Future()


def _edf_key(r: _Request):
    """EDF order: earliest absolute deadline first; undeadlined requests
    last; FIFO (submit sequence) within ties."""
    return (r.dl_abs if r.dl_abs is not None else float("inf"), r.seq)


class BoundedQueue:
    """Bounded request queue, bucketed by dispatch key.

    Buckets key on ``(k, filter-view)`` — requests that can share one
    padded dispatch.  ``offer`` is O(1) and refuses (returns False) at
    capacity; ``take_batch`` blocks until some bucket is flush-ready
    (reached ``max_batch``, or its oldest request waited ``flush_s``) and
    returns it EDF-ordered.  Capacity counts requests across all buckets.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._buckets: dict = {}  # key -> list[_Request]
        self._depth = 0

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def offer(self, key, req: _Request) -> bool:
        with self._nonempty:
            if self._depth >= self.capacity:
                return False
            self._buckets.setdefault(key, []).append(req)
            self._depth += 1
            self._nonempty.notify()
            return True

    def take_batch(self, max_batch: int, flush_s: float, *,
                   poll_s: float = 0.05):
        """Next flush-ready bucket as ``(key, [requests])`` EDF-ordered,
        or None after ``poll_s`` of emptiness (lets the caller check its
        running flag)."""
        with self._nonempty:
            while True:
                if self._depth == 0:
                    if not self._nonempty.wait(timeout=poll_s):
                        return None
                    continue
                now = time.monotonic()
                # the bucket whose head has waited longest decides the
                # flush clock (continuous batching's size-or-timeout)
                key = min(self._buckets,
                          key=lambda kk: self._buckets[kk][0].t_submit)
                reqs = self._buckets[key]
                waited = now - reqs[0].t_submit
                if len(reqs) >= max_batch or waited >= flush_s:
                    reqs.sort(key=_edf_key)
                    take, rest = reqs[:max_batch], reqs[max_batch:]
                    if rest:
                        self._buckets[key] = rest
                    else:
                        del self._buckets[key]
                    self._depth -= len(take)
                    return key, take
                self._nonempty.wait(timeout=max(1e-4, flush_s - waited))

    def drain(self) -> list:
        """Remove and return every queued request (shutdown path)."""
        with self._lock:
            out = [r for reqs in self._buckets.values() for r in reqs]
            self._buckets.clear()
            self._depth = 0
            return out


@dataclasses.dataclass
class OverloadPolicy:
    """The runtime's knobs (DESIGN.md §18).

    ``capacity`` bounds queued requests (admission rejects beyond it);
    ``max_batch`` / ``flush_ms`` are the continuous batcher's
    size-or-timeout; ``high_watermark`` / ``low_watermark`` are queue-fill
    fractions walking health DEGRADED/SERVING and driving the
    ``degraded_budget`` pow2 ladder; ``budget`` is the full-headroom
    comparison budget (None = engine default, ladder disabled);
    ``breaker_*`` parameterize the dispatch circuit breaker."""

    capacity: int = 1024
    max_batch: int = 64
    flush_ms: float = 2.0
    high_watermark: float = 0.5
    low_watermark: float = 0.25
    budget: Optional[int] = None
    budget_floor: int = 8
    breaker_trip: int = 5
    breaker_cooldown_s: float = 0.5
    breaker_cooldown_cap_s: float = 8.0


class ServingRuntime:
    """The async front for a ``SearchServer``: bounded admission,
    continuous batching, shedding, backpressure, circuit breaking.

    Lifecycle: construct over a built server, ``start()`` the batcher
    thread, ``submit()`` from any number of client threads, ``stop()`` to
    drain (leftover queued requests resolve ``outcome="shed_shutdown"`` —
    never silently dropped).  ``submit`` before ``start`` is allowed and
    simply queues (tests use this to fill the queue deterministically).
    """

    def __init__(self, server: SearchServer,
                 policy: Optional[OverloadPolicy] = None):
        self.server = server
        self.policy = policy or OverloadPolicy()
        self.queue = BoundedQueue(self.policy.capacity)
        self.breaker = backoff_lib.CircuitBreaker(
            trip=self.policy.breaker_trip,
            cooldown_s=self.policy.breaker_cooldown_s,
            cooldown_cap_s=self.policy.breaker_cooldown_cap_s)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._ewma_batch_s = self.policy.flush_ms / 1e3  # service-time est.
        self.counters = {
            "admitted": 0, "rejected_capacity": 0, "rejected_breaker": 0,
            "completed": 0, "shed_expired": 0, "shed_breaker": 0,
            "shed_shutdown": 0, "dispatch_faults": 0, "batches": 0,
        }
        if telem.enabled():
            telem.REGISTRY.histogram(
                "batch_fill", "requests per formed batch",
                buckets=BATCH_FILL_BUCKETS)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingRuntime":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._batcher, name="serving-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._running = False
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        for r in self.queue.drain():
            self._count("shed_shutdown")
            telem.count("shed_total", reason="shutdown")
            self._resolve_shed(r, "shed_shutdown", deadline_met=True)
        self._gauge_depth()

    # ------------------------------------------------------------ admission
    def submit(self, q, k: int = 10, *, deadline_ms: Optional[float] = None,
               filter: Optional[dict] = None) -> Ticket:
        """Enqueue one query vector ``q`` (shape (d,)).  Raises
        ``Rejected`` when the queue is full or the breaker is open."""
        ra = self.breaker.retry_after_s()
        if ra > 0.0:
            self._count("rejected_breaker")
            telem.count("admission_total", outcome="rejected_breaker")
            raise Rejected("breaker", retry_after_s=ra)
        dl_abs = (None if deadline_ms is None
                  else time.monotonic() + float(deadline_ms) / 1e3)
        req = _Request(np.asarray(q, np.float32), int(k), dl_abs,
                       deadline_ms, filter, next(self._seq))
        key = (req.k, probes_lib.view_key(filter))
        if not self.queue.offer(key, req):
            # hint: time to drain one batch's worth of the current depth
            est = self._ewma_batch_s * max(
                1.0, self.queue.depth() / max(1, self.policy.max_batch))
            self._count("rejected_capacity")
            telem.count("admission_total", outcome="rejected_capacity")
            raise Rejected("capacity", retry_after_s=est)
        self._count("admitted")
        telem.count("admission_total", outcome="admitted")
        self._gauge_depth()
        return Ticket(req.future, req.seq)

    # ------------------------------------------------------------- batcher
    def _batcher(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    return
            got = self.queue.take_batch(self.policy.max_batch,
                                        self.policy.flush_ms / 1e3)
            if got is None:
                continue
            key, reqs = got
            self._gauge_depth()
            try:
                self._dispatch(key, reqs)
            except BaseException as e:  # never kill the batcher silently
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _dispatch(self, key, reqs: list) -> None:
        k = key[0]
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.dl_abs is not None and now >= r.dl_abs:
                # shed BEFORE compute: the deadline lapsed in the queue
                self._count("shed_expired")
                telem.count("shed_total", reason="expired")
                self._resolve_shed(r, "shed_expired", deadline_met=False)
            else:
                live.append(r)
        if not live:
            return
        if not self.breaker.allow():
            for r in live:
                self._count("shed_breaker")
                telem.count("shed_total", reason="breaker")
                self._resolve_shed(r, "shed_breaker", deadline_met=True)
            return
        telem.count("batches_formed_total", k=k)
        telem.observe("batch_fill", float(len(live)))
        self._count("batches")
        eff_budget = self._backpressure()
        # batch deadline = tightest remaining among its members (EDF put
        # the tightest first, so the whole bucket shares its pressure)
        rem = [(r.dl_abs - now) * 1e3 for r in live if r.dl_abs is not None]
        batch_dl = min(rem) if rem else None
        batch = np.stack([r.q for r in live])
        t0 = time.monotonic()
        ok = True
        tripped = False
        try:
            if self.server.chaos is not None:
                # the runtime-level fault site: latency rules stall the
                # dispatch thread (queue grows, deadlines slip), fault
                # rules raise — both feed the breaker deterministically
                self.server.chaos.on_slow_search()
            res = self.server.query(batch, k=k, budget=eff_budget,
                                    filter=live[0].filter,
                                    deadline_ms=batch_dl)
        except Exception as e:
            ok = False
            self._count("dispatch_faults")
            telem.count("dispatch_faults_total")
            tripped = self.breaker.record(False)
            for r in live:
                r.future.set_exception(e)
        else:
            done = time.monotonic()
            n_met = 0
            for i, r in enumerate(live):
                met = r.dl_abs is None or done <= r.dl_abs
                n_met += met
                queue_ms = (t0 - r.t_submit) * 1e3
                r.future.set_result(ServedResult(
                    res.idx[i:i + 1], res.dist[i:i + 1],
                    res.comparisons[i:i + 1], degraded=res.degraded,
                    shards_answered=res.shards_answered,
                    shards_total=res.shards_total, retries=res.retries,
                    deadline_met=met, queue_ms=queue_ms, outcome="ok"))
                self._count("completed")
                telem.count("admission_total", outcome="completed")
                telem.observe("queue_wait_seconds", queue_ms / 1e3)
            # a whole-batch deadline miss counts as a dispatch failure:
            # N consecutive ones mean the engine can't keep up — trip
            ok = n_met == len(live)
            tripped = self.breaker.record(ok)
        if tripped:
            telem.count("breaker_trips_total")
        self._ewma_batch_s = (0.8 * self._ewma_batch_s
                              + 0.2 * (time.monotonic() - t0))
        telem.set_gauge("breaker_state", self.breaker.state_code(),
                        engine=self.server.engine)

    def _backpressure(self) -> Optional[int]:
        """Queue fill -> effective comparison budget + health walk.

        Headroom (1 - fill) feeds the §14 ``degraded_budget`` pow2 ladder:
        above ``high_watermark`` the server is marked DEGRADED and each
        further halving of headroom halves the budget (the q/anytime knob
        — faster, lower-recall answers drain the queue); back below
        ``low_watermark`` with no dead shards, SERVING and the full
        budget return."""
        fill = self.queue.depth() / max(1, self.policy.capacity)
        if fill >= self.policy.high_watermark:
            self.server._set_health("DEGRADED")
        elif (fill <= self.policy.low_watermark
              and not self.server._dead_shards
              and self.server.health == "DEGRADED"):
            self.server._set_health("SERVING")
        return backoff_lib.degraded_budget(
            self.policy.budget, 1.0 - fill, floor=self.policy.budget_floor)

    # ------------------------------------------------------------- helpers
    def _resolve_shed(self, r: _Request, outcome: str,
                      deadline_met: bool) -> None:
        k = r.k
        r.future.set_result(ServedResult(
            np.full((1, k), -1, np.int32),
            np.full((1, k), np.inf, np.float32),
            np.zeros((1,), np.int32), deadline_met=deadline_met,
            queue_ms=(time.monotonic() - r.t_submit) * 1e3,
            outcome=outcome))

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def _gauge_depth(self) -> None:
        telem.set_gauge("queue_depth", self.queue.depth(),
                        engine=self.server.engine)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out.update(
            queue_depth=self.queue.depth(),
            capacity=self.policy.capacity,
            breaker_state=self.breaker.state,
            breaker_trips=self.breaker.trips,
            health=self.server.health,
        )
        return out


# ---------------------------------------------------------------------------
# HTTP front: the socket path
# ---------------------------------------------------------------------------

def start_http_front(runtime: ServingRuntime, port: int = 0,
                     *, result_timeout_s: float = 30.0):
    """Serve the runtime over HTTP on ``port`` (0 = ephemeral); returns the
    ``ThreadingHTTPServer`` (``.server_address[1]`` is the bound port,
    ``.shutdown()`` stops it).

    * ``POST /search`` body ``{"q": [...], "k": 10, "deadline_ms": 50}``
      → 200 with idx/dist/outcome/queue_ms, or 429 (+``Retry-After``) at
      capacity, 503 (+``Retry-After``) while the breaker is open, 504 when
      the request was shed (deadline expired in queue / breaker opened
      before dispatch).
    * ``GET /healthz`` → health + queue depth + breaker state.
    * ``GET /metrics`` → Prometheus exposition (``core/telemetry``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: the load generator hammers this
            pass

        def _json(self, code: int, obj: dict, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for hk, hv in headers:
                self.send_header(hk, hv)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, runtime.stats())
            elif self.path == "/metrics":
                body = telem.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/search":
                self._json(404, {"error": "not found"})
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
                q = np.asarray(payload["q"], np.float32)
            except (KeyError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                ticket = runtime.submit(
                    q, int(payload.get("k", 10)),
                    deadline_ms=payload.get("deadline_ms"),
                    filter=payload.get("filter"))
            except Rejected as e:
                code = 429 if e.reason == "capacity" else 503
                self._json(code, {"outcome": f"rejected_{e.reason}",
                                  "retry_after_s": e.retry_after_s},
                           headers=(("Retry-After",
                                     f"{max(e.retry_after_s, 1e-3):.3f}"),))
                return
            try:
                r = ticket.result(timeout=result_timeout_s)
            except Exception as e:
                self._json(500, {"error": repr(e)})
                return
            if r.outcome != "ok":
                self._json(504, {"outcome": r.outcome,
                                 "queue_ms": r.queue_ms})
                return
            self._json(200, {
                "outcome": "ok",
                "idx": np.asarray(r.idx)[0].tolist(),
                "dist": np.asarray(r.dist)[0].tolist(),
                "comparisons": int(np.asarray(r.comparisons)[0]),
                "degraded": bool(r.degraded),
                "deadline_met": bool(r.deadline_met),
                "queue_ms": float(r.queue_ms),
            })

    httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="serving-http").start()
    return httpd
