"""Serving entry point: the paper's online path behind a batch API — port of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine infinity --n 10000
  PYTHONPATH=src python -m repro_torch.launch.serve --engine nsw --live \
      --delta-cap 512 --snapshot /tmp/idx
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --engine brute --shards 2

``SearchServer`` is registry-driven: any engine key from ``core/index``
(brute / ivf_flat / ivf_pq / nsw / infinity) behind one ``query`` method,
on ``device`` (default CUDA; the CLI's ``--device``); ``shards=S > 1``
serves it as ``ShardedIndex`` over S row shards, all on that device.
Query batches are padded on the host to a power-of-two bucket (floor 8, repeating the last
row) and copied to the device once; the answer is sliced back.  The pad
decides the traversal: the infinity engine takes the beam for batches of
64 or more, so a batch of 40 is served padded to 64, by the beam.

``live=True`` wraps the engine in ``core/live``: the server gains
``upsert`` / ``delete`` / ``compact`` / ``snapshot``, and ``stats()``
reports segment composition.  ``SearchServer.restore(path)`` rebuilds a
server from a ``core/store`` snapshot (either package's) with no build.

Filtered search: build with ``attrs={column: per-row values}`` and pass
``filter={...}`` to ``query`` / ``serve``.  Quantized serving: ``quant=True``
adds the ``quant`` registry key.

Fault tolerance: ``query(deadline_ms=...)`` shrinks the comparison budget
with the remaining deadline (``core/backoff.degraded_budget``) and retries
transient faults with capped exponential backoff; a shard that stays dead
(``core/chaos.ShardFault``) is masked out of the merge and the survivors
answer, stamped ``degraded`` with ``shards_answered`` < ``shards_total``.
Every answer is a ``ServedResult``.  The server runs a SERVING -> DEGRADED
-> RECOVERING health machine (a masked shard walks it to DEGRADED; the
next full answer back to SERVING): ``snapshot_dir=`` keeps a
sha256-verified last-good snapshot that a failed swap restores.  ``chaos=`` arms a
``core/chaos.FaultPlan``; ``probe=`` an online recall probe
(``core/probes``) whose ground truth is ``core/scan.topk_scan``.

The dispatch span synchronises the device before it closes, so latency,
``search_latency`` and the stats percentiles time the search, not its
launches.  ``capture_roofline`` profiles the engine's batched search
through ``core/profile`` (analytic flops and bytes against the H100's
peaks, timed by CUDA events).  ``launch/runtime`` puts an admission queue,
a batcher and an HTTP front before ``query``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backoff as backoff_lib
from repro_torch.core import chaos as chaos_lib
from repro_torch.core import index as index_lib
from repro_torch.core import probes as probes_lib
from repro_torch.core import telemetry as telem
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device, sync


def _bucket(n: int, floor: int = 8) -> int:
    """Smallest power-of-two >= n (>= floor) — the padded batch."""
    from repro_torch.core.scan import pow2ceil

    return max(floor, pow2ceil(n))


def _host(batch) -> np.ndarray:
    """A query batch as host f32 (a tensor on any device is copied back)."""
    if isinstance(batch, torch.Tensor):
        return batch.detach().to("cpu", torch.float32).numpy()
    return np.asarray(batch, np.float32)


class LatencyRing:
    """Bounded per-batch latency window: percentiles/QPS over the most
    recent ``cap`` batches; lifetime totals live in separate counters."""

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self._lat = np.zeros((self.cap,), np.float64)
        self._nq = np.zeros((self.cap,), np.int64)
        self._pos = 0
        self._len = 0

    def append(self, lat_s: float, n_queries: int) -> None:
        self._lat[self._pos] = lat_s
        self._nq[self._pos] = n_queries
        self._pos = (self._pos + 1) % self.cap
        self._len = min(self._len + 1, self.cap)

    def __len__(self) -> int:
        return self._len

    def window(self) -> tuple[np.ndarray, np.ndarray]:
        """(latencies_s, batch_sizes) of the window, oldest-truncated."""
        if self._len < self.cap:
            return self._lat[: self._len], self._nq[: self._len]
        return self._lat, self._nq


class ServedResult(NamedTuple):
    """A ``SearchResult`` on the host plus the serving-layer provenance.

    ``degraded`` is True when a dead shard was masked out of the merge:
    ``idx`` / ``dist`` then cover only the ``shards_answered`` surviving
    shards' rows of ``shards_total``.  ``retries`` counts transparent
    re-attempts this request absorbed; ``deadline_met`` is False when the
    answer returned after its deadline.  ``queue_ms`` is the time the
    request waited in the async runtime's queue and ``outcome`` tells a
    computed answer (``"ok"``) from an explicit shed (``"shed_expired"``,
    ``"shed_breaker"``, ``"shed_shutdown"``: idx -1 rows, 0 comparisons);
    direct ``query`` calls carry 0 / ``"ok"``."""

    idx: np.ndarray  # (B, k) int32, -1 = no result
    dist: np.ndarray  # (B, k) f32 ascending
    comparisons: np.ndarray  # (B,) int32
    degraded: bool = False
    shards_answered: int = 1
    shards_total: int = 1
    retries: int = 0
    deadline_met: bool = True
    queue_ms: float = 0.0
    outcome: str = "ok"


@dataclasses.dataclass
class FaultPolicy:
    """The serving controller's knobs (``SearchServer(policy=...)``):
    ``max_retries`` bounds transparent re-attempts per request, backoff
    between them is capped exponential; ``give_up_frac``: once less than
    this fraction of the deadline remains, a failing shard is masked out
    instead of retried; ``budget_floor`` floors the deadline->budget
    ladder."""

    max_retries: int = 2
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.05
    give_up_frac: float = 0.25
    budget_floor: int = 8


#: the health state machine's states: SERVING — full answers; DEGRADED —
#: answering from surviving shards / awaiting repair; RECOVERING — a
#: restore of the last good snapshot is in flight.
HEALTH_STATES = ("SERVING", "DEGRADED", "RECOVERING")


class SearchServer:
    """Build once, answer batched queries — the deployable object.

    ``swap`` rebuilds a different engine (or shard count) over the same
    corpus.  ``query`` pads the incoming batch to a power-of-two bucket and
    slices the answer back, retrying transient faults and masking dead
    shards.  ``chaos=`` arms a ``core/chaos.FaultPlan`` (or its dict sugar);
    ``snapshot_dir=`` keeps a sha256-verified last-good snapshot that a
    failed ``swap`` restores (health walks SERVING -> DEGRADED ->
    RECOVERING -> SERVING).
    """

    #: serving defaults applied when no cfg is given — the bounded two-stage
    #: operating point; pass cfg={} to get the engine's own raw defaults.
    DEFAULT_BUDGET = 256
    DEFAULT_RERANK = 96

    def __init__(self, corpus, *, engine: str = "infinity", shards: int = 1,
                 cfg: Optional[dict] = None, live: bool = False,
                 delta_cap: int = 1024, attrs: Optional[dict] = None,
                 quant: bool = False, chaos=None,
                 snapshot_dir: Optional[str] = None,
                 policy: Optional[FaultPolicy] = None,
                 probe=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.corpus = torch.as_tensor(_host(corpus), device=self.device)
        self.attr_values = dict(attrs) if attrs else None
        self.quant = bool(quant)
        self.chaos = None if chaos is None else chaos_lib.FaultPlan.from_cfg(chaos)
        self.policy = policy or FaultPolicy()
        self.snapshot_dir = snapshot_dir
        # online recall probe: float rate / dict / ProbeConfig
        self._probe = None if probe is None else probes_lib.RecallProbe(probe)
        self._reset_probe_buffers()
        self._init_fault_state()
        self.swap(engine, shards=shards, cfg=cfg, live=live, delta_cap=delta_cap)
        if snapshot_dir is not None:
            self._save_good_snapshot()

    def _reset_probe_buffers(self) -> None:
        self._probe_pending: list = []
        self._probe_raw: list = []
        self._probe_raw_q = 0
        self._probe_key = None
        self._probe_filter = None

    def _init_fault_state(self) -> None:
        self.health = "SERVING"
        self.health_log: list[str] = ["SERVING"]
        self._dead_shards: set[int] = set()
        self._last_good: Optional[str] = None
        self._snap_seq = 0
        # one lock for every cross-thread mutable serving stat (re-entrant:
        # _heal counts faults while walking health)
        self._state_lock = threading.RLock()
        self.fault_counters = {
            "faults": 0, "retries": 0, "degraded_queries": 0,
            "recoveries": 0, "snapshot_restores": 0, "snapshot_corrupt": 0,
            "deadline_misses": 0, "quality_breaches": 0,
        }

    def _count_fault(self, key: str, n: int = 1) -> None:
        with self._state_lock:
            self.fault_counters[key] += n

    def _set_health(self, state: str) -> None:
        assert state in HEALTH_STATES, state
        with self._state_lock:
            if state != self.health:
                telem.count("health_transitions_total",
                            **{"from": self.health, "to": state})
                self.health = state
                self.health_log.append(state)

    # ---------------------------------------------------------- self-healing
    def _save_good_snapshot(self) -> Optional[str]:
        """Write (and sha256-verify) a rotating last-good snapshot under
        ``snapshot_dir``.  A write the chaos plan corrupted fails
        verification and is discarded; one clean retry runs because the
        plan's draws advance per call."""
        if self.snapshot_dir is None:
            return None
        from repro_torch.core import store as store_lib

        for _ in range(2):
            self._snap_seq += 1
            path = os.path.join(self.snapshot_dir, f"snap-{self._snap_seq:04d}")
            try:
                store_lib.save(self.index, path)
                store_lib.verify(path)
            except store_lib.SnapshotCorruption:
                self._count_fault("snapshot_corrupt")
                shutil.rmtree(path, ignore_errors=True)
                continue
            old, self._last_good = self._last_good, path
            if old and old != path:
                shutil.rmtree(old, ignore_errors=True)
            return path
        return self._last_good

    def _heal(self, why: str) -> bool:
        """DEGRADED -> RECOVERING -> SERVING: restore the last good
        snapshot (sha256-verified on load), else keep the in-memory index.
        Returns True when a snapshot restore happened."""
        from repro_torch.core import store as store_lib

        self._set_health("DEGRADED")
        self._set_health("RECOVERING")
        restored = False
        if self._last_good is not None:
            try:
                self.index = store_lib.load(self._last_good, device=self.device)
                if self.chaos is not None:
                    index_lib.attach_chaos(self.index, self.chaos)
                self._count_fault("snapshot_restores")
                restored = True
            except store_lib.SnapshotCorruption:
                self._count_fault("snapshot_corrupt")
        if restored or getattr(self, "index", None) is not None:
            self._count_fault("recoveries")
            self._set_health("SERVING")
        return restored

    def swap(self, engine: str, *, shards: int = 1, cfg: Optional[dict] = None,
             live: Optional[bool] = None, delta_cap: Optional[int] = None,
             quant: Optional[bool] = None) -> None:
        """(Re)build the serving index over the held corpus.  ``live``/
        ``delta_cap``/``quant`` (and the attribute columns given at
        construction) stick across swaps unless overridden."""
        if cfg is None:
            cfg = default_cfg(engine, budget=self.DEFAULT_BUDGET,
                              rerank=self.DEFAULT_RERANK)
        self.live = bool(live) if live is not None else getattr(self, "live", False)
        if quant is not None:
            self.quant = bool(quant)
        if delta_cap is not None:
            self.delta_cap = int(delta_cap)
        else:
            self.delta_cap = getattr(self, "delta_cap", 1024)
        t0 = time.perf_counter()
        if shards > 1:
            inner, inner_cfg = "sharded", {
                "engine": engine, "shards": shards, "engine_cfg": dict(cfg or {})}
        else:
            inner, inner_cfg = engine, dict(cfg or {})
        attrs = self.attr_values
        try:
            if self.live:
                top_cfg = {"engine": inner, "engine_cfg": inner_cfg,
                           "delta_cap": self.delta_cap}
                if attrs:
                    top_cfg["attrs"] = attrs
                if self.quant:
                    top_cfg["quant"] = True
                if self.chaos is not None:
                    top_cfg["chaos"] = self.chaos
                built = index_lib.build("live", self.corpus, top_cfg, device=self.device)
            else:
                if attrs:
                    inner_cfg["attrs"] = attrs
                if self.quant:
                    inner_cfg["quant"] = True
                if self.chaos is not None:
                    inner_cfg["chaos"] = self.chaos
                built = index_lib.build(inner, self.corpus, inner_cfg, device=self.device)
        except chaos_lib.FaultError:
            self._count_fault("faults")
            self._heal(f"swap({engine!r}) build poisoned")
            raise
        self.index = built
        self.engine = engine
        self.shards = shards
        self._dead_shards.clear()
        self.build_s = time.perf_counter() - t0
        self._reset_window()

    def _reset_window(self) -> None:
        """Fresh latency window, bucket set and probe stream (a new engine
        must never mix into the old one's estimate)."""
        self._lat = LatencyRing()
        self._queries = 0
        self._batches = 0
        self._buckets_seen: set = set()  # (engine, bucket, k) first-seen keys
        if self._probe is not None:
            self._probe.reset()
        self._reset_probe_buffers()

    @classmethod
    def restore(cls, path: str, *, device: DeviceLike = None) -> "SearchServer":
        """Rebuild a server from a ``core/store`` snapshot on ``device`` —
        no index build.  The corpus is recovered from the index (a live
        index's logical view, else its X), so a later ``swap`` can build."""
        from repro_torch.core import store as store_lib

        dev = resolve_device(device)
        index = store_lib.load(path, device=dev)
        srv = object.__new__(cls)
        srv.device = dev
        srv.index = index
        srv.live = index.registry_name == "live"
        srv.quant = getattr(index, "quant", None) is not None
        srv.delta_cap = getattr(index, "delta_cap", 1024)
        if srv.live and index.engine == "sharded":
            srv.engine = index.engine_cfg.get("engine", "sharded")
            srv.shards = int(index.engine_cfg.get("shards", 2))
        elif srv.live:
            srv.engine, srv.shards = index.engine, 1
        elif index.registry_name == "sharded":
            srv.engine, srv.shards = index.engine, index.shards
        else:
            srv.engine, srv.shards = index.registry_name, 1
        if srv.live:
            srv.corpus = torch.as_tensor(index.corpus(), device=dev)
        else:
            srv.corpus = index_lib.corpus_of(index)
        # carry restored attribute columns across future swap() rebuilds
        # (live stores are slot-aligned: gather the alive slots, whose
        # order is exactly corpus()'s logical row order)
        store = getattr(index, "attrs", None)
        srv.attr_values = None
        if store is not None:
            if srv.live:
                srv.attr_values = store.to_values(np.where(index.slot_to_logical() >= 0)[0])
            else:
                srv.attr_values = store.to_values(np.arange(int(srv.corpus.shape[0])))
        srv.build_s = 0.0
        srv.chaos = None
        srv.policy = FaultPolicy()
        srv.snapshot_dir = None
        srv._probe = None
        srv._init_fault_state()
        srv._reset_window()
        return srv

    def query(self, batch, k: int = 10, *, budget: Optional[int] = None,
              filter: Optional[dict] = None, record: bool = True,
              deadline_ms: Optional[float] = None) -> ServedResult:
        """Answer one query batch; returns a host-side ``ServedResult``.

        ``filter`` — a ``core/filter`` predicate spec evaluated against the
        attribute columns the server was built with.  ``record=False``
        keeps a warm-up call out of the latency record.  ``deadline_ms``
        arms the degradation controller: the comparison budget shrinks with
        the remaining deadline on a pow2 ladder, transient faults retry
        with capped exponential backoff while time allows, and a shard that
        stays dead is masked out of the merge so the survivors still answer
        (``degraded``, ``shards_answered`` < ``shards_total``).  Without a
        deadline the same retry / mask logic runs, without budget
        shrinking."""
        raw_batch = batch  # the probe buffers from the caller's view
        arr = _host(batch)
        B = arr.shape[0]
        if B == 0:
            raise ValueError("empty query batch")
        Bp = _bucket(B)
        with telem.span("pad", engine=self.engine, bucket=Bp):
            # pad with copies of the last row on the host, then one copy
            # to the device
            if Bp > B:
                arr = np.concatenate(
                    [arr, np.broadcast_to(arr[-1:], (Bp - B, arr.shape[1]))]
                )
            batch = torch.as_tensor(arr, device=self.device)
        with self._state_lock:
            self._buckets_seen.add((self.engine, Bp, int(k)))
        pol = self.policy
        dl = backoff_lib.Deadline(deadline_ms)
        S = max(1, int(self.shards)) if not self.live else 1
        excluded: set[int] = set()
        retries = 0
        t0 = time.perf_counter()
        while True:
            eff_budget = backoff_lib.degraded_budget(
                budget, dl.fraction_left(), floor=pol.budget_floor)
            kw = {"budget": eff_budget, "filter": filter}
            if excluded:
                kw["shard_alive"] = tuple(s not in excluded for s in range(S))
            try:
                # the span closes (error=True) when a chaos fault escapes
                with telem.span("dispatch", engine=self.engine, bucket=Bp):
                    idx, dist, comps = self.index.search(batch, k=k, **kw)
                    sync(self.device)
                break
            except chaos_lib.ShardFault as e:
                self._count_fault("faults")
                telem.count("faults_total", engine=self.engine, kind="shard")
                known_dead = e.shard in self._dead_shards
                out_of_time = dl.fraction_left() < pol.give_up_frac
                if known_dead or out_of_time or retries >= pol.max_retries:
                    # mask the shard out and answer from the survivors: the
                    # request's remaining time goes to computing an answer
                    excluded.add(e.shard)
                    if len(excluded) >= S:
                        raise  # every shard down: nothing left to answer from
                    with self._state_lock:
                        self._dead_shards.add(e.shard)
                    self._set_health("DEGRADED")
                    continue  # immediately, no sleep
                retries += 1
                self._count_fault("retries")
                telem.count("retries_total", engine=self.engine, kind="shard")
                time.sleep(backoff_lib.backoff_s(
                    retries - 1, base_s=pol.backoff_base_s, cap_s=pol.backoff_cap_s))
            except chaos_lib.TransientFault:
                self._count_fault("faults")
                telem.count("faults_total", engine=self.engine, kind="transient")
                if retries >= pol.max_retries or dl.expired():
                    raise  # the plan scripted a fault storm; surface it
                retries += 1
                self._count_fault("retries")
                telem.count("retries_total", engine=self.engine, kind="transient")
                time.sleep(backoff_lib.backoff_s(
                    retries - 1, base_s=pol.backoff_base_s, cap_s=pol.backoff_cap_s))
        if not excluded and self._dead_shards:
            # a full, clean answer proves every shard is back: self-heal
            with self._state_lock:
                self._dead_shards.clear()
            self._count_fault("recoveries")
            self._set_health("SERVING")
        degraded = bool(excluded)
        if degraded:
            self._count_fault("degraded_queries")
            telem.count("degraded_total", engine=self.engine)
        deadline_met = not dl.expired()
        if not deadline_met:
            self._count_fault("deadline_misses")
            telem.count("deadline_misses_total", engine=self.engine)
        dt = time.perf_counter() - t0
        if record:
            with self._state_lock:
                self._lat.append(dt, B)
                self._queries += B
                self._batches += 1
            telem.observe("search_latency", dt, engine=self.engine, shards=S)
            telem.count("queries_total", B, engine=self.engine)
            if deadline_ms is not None:
                telem.set_gauge("deadline_slack_frac", dl.fraction_left(),
                                engine=self.engine)
        res = ServedResult(
            idx[:B].cpu().numpy(), dist[:B].cpu().numpy(), comps[:B].cpu().numpy(),
            degraded=degraded, shards_answered=S - len(excluded), shards_total=S,
            retries=retries, deadline_met=deadline_met,
        )
        if record and self._probe is not None:
            # observe-only: the answer and its latency are final first
            self._probe_observe(raw_batch, res.idx, k, filter)
        return res

    # -------------------------------------------------- online recall probes
    def _probe_observe(self, batch, served_idx, k, filter) -> None:
        """Enqueue this recorded batch for deferred sampling (a list
        append); ``_drain_raw`` samples every few batches.  Never raises
        into serving — a probe failure is a counted telemetry event."""
        probe = self._probe
        try:
            self._probe_raw.append((batch, served_idx, int(k), filter))
            self._probe_raw_q += served_idx.shape[0]
            if (len(self._probe_raw) >= 8
                    or probe.cfg.rate * self._probe_raw_q >= probe.cfg.flush_at):
                self._drain_raw()
        except Exception:
            telem.count("probe_errors_total", engine=self.engine)

    def _drain_raw(self) -> None:
        """Sample + buffer every enqueued batch (FIFO, so query ordinals
        land as synchronous per-batch sampling would), flushing ground
        truth whenever the buffer fills or the view changes."""
        raw, self._probe_raw = self._probe_raw, []
        self._probe_raw_q = 0
        probe = self._probe
        gen = self.index.stats()["generation"] if self.live else None
        for batch, served_idx, k, filter in raw:
            B = served_idx.shape[0]
            pick = probe.sample_indices(B)
            if len(pick):
                # one flush = one ground-truth view: same filter, same live
                # generation, same engine — anything else flushes first
                key = (probes_lib.view_key(filter), gen, self.engine)
                if self._probe_pending and key != self._probe_key:
                    self._flush_probes()
                self._probe_key = key
                self._probe_filter = filter
                Qs = _host(batch)[:B][pick]
                kp = min(probe.cfg.k, int(k))
                srv = np.asarray(served_idx)[pick][:, :kp]
                for row_q, row_i in zip(Qs, srv):
                    self._probe_pending.append((row_q, row_i))
            if len(self._probe_pending) >= probe.cfg.flush_at:
                self._flush_probes()

    def flush_probes(self) -> None:
        """Run deferred sampling and pending probe ground truth now
        (``stats()`` and every mutation call it)."""
        if self._probe is None:
            return
        try:
            if self._probe_raw:
                self._drain_raw()
            if self._probe_pending:
                self._flush_probes()
        except Exception:
            telem.count("probe_errors_total", engine=self.engine)

    def _flush_probes(self) -> None:
        from repro_torch.core import scan as scan_lib

        probe = self._probe
        pending, self._probe_pending = self._probe_pending, []
        if not pending:
            return
        corpus, mask, id_map = self._probe_view(self._probe_filter)
        t0 = time.perf_counter()
        m = len(pending)
        kp = max(len(row) for _, row in pending)
        # pad the flush to the fixed pow2 bucket, as serving pads
        Mp = _bucket(m, floor=min(probe.cfg.flush_at, 8))
        Qs = np.stack([q for q, _ in pending])
        if Mp > m:
            Qs = np.concatenate([Qs, np.repeat(Qs[-1:], Mp - m, axis=0)])
        kg = min(kp, int(corpus.shape[0]))
        _, gt_i = scan_lib.topk_scan(torch.as_tensor(Qs, device=self.device), corpus,
                                     k=kg, metric=self._probe_metric(), valid=mask)
        gt_i = gt_i[:m].cpu().numpy()
        srv = np.full((m, kp), -1, np.int64)
        for i, (_, row) in enumerate(pending):
            srv[i, : len(row)] = row
        if id_map is not None:  # live answers come in slot ids -> logical
            ok = (srv >= 0) & (srv < len(id_map))
            srv = np.where(ok, id_map[np.clip(srv, 0, len(id_map) - 1)], -1)
        hits, trials = probes_lib.count_hits(srv, gt_i)
        probe.observe(hits, trials)
        est = probe.estimate()
        labels = dict(engine=self.engine, q=self._probe_q_label(), k=kp)
        telem.set_gauge("recall_estimate", est["recall"], **labels)
        telem.set_gauge("recall_ci_low", est["lo"], **labels)
        telem.set_gauge("recall_ci_high", est["hi"], **labels)
        telem.count("probe_total", m, engine=self.engine)
        telem.observe("probe_seconds", time.perf_counter() - t0, engine=self.engine)
        trans = probe.update_slo()
        if trans == "breach":
            self._count_fault("quality_breaches")
            telem.count("quality_degraded_total", engine=self.engine)
            self._set_health("DEGRADED")
        elif trans == "recover" and not self._dead_shards and self.health != "SERVING":
            self._count_fault("recoveries")
            self._set_health("SERVING")

    def _probe_view(self, filter):
        """(corpus, valid mask, served-id map) for probe ground truth: the
        filter- and tombstone-correct sub-corpus, in the id space the
        engine answers in.  Live: the alive logical view with its
        slot->logical map; filtered: the predicate mask ANDed in."""
        from repro_torch.core import filter as filter_lib

        if self.live:
            live = self.index
            corpus = torch.as_tensor(live.corpus(), device=self.device)
            s2l = live.slot_to_logical()
            mask = None
            if filter is not None:
                if isinstance(filter, torch.Tensor):
                    slot_mask = filter.cpu().numpy().astype(bool)
                elif isinstance(filter, np.ndarray):
                    slot_mask = filter.astype(bool)
                else:
                    slot_mask = filter_lib.resolve_mask(
                        filter, live.attrs, len(s2l), self.device).cpu().numpy()
                mask = torch.as_tensor(slot_mask[: len(s2l)][s2l >= 0], device=self.device)
            return corpus, mask, s2l
        n = int(self.corpus.shape[0])
        mask = None
        if filter is not None:
            mask = filter_lib.resolve_mask(filter, getattr(self.index, "attrs", None), n,
                                           self.device)
        return self.corpus, mask, None

    def _probe_metric(self) -> str:
        for obj in (self.index, getattr(self.index, "config", None)):
            met = getattr(obj, "metric", None)
            if isinstance(met, str):
                return met
        return "euclidean"

    def _probe_q_label(self) -> str:
        q = getattr(getattr(self.index, "config", None), "q", None)
        return telem.q_label(q) if q is not None else "na"

    # --------------------------------------------------- roofline profiling
    def capture_roofline(self, *, batch: Optional[int] = None, k: int = 10,
                         budget: Optional[int] = None) -> dict:
        """Profile the current engine's batched search at a serving bucket
        shape through ``core/profile.capture_search``: the ``roofline_*``
        gauges land in the telemetry registry and the profile's row is
        returned, keyed by its program name.  ``batch`` defaults to the
        largest bucket this engine served (64 before any)."""
        from repro_torch.core import profile as profile_lib

        if batch is None:
            seen = [b for (e, b, _) in self._buckets_seen if e == self.engine]
            batch = max(seen) if seen else 64
        n = int(self.corpus.shape[0])
        idx = torch.arange(int(batch), device=self.corpus.device) % n
        prof = profile_lib.capture_search(
            self.index, self.corpus[idx], k=k, budget=budget, engine=self.engine,
            labels={"shards": self.shards})
        return {prof.name: prof.as_row()}

    # ------------------------------------------------------------- mutation
    def _live_index(self):
        if not self.live:
            raise TypeError(
                f"server runs a frozen {self.engine!r} index; build with "
                "live=True (--live) for upsert/delete/compact"
            )
        return self.index

    def upsert(self, vectors, ids=None, attrs=None) -> np.ndarray:
        """Insert / replace rows; visible to the next query (no rebuild).
        Self-heals an (injected) delta-buffer overflow: compaction drains
        the delta, then the write retries once."""
        live = self._live_index()
        self.flush_probes()  # judge buffered queries against pre-write corpus
        try:
            return live.upsert(vectors, ids=ids, attrs=attrs)
        except chaos_lib.DeltaOverflow:
            self._count_fault("faults")
            self.compact()
            out = live.upsert(vectors, ids=ids, attrs=attrs)
            self._count_fault("recoveries")
            return out

    def delete(self, ids) -> int:
        """Tombstone rows; returns how many were newly marked dead."""
        live = self._live_index()
        self.flush_probes()  # judge buffered queries against pre-delete corpus
        return live.delete(ids)

    def compact(self, mode: Optional[str] = None) -> np.ndarray:
        """Force a generation swap; returns the old->new slot remap.  A
        compaction the chaos plan kills dies before the atomic publish, so
        the old generation keeps serving — only the fault is counted."""
        self.flush_probes()  # slot ids remap at compaction: judge first
        try:
            return self._live_index().compact(mode)
        except chaos_lib.CompactFault:
            self._count_fault("faults")
            raise

    def snapshot(self, path: str) -> str:
        """Persist the serving index with ``core/store``; the written
        snapshot is sha256-verified before this returns."""
        from repro_torch.core import store as store_lib

        out = store_lib.save(self.index, path)
        try:
            store_lib.verify(path)
        except store_lib.SnapshotCorruption:
            self._count_fault("snapshot_corrupt")
            raise
        return out

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Operator view: latency percentiles over the rolling window plus
        lifetime totals, health and fault counters, segment composition of
        a live index, and the telemetry tree while telemetry is enabled."""
        with self._state_lock:
            out = {
                "engine": self.engine,
                "shards": self.shards,
                "live": self.live,
                "quant": self.quant,
                "queries": self._queries,
                "batches": self._batches,
                "window_batches": len(self._lat),
                "memory_bytes": self.index.memory_bytes(),
                "build_s": round(self.build_s, 3),
                "health": self.health,
            }
            if self._dead_shards:
                out["dead_shards"] = sorted(self._dead_shards)
            if any(self.fault_counters.values()):
                out["faults"] = dict(self.fault_counters)
        if self.chaos is not None:
            out["chaos"] = self.chaos.stats()
        if self._probe is not None:
            self.flush_probes()  # quality block reflects every recorded query
            out["quality"] = self._probe.stats()
        qstore = getattr(self.index, "quant", None)
        if qstore is not None:
            out["quant_bytes"] = qstore.memory_bytes()
        if len(self._lat):
            lat_s, nq = self._lat.window()
            lat_ms = lat_s * 1e3
            out.update(
                p50_ms=float(np.percentile(lat_ms, 50)),
                p99_ms=float(np.percentile(lat_ms, 99)),
                qps=float(np.sum(nq) / np.sum(lat_s)),
            )
        if telem.enabled():
            out["telemetry"] = telem.summary()
        if self.live:
            seg = self.index.stats()
            out.update({key: seg[key] for key in (
                "generation", "frozen_size", "delta_fill", "delta_cap", "tombstones",
                "deleted_frac", "n_alive", "compactions")})
        return out

    def metrics_text(self) -> str:
        """The telemetry registry in Prometheus text exposition format."""
        return telem.metrics_text()

    def dump_trace(self, path: str) -> str:
        """Write the telemetry trace ring as Chrome/Perfetto JSON."""
        return telem.dump_trace(path)

    def serve(self, batches, k: int = 10, *, budget: Optional[int] = None,
              filter: Optional[dict] = None,
              deadline_ms: Optional[float] = None) -> dict:
        """Drain a queue of query batches; returns latency/throughput stats.
        One warm-up query runs per distinct padded bucket, outside the
        record and without the deadline."""
        batches = list(batches)
        if not batches:
            raise ValueError("serve() needs at least one query batch")
        seen = set()
        for qb in batches:
            b = _bucket(len(qb))
            if b not in seen:
                seen.add(b)
                self.query(qb, k=k, budget=budget, filter=filter, record=False)
        lat, comps, n_q = [], [], 0
        n_degraded = n_missed = n_retries = 0
        for qb in batches:
            t0 = time.perf_counter()
            res = self.query(qb, k=k, budget=budget, filter=filter,
                             deadline_ms=deadline_ms)
            lat.append(time.perf_counter() - t0)
            comps.append(float(res.comparisons.mean()))
            n_q += res.idx.shape[0]
            n_degraded += int(res.degraded)
            n_missed += int(not res.deadline_met)
            n_retries += res.retries
        lat_ms = np.asarray(lat) * 1e3
        out = {
            "engine": self.engine,
            "shards": self.shards,
            "k": k,
            "batches": len(batches),
            "queries": n_q,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "qps": float(n_q / np.sum(lat)),
            "mean_comparisons": float(np.mean(comps)),
            "memory_bytes": self.index.memory_bytes(),
            "build_s": round(self.build_s, 3),
        }
        if deadline_ms is not None or n_degraded or n_retries:
            out.update(deadline_ms=deadline_ms, degraded_batches=n_degraded,
                       deadline_misses=n_missed, retries=n_retries,
                       health=self.health)
        return out


def default_cfg(engine: str, *, budget: Optional[int], rerank: Optional[int],
                train_steps: int = 600, proj_sample: int = 1000) -> dict:
    """Engine-appropriate serving defaults from the shared CLI knobs."""
    cfg: dict = {}
    if engine == "infinity":
        cfg.update(q=math.inf, proj_sample=proj_sample, train_steps=train_steps)
        if rerank is not None:
            cfg["rerank"] = rerank
    elif engine == "ivf_pq" and rerank is not None:
        cfg["rerank"] = rerank
    if budget is not None:
        cfg["budget"] = budget
    return cfg


def demo_attrs(n: int, seed: int = 0) -> dict:
    """Deterministic attribute columns for the synthetic serving corpus:
    ``category`` (c0..c7 round-robin) and ``score`` (uniform [0, 1))."""
    rng = np.random.default_rng(seed)
    return {
        "category": [f"c{i % 8}" for i in range(n)],
        "score": rng.uniform(0.0, 1.0, size=n).astype(np.float32),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    engines = [k for k in index_lib.BUILTIN if k not in ("sharded", "live")]
    ap.add_argument("--engine", default="infinity", help=f"one of {', '.join(engines)}")
    ap.add_argument("--list-engines", action="store_true",
                    help="print every registered engine key with a one-line "
                         "summary, then exit")
    ap.add_argument("--shards", type=int, default=1,
                    help="row-shard the corpus into this many shards (all on "
                         "the one device)")
    ap.add_argument("--budget", type=int, default=256,
                    help="per-query comparison budget (engine-interpreted)")
    ap.add_argument("--rerank", type=int, default=96,
                    help="two-stage rerank width (infinity / ivf_pq)")
    ap.add_argument("--live", action="store_true",
                    help="mutable serving: upsert/delete/compact on top of the engine")
    ap.add_argument("--quant", action="store_true",
                    help="int8 corpus codes: scan engines read 1 byte/dim "
                         "on the first pass and exactly rerank in f32")
    ap.add_argument("--delta-cap", type=int, default=1024,
                    help="live delta-buffer capacity (compaction trigger)")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="restore the index from PATH if present, else save there after the run")
    ap.add_argument("--filter", default=None, metavar="JSON",
                    help="predicate for the smoke run, e.g. "
                         '\'{"category": {"isin": ["c0", "c1"]}, '
                         '"score": {"range": [0.0, 0.5]}}\' — evaluated '
                         "against the demo attribute columns")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: the controller shrinks the "
                         "comparison budget as it drains and retries "
                         "transient faults with capped backoff")
    ap.add_argument("--chaos", default=None, metavar="JSON",
                    help="arm a deterministic core/chaos FaultPlan, e.g. "
                         '\'{"seed": 0, "rules": [{"site": "search", '
                         '"kind": "latency", "rate": 0.1, "ms": 20}]}\'')
    ap.add_argument("--probe-rate", type=float, default=0.0,
                    help="shadow this fraction of queries through the exact "
                         "scan: online recall estimate + Wilson interval")
    ap.add_argument("--probe-slo", type=float, default=None,
                    help="recall SLO floor: a sustained probe estimate "
                         "below it walks health to DEGRADED")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.list_engines:
        for name, summary in index_lib.list_engines().items():
            print(f"{name:10s} {summary}")
        return

    flt = json.loads(args.filter) if args.filter else None
    X = synthetic.make("manifold", args.n + args.queries, seed=0)
    if args.snapshot and os.path.exists(os.path.join(args.snapshot, "meta.json")):
        server = SearchServer.restore(args.snapshot, device=args.device)
        print(f"restored {server.engine} index from {args.snapshot}")
        if flt and getattr(server.index, "attrs", None) is None:
            # attach the demo columns where that is well-defined: a frozen
            # index whose corpus rows ARE the index rows
            if server.live:
                raise SystemExit(
                    "--filter needs attribute columns, but this snapshot "
                    "was saved without them and they cannot be rebuilt "
                    "for a live index; re-save it with --filter"
                )
            from repro_torch.core import attrs as attrs_lib

            n = int(server.corpus.shape[0])
            index_lib.attach_store(server.index,
                                   attrs_lib.AttributeStore.build(demo_attrs(n), n))
    else:
        server = SearchServer(
            X[: args.n], engine=args.engine, shards=args.shards,
            cfg=default_cfg(args.engine, budget=args.budget, rerank=args.rerank),
            live=args.live, delta_cap=args.delta_cap,
            attrs=demo_attrs(args.n) if flt else None, quant=args.quant,
            chaos=json.loads(args.chaos) if args.chaos else None,
            probe=None if args.probe_rate <= 0 else {
                "rate": args.probe_rate,
                **({"slo_floor": args.probe_slo}
                   if args.probe_slo is not None else {}),
            },
            device=args.device,
        )
    queries = X[args.n:]
    batches = [queries[i : i + args.batch] for i in range(0, len(queries), args.batch)]
    stats = server.serve(batches, k=args.k, budget=args.budget, filter=flt,
                         deadline_ms=args.deadline_ms)
    print(
        f"engine={stats['engine']} shards={stats['shards']} corpus={args.n} "
        f"build={stats['build_s']}s"
        + (" quant=int8" if args.quant else "")
        + (f" filter={args.filter}" if flt else "")
    )
    print(
        f"  {stats['queries']} queries: p50={stats['p50_ms']:.1f}ms "
        f"p99={stats['p99_ms']:.1f}ms qps={stats['qps']:.0f} "
        f"comps/query={stats['mean_comparisons']:.0f}"
    )
    if args.probe_rate > 0:
        qual = server.stats().get("quality", {})
        print(
            f"  quality: probed={qual.get('probed', 0)}/{qual.get('seen', 0)} "
            f"recall~{qual.get('recall_estimate', 0):.3f} "
            f"[{qual.get('ci_low', 0):.3f}, {qual.get('ci_high', 1):.3f}]"
            + (f" slo_floor={args.probe_slo} breached={qual.get('breached')}"
               if args.probe_slo is not None else "")
        )
    if args.deadline_ms is not None or args.chaos:
        print(
            f"  fault: health={server.health} "
            f"degraded={stats.get('degraded_batches', 0)} "
            f"misses={stats.get('deadline_misses', 0)} "
            f"retries={stats.get('retries', 0)}"
            + (f" injected={server.chaos.stats()['injected']}"
               if server.chaos else "")
        )
    if server.live:
        # mutation demo: a churn burst, then the operator's composition view
        rng = np.random.default_rng(1)
        ins = rng.normal(size=(args.batch, X.shape[1])).astype(np.float32)
        new_ids = server.upsert(ins)
        server.delete(new_ids[: args.batch // 4])
        server.query(queries[: args.batch], k=args.k, budget=args.budget)
        s = server.stats()
        print(
            f"  live: gen={s['generation']} frozen={s['frozen_size']} "
            f"delta={s['delta_fill']}/{s['delta_cap']} "
            f"tombstones={s['tombstones']} alive={s['n_alive']} "
            f"compactions={s['compactions']}"
        )
    if args.snapshot and not os.path.exists(os.path.join(args.snapshot, "meta.json")):
        print(f"snapshot -> {server.snapshot(args.snapshot)}")


if __name__ == "__main__":
    main()
