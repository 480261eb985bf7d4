"""Deterministic fault injection for the serving stack — a copy of
``repro.core.chaos`` (pure Python): the same plan fires the same sites on
the same call numbers in both packages, bit for bit.

A ``FaultPlan`` scripts failures so tests and ``benchmarks/bench_fault.py``
can reproduce them byte-for-byte: every draw is a pure function of
``(seed, site, rule, per-site call number)`` — no global RNG, no wall
clock — so the same plan against the same call sequence injects the same
faults on every run.

The plan reaches an engine through the reserved registry cfg key
``chaos`` (``index.build`` pops it, like ``attrs`` / ``quant``): plain
engines get their ``search`` wrapped with the generic latency/transient
injector; ``ShardedIndex`` and ``LiveIndex`` hold the plan and consult it
at their own fault sites (per-shard death, compaction publish, delta
overflow).  ``core/store.save`` consults the engine's plan to corrupt a
just-written snapshot (bit-flip / truncation / member drop) — what the
sha256 manifest added in DESIGN.md §14 must catch on restore.

Sites and what fires there:

==========  ===============================================================
``search``  every ``search()`` entry — ``latency`` rules sleep ``ms``,
            ``error`` rules raise ``TransientFault``
``shard``   ``ShardedIndex.search`` — rules (or ``kill_shard``) mark shard
            ids dead; searching a dead, non-excluded shard raises
            ``ShardFault(shard)``
``build``   ``index.build`` after construction — raises ``BuildFault``
            (a poisoned build: the instance never escapes)
``compact`` ``LiveIndex.compact`` just before the atomic publish — raises
            ``CompactFault`` (all rebuild work done, crash before the swap)
``delta``   ``LiveIndex.upsert`` entry — raises ``DeltaOverflow``
``snapshot``  ``core/store.save`` after the commit — corrupts the arrays
            member on disk (``mode``: bitflip / truncate / drop)
``slow_search``  the async runtime's per-batch dispatch
            (``launch/runtime.py``, DESIGN.md §18) — ``latency`` rules
            sleep ``ms`` *inside* the dispatch window (deadline misses
            accrue, the circuit breaker's trip condition), ``error``
            rules raise ``TransientFault`` at the runtime level.  Kept
            separate from ``search`` so overload experiments slow the
            serving path without also arming the engine-level injector.
==========  ===============================================================

Rules fire by probability (``rate``, an independent deterministic draw per
call) or by window (``start``/``stop`` in per-site call numbers — dead /
firing while ``start <= callno < stop``).  ``kill_shard`` / ``revive_shard``
are imperative toggles for tests that want exact control mid-run.

Every injected fault ticks ``plan.counters`` (by ``site:kind``) so the
serving layer can surface injection totals next to its own retry/recovery
counters in ``stats()``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
import time
from typing import Optional


class FaultError(RuntimeError):
    """Base of every injected fault — catch this to catch chaos."""


class TransientFault(FaultError):
    """Whole-engine failure expected to pass on retry (rate-based draws
    redraw per call; window-based ones clear when the window ends)."""


class ShardFault(FaultError):
    """One shard of a ``ShardedIndex`` failed; ``shard`` names it so the
    serving controller can mask it out and answer from the survivors."""

    def __init__(self, shard: int, *, n_shards: int):
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        super().__init__(f"injected: shard {shard}/{n_shards} is down")


class BuildFault(FaultError):
    """Index construction was poisoned — the instance never escaped."""


class CompactFault(FaultError):
    """Compaction died after the rebuild, before the atomic publish."""


class DeltaOverflow(FaultError):
    """The delta buffer rejected a write (simulated exhaustion)."""


@dataclasses.dataclass
class Rule:
    """One scripted fault source; see the module table for sites/kinds."""

    site: str  # search | shard | build | compact | delta | snapshot | slow_search
    kind: str = "error"  # "error" | "latency" (search/slow_search) | ignored for snapshot
    rate: float = 0.0  # per-call firing probability (deterministic draw)
    start: Optional[int] = None  # with stop: fire while start <= callno < stop
    stop: Optional[int] = None
    shard: Optional[int] = None  # site="shard": which shard dies (None = drawn per shard)
    ms: float = 0.0  # kind="latency": injected spike
    mode: str = "bitflip"  # site="snapshot": bitflip | truncate | drop

    _SITES = ("search", "shard", "build", "compact", "delta", "snapshot",
              "slow_search")

    def __post_init__(self):
        if self.site not in self._SITES:
            raise ValueError(f"chaos rule: unknown site {self.site!r} "
                             f"(one of {self._SITES})")
        if self.rate == 0.0 and self.start is None:
            raise ValueError(
                f"chaos rule on {self.site!r} never fires: give a rate or a "
                "[start, stop) window")


def _draw(seed: int, site: str, rule_no: int, callno: int, extra: int = 0) -> float:
    """Uniform [0, 1) from a stable hash — the deterministic coin flip."""
    key = f"{seed}:{site}:{rule_no}:{callno}:{extra}".encode()
    h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big")
    return h / 2.0 ** 64


class FaultPlan:
    """A seeded, scriptable schedule of failures (see module docstring).

    Construct with ``Rule`` instances or their dict sugar::

        FaultPlan(seed=0, rules=[
            {"site": "search", "kind": "latency", "rate": 0.1, "ms": 20},
            {"site": "shard", "shard": 1, "start": 4, "stop": 12},
            {"site": "snapshot", "rate": 1.0, "mode": "truncate"},
        ])

    The plan is stateful only in its per-site call counters (and the
    imperative ``kill_shard`` set) — two plans with equal seed/rules fed
    the same call sequence inject identically.
    """

    def __init__(self, seed: int = 0, rules=(), sleep=time.sleep):
        self.seed = int(seed)
        self.rules = [r if isinstance(r, Rule) else Rule(**r) for r in rules]
        self.calls: collections.Counter = collections.Counter()
        self.counters: collections.Counter = collections.Counter()
        self._killed: set[int] = set()
        self._sleep = sleep  # injectable for tests that must not wait
        # the async runtime (DESIGN.md §18) consults the plan from ingress
        # worker threads concurrently with the dispatch thread: per-site
        # call numbers and injection counters must not lose increments
        # (Counter += is a read-modify-write)
        self._lock = threading.Lock()

    @classmethod
    def from_cfg(cls, spec) -> "FaultPlan":
        """The reserved-cfg-key entry point: pass a built plan through, or
        build one from ``{"seed": ..., "rules": [...]}``."""
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"chaos cfg must be a FaultPlan or a dict, got {type(spec).__name__}"
        )

    # ------------------------------------------------------------- internals
    def _tick(self, site: str) -> int:
        with self._lock:
            callno = self.calls[site]
            self.calls[site] += 1
            return callno

    def _fires(self, rule: Rule, rule_no: int, callno: int, extra: int = 0) -> bool:
        if rule.start is not None:
            stop = rule.stop if rule.stop is not None else float("inf")
            if rule.start <= callno < stop:
                return True
        if rule.rate > 0.0:
            return _draw(self.seed, rule.site, rule_no, callno, extra) < rule.rate
        return False

    def _count(self, rule: Rule) -> None:
        with self._lock:
            self.counters[f"{rule.site}:{rule.kind}"] += 1

    def _search_like(self, site: str) -> None:
        """Shared latency/transient injector for the per-call sites."""
        callno = self._tick(site)
        for i, rule in enumerate(self.rules):
            if rule.site != site or not self._fires(rule, i, callno):
                continue
            self._count(rule)
            if rule.kind == "latency":
                self._sleep(rule.ms / 1e3)
            else:
                raise TransientFault(
                    f"injected: {site} call {callno} failed")

    # ----------------------------------------------------------- fault sites
    def on_search(self) -> None:
        """Per-call latency spikes and transient whole-engine failures."""
        self._search_like("search")

    def on_slow_search(self) -> None:
        """The async runtime's dispatch-level site (DESIGN.md §18):
        ``latency`` rules stretch the dispatch window (stacking deadline
        misses — the breaker's trip fuel), ``error`` rules fail the whole
        batch at the runtime level.  Separate call counter from ``search``
        so engine-level and runtime-level scripts compose independently."""
        self._search_like("slow_search")

    def dead_shards(self, n_shards: int) -> set[int]:
        """Shard ids dead for THIS call (ticks the ``shard`` site once)."""
        callno = self._tick("shard")
        dead = set(self._killed)
        for i, rule in enumerate(self.rules):
            if rule.site != "shard":
                continue
            if rule.shard is not None:
                if self._fires(rule, i, callno):
                    dead.add(rule.shard % n_shards)
            else:  # independent draw per shard
                for s in range(n_shards):
                    if self._fires(rule, i, callno, extra=s):
                        dead.add(s)
        with self._lock:
            self.counters["shard:down"] += len(dead)
        return dead

    def kill_shard(self, shard: int) -> None:
        """Imperative kill: the shard stays dead until ``revive_shard``."""
        self._killed.add(int(shard))

    def revive_shard(self, shard: int) -> None:
        self._killed.discard(int(shard))

    def on_build(self) -> None:
        callno = self._tick("build")
        for i, rule in enumerate(self.rules):
            if rule.site == "build" and self._fires(rule, i, callno):
                self._count(rule)
                raise BuildFault(f"injected: build {callno} poisoned")

    def on_compact(self) -> None:
        callno = self._tick("compact")
        for i, rule in enumerate(self.rules):
            if rule.site == "compact" and self._fires(rule, i, callno):
                self._count(rule)
                raise CompactFault(
                    f"injected: compaction {callno} died before publish")

    def on_delta(self) -> None:
        callno = self._tick("delta")
        for i, rule in enumerate(self.rules):
            if rule.site == "delta" and self._fires(rule, i, callno):
                self._count(rule)
                raise DeltaOverflow(
                    f"injected: delta buffer overflow at upsert {callno}")

    # ------------------------------------------------------ snapshot corruption
    def corrupt_snapshot(self, path: str, arrays_file: str) -> Optional[str]:
        """Called by ``core/store.save`` after the commit: corrupt the
        arrays member per the first firing ``snapshot`` rule.  Returns the
        mode applied (None = clean save)."""
        callno = self._tick("snapshot")
        for i, rule in enumerate(self.rules):
            if rule.site == "snapshot" and self._fires(rule, i, callno):
                with self._lock:
                    self.counters[f"snapshot:{rule.mode}"] += 1
                corrupt_snapshot(path, arrays_file=arrays_file,
                                 mode=rule.mode, seed=self.seed + callno)
                return rule.mode
        return None

    # -------------------------------------------------------------- reporting
    def stats(self) -> dict:
        """Injected-fault totals by ``site:kind`` plus per-site call counts —
        what ``SearchServer.stats()`` surfaces under ``chaos``."""
        with self._lock:
            return {
                "injected": dict(self.counters),
                "calls": dict(self.calls),
                "killed_shards": sorted(self._killed),
            }


def corrupt_snapshot(
    path: str, *, arrays_file: Optional[str] = None, mode: str = "bitflip",
    seed: int = 0,
) -> str:
    """Deterministically damage a ``core/store`` snapshot on disk — the
    direct test harness (the plan-driven path calls this too).

    ``mode``: ``bitflip`` XORs one byte at a seed-derived offset,
    ``truncate`` halves the file, ``drop`` unlinks it.  Returns the path of
    the member damaged.
    """
    if arrays_file is None:
        import json

        with open(os.path.join(path, "meta.json")) as f:
            arrays_file = json.load(f)["arrays"]
    member = os.path.join(path, arrays_file)
    if mode == "drop":
        os.unlink(member)
        return member
    size = os.path.getsize(member)
    if mode == "truncate":
        with open(member, "r+b") as f:
            f.truncate(size // 2)
        return member
    if mode == "bitflip":
        # keep clear of the npz central directory tail so the zip still
        # opens — the sha256 manifest, not zipfile, must be the detector
        off = int(_draw(seed, "corrupt", 0, 0) * max(1, size // 2))
        with open(member, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0xFF]))
        return member
    raise ValueError(f"corrupt_snapshot: unknown mode {mode!r}")
