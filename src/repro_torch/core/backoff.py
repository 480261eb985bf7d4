"""Shared backoff / deadline arithmetic — a copy of ``repro.core.backoff``
(numpy only).

One implementation of the retry-and-deadline primitives that two very
different loops need: the training supervisor (``train/fault.py`` — step
deadlines from a trailing median, consecutive-failure trips) and the
serving controller (``launch/serve.py`` — per-request deadlines, capped
exponential retry backoff, deadline→budget degradation).  Keeping the
arithmetic here means a fix to e.g. the trip-counter reset semantics lands
in both state machines at once.

* ``Deadline``        — a per-request countdown: remaining time, expiry,
  and the remaining *fraction* the degradation ladder keys off.
* ``backoff_s``       — capped exponential backoff (attempt -> seconds).
* ``RunCounter``      — consecutive-event counter that trips (and resets)
  at a threshold — the straggler / NaN-run logic of the supervisor.
* ``median_deadline`` — trailing-median × factor straggler threshold.
* ``degraded_budget`` — remaining-deadline fraction -> comparison budget,
  on a power-of-two halving ladder so a shrinking budget stays a bounded
  search-key dimension (the same pow2 discipline as ``core/scan.pow2ceil``).
* ``CircuitBreaker``  — CLOSED/OPEN/HALF_OPEN state machine over a
  ``RunCounter``: consecutive dispatch failures trip it open, a cooldown
  later one half-open probe decides whether the engine is healthy again
  (DESIGN.md §18 — the overload runtime's fast-fail guard).
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np


class Deadline:
    """Countdown from ``ms`` milliseconds at construction (monotonic clock).

    ``ms=None`` means "no deadline": ``remaining_ms`` is +inf,
    ``fraction_left`` is 1.0 and ``expired`` is never True — callers can
    thread one object through unconditionally.
    """

    def __init__(self, ms: Optional[float] = None):
        self.ms = None if ms is None else float(ms)
        self._t0 = time.monotonic()

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    def remaining_ms(self) -> float:
        if self.ms is None:
            return float("inf")
        return self.ms - self.elapsed_ms()

    def expired(self) -> bool:
        return self.remaining_ms() <= 0.0

    def fraction_left(self) -> float:
        """Remaining budget as a fraction of the original deadline, clamped
        to [0, 1] — what the degradation ladder keys off."""
        if self.ms is None:
            return 1.0
        if self.ms <= 0:
            return 0.0
        return max(0.0, min(1.0, self.remaining_ms() / self.ms))


def backoff_s(
    attempt: int, *, base_s: float = 0.005, cap_s: float = 0.1,
    factor: float = 2.0,
) -> float:
    """Capped exponential backoff: ``base * factor**attempt``, never above
    ``cap_s``.  attempt counts from 0 (first retry sleeps ``base_s``)."""
    try:
        v = base_s * (factor ** max(0, int(attempt)))
    except OverflowError:  # huge attempt counts: the cap is the answer
        return float(cap_s)
    return float(min(cap_s, v))


class RunCounter:
    """Counts consecutive events and trips at a threshold.

    ``observe(True)`` increments the run and returns True exactly when the
    run reaches ``trip`` (the run resets on a trip — the supervisor's
    "after N consecutive flags, restart then start counting afresh").
    ``observe(False)`` resets the run.
    """

    def __init__(self, trip: int):
        self.trip = int(trip)
        self.run = 0

    def observe(self, event: bool) -> bool:
        if not event:
            self.run = 0
            return False
        self.run += 1
        if self.run >= self.trip:
            self.run = 0
            return True
        return False


def median_deadline(
    history: Sequence[float], *, factor: float, min_samples: int = 5,
) -> Optional[float]:
    """Trailing-median straggler threshold: ``factor × median(history)``,
    or None while fewer than ``min_samples`` observations exist (too little
    signal to call anything slow)."""
    if len(history) < min_samples:
        return None
    return float(factor) * float(np.median(np.asarray(history)))


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN breaker around a dispatch site
    (DESIGN.md §18).

    Failures feed a ``RunCounter``: ``trip`` *consecutive* failures open
    the breaker (one success resets the run — the supervisor's semantics,
    shared so a fix lands in both machines).  While OPEN, ``allow()`` is
    False and callers fast-fail (shed with an explicit outcome) instead of
    queueing work onto a sick engine.  After ``cooldown_s`` the next
    ``allow()`` admits exactly ONE half-open probe; ``record(True)`` on
    that probe closes the breaker, ``record(False)`` re-opens it with the
    cooldown doubled (capped at ``cooldown_cap_s``) — capped exponential,
    same shape as ``backoff_s``.

    ``clock`` is injectable so tests drive the cooldown without sleeping.
    All transitions run under a lock: ``allow()`` is called from every
    submitting thread, ``record()`` from the dispatch thread.
    """

    CLOSED, HALF_OPEN, OPEN = "CLOSED", "HALF_OPEN", "OPEN"
    #: numeric encoding for the ``breaker_state`` gauge (0 healthy,
    #: 2 tripped — alert thresholds read "higher is worse")
    STATE_CODE = {"CLOSED": 0, "HALF_OPEN": 1, "OPEN": 2}

    def __init__(self, trip: int = 5, cooldown_s: float = 0.5, *,
                 cooldown_cap_s: float = 30.0, factor: float = 2.0,
                 clock=time.monotonic):
        self.counter = RunCounter(trip)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.factor = float(factor)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.trips = 0  # lifetime open transitions
        self._opened_at: Optional[float] = None
        self._open_round = 0  # consecutive re-opens (cooldown exponent)
        self._probe_inflight = False

    def _cooldown(self) -> float:
        return min(self.cooldown_cap_s,
                   self.cooldown_s * self.factor ** self._open_round)

    def allow(self) -> bool:
        """May a dispatch proceed right now?  OPEN past its cooldown
        transitions to HALF_OPEN and admits exactly one probe."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._clock() - self._opened_at < self._cooldown():
                    return False
                self.state = self.HALF_OPEN
                self._probe_inflight = True
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record(self, ok: bool) -> bool:
        """Feed one dispatch outcome; returns True when this call tripped
        the breaker open (callers count ``breaker_trips_total`` off it)."""
        with self._lock:
            if ok:
                if self.state != self.CLOSED:
                    self.state = self.CLOSED
                    self._open_round = 0
                self._probe_inflight = False
                self.counter.observe(False)
                return False
            if self.state == self.HALF_OPEN:
                # the probe failed: straight back to OPEN, cooldown doubled
                self._probe_inflight = False
                self._open_round += 1
                self._open(self._clock())
                return True
            if self.state == self.OPEN:
                return False  # late failures while already open: no-op
            if self.counter.observe(True):
                self._open(self._clock())
                return True
            return False

    def _open(self, now: float) -> None:
        self.state = self.OPEN
        self._opened_at = now
        self.trips += 1
        self.counter.run = 0

    def retry_after_s(self) -> float:
        """Client backoff hint: remaining cooldown when OPEN, else 0."""
        with self._lock:
            if self.state != self.OPEN:
                return 0.0
            return max(0.0, self._cooldown()
                       - (self._clock() - self._opened_at))

    def state_code(self) -> int:
        return self.STATE_CODE[self.state]


def degraded_budget(
    budget: Optional[int], frac: float, *, floor: int = 8,
) -> Optional[int]:
    """Map the remaining-deadline fraction to a comparison budget.

    Full budget while more than half the deadline remains; every further
    halving of the remaining fraction halves the budget, floored at
    ``floor``.  The ladder is powers of two of the base budget, so a
    deadline-pressured engine sees at most O(log budget) distinct budgets — the same bounded-recompilation
    discipline as ``core/scan.pow2ceil`` (DESIGN.md §14: this is the
    anytime knob — the paper's comparison bound traded against recall
    along the measured curve).
    """
    if budget is None:
        return None
    b, f = int(budget), float(frac)
    while f < 0.5 and b > floor:
        b = max(int(floor), b // 2)
        f *= 2.0
    return max(int(floor), b)
