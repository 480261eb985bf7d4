"""Fault-tolerance supervisor — ``repro/train/fault.py``, copied (this
package imports nothing of ``repro``).

The train loop runs under a ``Supervisor`` that implements the policies a
1000-node deployment needs; on one host the failure signals are injected
by tests / the launcher, but the state machine is the production one:

  * step deadline (straggler detection) — a step exceeding
    ``deadline_factor x`` the trailing-median step time is flagged; after
    ``max_stragglers`` consecutive flags the supervisor requests a restart
    (on a real fleet: reschedule the slow host, restore, continue).
  * NaN/Inf guard — a non-finite loss or gradient norm skips the update
    (the step function receives a zero-scaled gradient) and after
    ``max_nan_skips`` consecutive skips restores from the last checkpoint.
  * elastic re-mesh — on pod loss, ``ElasticPlan.shrink`` yields the
    next-smaller mesh (2x16x16 -> 16x16) and the restore path re-shards the
    checkpoint onto it (in JAX, checkpoint.restore with new shardings; the
    port restores onto one device).

The deadline/trip arithmetic lives in ``core/backoff`` (shared with the
serving controller in ``launch/serve.py``): the trailing-
median straggler threshold is ``backoff.median_deadline`` and both
consecutive-failure trips are ``backoff.RunCounter``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import backoff as backoff_lib


@dataclasses.dataclass
class SupervisorConfig:
    deadline_factor: float = 3.0
    window: int = 32
    max_stragglers: int = 3
    max_nan_skips: int = 3


class Supervisor:
    def __init__(self, cfg: SupervisorConfig = SupervisorConfig()):
        self.cfg = cfg
        self.step_times: list[float] = []
        self._stragglers = backoff_lib.RunCounter(cfg.max_stragglers)
        self._nans = backoff_lib.RunCounter(cfg.max_nan_skips)
        self.restarts = 0

    # the run lengths stay public — the launcher's log lines read them
    @property
    def straggler_run(self) -> int:
        return self._stragglers.run

    @property
    def nan_run(self) -> int:
        return self._nans.run

    # --- straggler detection -------------------------------------------------
    def observe_step_time(self, seconds: float) -> str:
        """Returns 'ok' | 'straggler' | 'restart'."""
        hist = self.step_times[-self.cfg.window :]
        self.step_times.append(seconds)
        deadline = backoff_lib.median_deadline(
            hist, factor=self.cfg.deadline_factor)
        if deadline is None:  # too few samples to call anything slow
            return "ok"
        slow = seconds > deadline
        if self._stragglers.observe(slow):
            self.restarts += 1
            return "restart"
        return "straggler" if slow else "ok"

    # --- NaN guard ------------------------------------------------------------
    def observe_loss(self, loss: float) -> str:
        """Returns 'ok' | 'skip' | 'restore'."""
        bad = not np.isfinite(loss)
        if self._nans.observe(bad):
            self.restarts += 1
            return "restore"
        return "skip" if bad else "ok"


@dataclasses.dataclass
class ElasticPlan:
    """Mesh downgrade ladder for pod loss."""

    ladder: tuple = ((2, 16, 16), (16, 16))
    level: int = 0

    def current_shape(self):
        return self.ladder[self.level]

    def shrink(self):
        if self.level + 1 >= len(self.ladder):
            raise RuntimeError("no smaller mesh available — abort")
        self.level += 1
        return self.ladder[self.level]


class Heartbeat:
    """Deadline-based liveness check for host processes (the launcher pings
    it from the data-loading and checkpoint threads)."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self._last: dict[str, float] = {}

    def ping(self, name: str) -> None:
        self._last[name] = time.monotonic()

    def dead(self) -> list[str]:
        now = time.monotonic()
        return [k for k, t in self._last.items() if now - t > self.timeout_s]
