"""Online recall probes: sampled ground-truth shadowing of live traffic —
a copy of the numpy parts of ``repro.core.probes``; the ground truth the
server feeds back comes from the port's ``core/scan.topk_scan``.

The serving stack measures latency everywhere but was blind on the axis
the paper actually trades it against: recall.  A ``RecallProbe`` shadows a
configurable fraction (default 1%) of ``SearchServer.query`` traffic
through the exact fused brute-force path (``core/scan.topk_scan``, the
same oracle the benchmarks use) and maintains a sliding-window recall@k
estimate with a Wilson score confidence interval.

Design points:

* **Deterministic sampling.**  Whether query ordinal ``i`` is probed is a
  pure function of ``(seed, i)`` — a blake2b draw, the ``core/chaos``
  idiom — so the same seed over the same traffic stream reproduces the
  same probe set across restarts (tested).  The ordinal counter advances
  per served query whether or not it samples.
* **Observe-only.**  Probing never touches the served answer: the server
  records its latency first, then hands the (already returned-shape)
  result rows to the probe.  Sampled queries are buffered and ground
  truth runs in fixed-size pow2 flushes, so the shadow path compiles
  O(log) programs and amortizes to ~``rate`` of serving compute.
* **Right sub-corpus.**  Ground truth is filter- and tombstone-aware:
  filtered queries are judged against the predicate-passing rows only,
  live answers against the alive logical corpus (served slot ids mapped
  through ``slot_to_logical``), sharded answers against the full held
  corpus — the same id space each engine answers in.
* **SLO floor.**  With ``slo_floor`` set, a *sustained* breach — the
  Wilson upper bound falling below the floor with at least
  ``slo_min_samples`` probed queries in the window — reports ``"breach"``
  so the server can walk its health machine to DEGRADED and count
  ``quality_degraded_total``; recovery reports when the estimate climbs
  back over the floor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional

import numpy as np

#: 95% two-sided normal quantile — the default Wilson interval width.
Z_95 = 1.959963984540054


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Knobs for ``RecallProbe`` (``SearchServer(probe=...)`` sugar:
    a float is ``rate``, a dict is keyword arguments)."""

    rate: float = 0.01          # fraction of served queries shadowed
    k: int = 10                 # recall@k depth (capped by the request's k)
    window: int = 2048          # probed queries in the sliding window
    seed: int = 0               # sampling stream seed
    flush_at: int = 32          # buffered queries per ground-truth flush
                                # (small flushes pay launch overhead out
                                # of proportion to their compute)
    slo_floor: Optional[float] = None   # sustained-recall floor (None = off)
    slo_min_samples: int = 64   # window occupancy before the floor arms
    z: float = Z_95             # confidence-interval quantile

    def __post_init__(self):
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"probe rate {self.rate} not in [0, 1]")
        if self.slo_floor is not None and not (0.0 < self.slo_floor <= 1.0):
            raise ValueError(f"slo_floor {self.slo_floor} not in (0, 1]")

    @classmethod
    def from_cfg(cls, cfg) -> "ProbeConfig":
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, (int, float)) and not isinstance(cfg, bool):
            return cls(rate=float(cfg))
        if isinstance(cfg, dict):
            return cls(**cfg)
        raise TypeError(f"probe config: float rate, dict or ProbeConfig, "
                        f"got {type(cfg).__name__}")


#: ordinals per blake2b call — one 64-byte digest yields 8 eight-byte
#: draws, so sampling a serving batch costs B/8 hashes, not B (the
#: sampler runs on every recorded batch; measured at ~25us/64 queries)
_BLOCK = 8


def _block_draws(seed: int, block: int) -> np.ndarray:
    key = f"probe:{seed}:{block}".encode()
    d = hashlib.blake2b(key, digest_size=8 * _BLOCK).digest()
    return np.frombuffer(d, dtype=">u8").astype(np.float64) / 2.0 ** 64


def sample_draw(seed: int, ordinal: int) -> float:
    """Uniform [0, 1) from a stable hash of (seed, query ordinal) — the
    deterministic coin flip (the ``core/chaos`` idiom).  Pure: the same
    (seed, ordinal) draws the same number in any process, ever."""
    return float(_block_draws(seed, ordinal // _BLOCK)[ordinal % _BLOCK])


def draws_range(seed: int, start: int, count: int) -> np.ndarray:
    """(count,) float64 draws for ordinals [start, start+count): the
    vectorized form of ``sample_draw`` — one joined digest buffer and a
    single frombuffer, so bulk draws cost ~B/8 hashes plus one numpy op
    (the per-ordinal loop form cost ~10x this)."""
    if count <= 0:
        return np.zeros((0,), np.float64)
    b0 = start // _BLOCK
    b1 = (start + count - 1) // _BLOCK
    buf = b"".join(
        hashlib.blake2b(f"probe:{seed}:{b}".encode(),
                        digest_size=8 * _BLOCK).digest()
        for b in range(b0, b1 + 1)
    )
    draws = np.frombuffer(buf, dtype=">u8").astype(np.float64) / 2.0 ** 64
    off = start - b0 * _BLOCK
    return draws[off:off + count]


def sampled_mask(seed: int, rate: float, start: int, count: int) -> np.ndarray:
    """(count,) bool — which of query ordinals [start, start+count) sample."""
    return draws_range(seed, start, count) < rate


def wilson_interval(successes: float, trials: float,
                    z: float = Z_95) -> tuple[float, float, float]:
    """(estimate, lo, hi): the Wilson score interval for a binomial
    proportion — well-behaved at p near 0/1 and small n, which is exactly
    where a freshly armed probe lives."""
    if trials <= 0:
        return 0.0, 0.0, 1.0
    p = successes / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2.0 * trials)) / denom
    hw = (z / denom) * math.sqrt(
        p * (1.0 - p) / trials + z2 / (4.0 * trials * trials)
    )
    return p, max(0.0, center - hw), min(1.0, center + hw)


def count_hits(served_idx: np.ndarray, true_idx: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Per-query (hits, trials) for recall@k (Eq. 71 numerators).

    ``trials`` is the number of *valid* ground-truth ids in the row (< k
    when the filtered/alive sub-corpus is smaller than k), so a fully
    correct answer over a tiny sub-corpus scores 1.0, not |sub|/k."""
    m = len(served_idx)
    hits = np.zeros((m,), np.int64)
    trials = np.zeros((m,), np.int64)
    for i in range(m):
        t = {int(x) for x in true_idx[i] if int(x) >= 0}
        if not t:
            continue
        a = {int(x) for x in served_idx[i] if int(x) >= 0}
        trials[i] = len(t)
        hits[i] = len(a & t)
    return hits, trials


def view_key(filter) -> Optional[str]:
    """Stable identity of a probe's ground-truth view: queries buffered
    under different filters (or a mutated live corpus — the caller mixes
    in its generation) must not share one flush's ``valid`` mask."""
    if filter is None:
        return None
    if isinstance(filter, dict):
        return json.dumps(filter, sort_keys=True, default=str)
    arr = np.asarray(filter)
    return "mask:" + hashlib.blake2b(
        arr.tobytes() + str(arr.shape).encode(), digest_size=8
    ).hexdigest()


class RecallProbe:
    """Sampler + sliding-window recall estimator (see module docstring).

    The probe holds no engine state: the server samples with
    ``sample()``, computes ground-truth hit counts for the sampled
    queries, and feeds them back through ``observe()``; ``estimate()`` /
    ``stats()`` read the window."""

    def __init__(self, cfg=None, **kw):
        if cfg is None:
            cfg = ProbeConfig(**kw)
        else:
            cfg = ProbeConfig.from_cfg(cfg)
        self.cfg = cfg
        self.reset()

    #: ordinals of hash draws prefetched per refill — sampling runs on
    #: every recorded serving batch, so the steady-state cost must be a
    #: numpy slice compare (~5us), not a hashing pass (~30us/batch)
    _PREFETCH = 4096

    # ------------------------------------------------------------ sampling
    def _prefetch(self, start: int, count: int) -> None:
        """Refill the draw cache to cover ordinals [start, start+count):
        one hashing pass per ~``_PREFETCH`` ordinals, plus the precomputed
        sampled-ordinal positions the index fast path reads."""
        base = (start // _BLOCK) * _BLOCK
        self._draws = draws_range(
            self.cfg.seed, base, max(self._PREFETCH, count + _BLOCK))
        self._draws_start = base
        self._hit_ordinals = base + np.nonzero(self._draws < self.cfg.rate)[0]

    def sample(self, count: int) -> np.ndarray:
        """(count,) bool mask over the next ``count`` query ordinals;
        advances the ordinal counter whether or not anything samples.
        Bit-identical to ``sampled_mask`` (the prefetch is a cache of the
        same pure draws, so restart determinism is untouched)."""
        s = self.seen
        lo = s - self._draws_start
        if self._draws is None or lo < 0 or lo + count > len(self._draws):
            self._prefetch(s, count)
            lo = s - self._draws_start
        mask = self._draws[lo:lo + count] < self.cfg.rate
        self.seen += count
        return mask

    def sample_indices(self, count: int) -> np.ndarray:
        """Positions within the next ``count`` ordinals that sample —
        ``np.nonzero(sample(count))[0]`` without allocating the mask: the
        per-serving-batch fast path (a couple of binary searches over the
        prefetched hit list, ~2us on the usual nothing-sampled batch)."""
        s = self.seen
        lo = s - self._draws_start
        if self._draws is None or lo < 0 or lo + count > len(self._draws):
            self._prefetch(s, count)
        hits = self._hit_ordinals
        a, b = np.searchsorted(hits, (s, s + count))
        self.seen += count
        return hits[a:b] - s

    # ------------------------------------------------------------ estimator
    def observe(self, hits, trials) -> None:
        """Append per-query (hits, trials) outcomes to the window."""
        hits = np.atleast_1d(np.asarray(hits, np.int64))
        trials = np.atleast_1d(np.asarray(trials, np.int64))
        for h, t in zip(hits, trials):
            if t <= 0:
                continue  # empty sub-corpus: nothing to judge
            self._hits[self._pos] = h
            self._trials[self._pos] = t
            self._pos = (self._pos + 1) % self.cfg.window
            self._len = min(self._len + 1, self.cfg.window)
            self.probed += 1

    def estimate(self) -> dict:
        """Windowed recall@k with its Wilson interval."""
        h = float(self._hits[: self._len].sum())
        t = float(self._trials[: self._len].sum())
        p, lo, hi = wilson_interval(h, t, self.cfg.z)
        return {
            "recall": p, "lo": lo, "hi": hi,
            "window_probed": int(self._len), "trials": int(t),
        }

    # ------------------------------------------------------------ SLO floor
    def update_slo(self) -> Optional[str]:
        """Re-evaluate the floor; returns "breach" on the SERVING->breach
        edge, "recover" on the way back, None otherwise.  A breach needs
        the *upper* Wilson bound under the floor (confidently bad, not
        noisily bad) over at least ``slo_min_samples`` probed queries."""
        floor = self.cfg.slo_floor
        if floor is None or self._len < self.cfg.slo_min_samples:
            return None
        est = self.estimate()
        if not self.breached and est["hi"] < floor:
            self.breached = True
            self.breaches += 1
            return "breach"
        if self.breached and est["recall"] >= floor:
            self.breached = False
            return "recover"
        return None

    # ------------------------------------------------------------- plumbing
    def reset(self) -> None:
        """Fresh stream: ordinal counter, window and SLO state all rewind
        (what a server ``swap()`` calls so estimates never mix engines)."""
        self.seen = 0        # query ordinals consumed (sampled or not)
        self._draws = None   # prefetched hash draws (see _prefetch())
        self._draws_start = 0
        self._hit_ordinals = None
        self.probed = 0      # lifetime probed-query count
        self.breaches = 0
        self.breached = False
        self._hits = np.zeros((self.cfg.window,), np.int64)
        self._trials = np.zeros((self.cfg.window,), np.int64)
        self._pos = 0
        self._len = 0

    def stats(self) -> dict:
        """The ``stats()["quality"]`` block."""
        est = self.estimate()
        out = {
            "rate": self.cfg.rate,
            "k": self.cfg.k,
            "seed": self.cfg.seed,
            "window": self.cfg.window,
            "seen": int(self.seen),
            "probed": int(self.probed),
            "window_probed": est["window_probed"],
            "recall_estimate": round(est["recall"], 4),
            "ci_low": round(est["lo"], 4),
            "ci_high": round(est["hi"], 4),
        }
        if self.cfg.slo_floor is not None:
            out.update(slo_floor=self.cfg.slo_floor,
                       breached=self.breached, breaches=self.breaches)
        return out
