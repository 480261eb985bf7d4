"""Live index: mutation on top of any frozen engine — port of
``repro.core.live``.

``LiveIndex`` makes every registered engine mutable with the segment
architecture:

* **frozen segment** — an immutable inner engine (any registry key) built
  over the generation's corpus.  Never touched by upserts.
* **delta buffer** — a fixed-capacity ``(cap, d)`` host row buffer holding
  vectors inserted since the last compaction, searched by an exact
  ``core/scan.topk_scan`` over the occupied-and-alive slots (the ``valid``
  mask: the masked topk kernel on the card), or with a quant store by the
  int8 scan over the delta codes and an exact f32 rerank of its shortlist.
* **tombstone bitmap** — one alive/dead bit per addressable slot (frozen
  rows then delta slots), on the host.  Deletes flip a bit.

The delta buffer and the bitmap live on the host; their device mirrors
(``_Generation.device_view``) are uploaded once per mutation and reused
by every query until the next one.

``search`` oversamples the frozen engine (k' >= k + frozen tombstones),
re-scores the surviving frozen candidates in the original metric, scans
the delta, and merges the two lists through ``core/scan.merge_topk`` —
frozen slot ids are lower than delta slot ids and the frozen list is
merged first, so ties keep the lowest slot.

Generation-swap compaction: ``full`` rebuilds the frozen engine through
the registry over the compacted corpus (alive frozen rows, then alive
delta rows); ``refresh`` (infinity) keeps Phi and rebuilds only the VP
tree over the carried embeddings.  The new generation is published with
one reference assignment after all rebuild work, so a compaction that
dies leaves the old generation serving.

Addressing: frozen rows are slots ``0..n_frozen-1``, delta slot ``j`` is
``n_frozen + j``.  Only compaction renumbers; ``compact()`` returns the
old-slot -> new-slot remap (-1 = deleted), ``upsert`` remaps the ids it
returns through any swap it triggered, and ``slot_to_logical()`` maps
slots to positions in ``corpus()``.  A ``sharded`` inner engine needs
its frozen corpus divisible by the shard count: compaction carries the
trailing ``n % shards`` rows into the new generation's delta buffer (so
``delta_cap`` must be at least the shard count).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import embedding as embed_lib
from repro_torch.core import filter as filter_lib
from repro_torch.core import index as index_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import scan as scan_lib
from repro_torch.core import telemetry as telem
from repro_torch.core.index import SearchResult
from repro_torch.device import DeviceLike, resolve_device

_pow2ceil = scan_lib.pow2ceil


@dataclasses.dataclass
class _Generation:
    """Everything one search touches, swapped as a unit at compaction.

    ``delta_X`` / ``tomb`` / ``fill`` mutate in place between compactions
    (writes land before the fill bump); compaction builds a complete
    replacement and publishes it with one reference assignment."""

    frozen: Any  # inner Index over the generation corpus
    frozen_X: torch.Tensor  # (n_frozen, d) original vectors, on the device
    delta_X: np.ndarray  # (cap, d) f32 host buffer, rows [0, fill) occupied
    delta_Z: Optional[np.ndarray]  # (cap, s) inductive Phi embeddings (infinity)
    tomb: np.ndarray  # (n_frozen + cap,) bool — the tombstone bitmap
    fill: int = 0
    gen_id: int = 0
    dead_count: int = 0  # running tombstone count: dead_total() is O(1)
    # device mirrors of the mutable state, rebuilt lazily after a mutation
    # so the hot query path never re-uploads an unchanged delta/bitmap
    _dev: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def n_frozen(self) -> int:
        return int(self.frozen_X.shape[0])

    @property
    def n_slots(self) -> int:
        return self.n_frozen + self.fill

    def dead_frozen(self) -> int:
        return int(self.tomb[: self.n_frozen].sum())

    def dead_total(self) -> int:
        return self.dead_count

    def invalidate(self) -> None:
        self._dev = None

    def device_view(self):
        """(delta_X_dev, tomb_frozen_dev, alive_delta_dev, dead_frozen,
        n_alive_delta), uploaded once per mutation instead of per query."""
        if self._dev is None:
            dev = self.frozen_X.device
            cap = self.delta_X.shape[0]
            alive_d = (np.arange(cap) < self.fill) & ~self.tomb[
                self.n_frozen : self.n_frozen + cap
            ]
            self._dev = (
                torch.as_tensor(self.delta_X, device=dev),
                torch.as_tensor(self.tomb[: self.n_frozen], device=dev),
                torch.as_tensor(alive_d, device=dev),
                self.dead_frozen(),
                int(alive_d.sum()),
            )
        return self._dev


def _merge_frozen_delta(Q, fidx, frozen_X, tomb_f, delta_X, delta_valid, quant=None,
                        *, k: int, kd: int, kq: int = 0, metric: str):
    """Mask + re-score frozen candidates, scan the delta, merge to top-k.

    ``fidx`` is the frozen engine's oversampled candidate list (its raw
    distances are not used).  Tombstoned candidates become -1; the
    survivors are re-scored in the ORIGINAL metric (``topk_candidates``,
    the ``rescore`` span) so the two lists are comparable for every engine.
    ``quant`` — (delta codes (cap, d) int8, scales, sqnorms) from the
    slot-aligned quant store — switches the delta scan to the quantized
    two-stage: the int8 first pass keeps ``kq`` slots, the exact f32 rerank
    keeps ``kd``."""
    n_frozen = frozen_X.shape[0]
    fidx = fidx.long()
    alive = (fidx >= 0) & ~tomb_f[fidx.clamp_min(0)]
    cand = torch.where(alive, fidx, -1)
    with telem.span("rescore", sync=Q.device):
        fi, fd = scan_lib.topk_candidates(Q, cand, frozen_X, k=k, metric=metric)

    if quant is None:
        dd, dpos = scan_lib.topk_scan(Q, delta_X, k=kd, metric=metric,
                                      valid=delta_valid)
    else:
        dcodes, scales, sqnorms = quant
        _, dpos1 = scan_lib.topk_scan_quant(Q, dcodes, scales, k=kq, metric=metric,
                                            valid=delta_valid, sqnorms=sqnorms)
        dpos, dd = scan_lib.topk_candidates(Q, dpos1, delta_X, k=kd, metric=metric)
    di = torch.where(dpos >= 0, n_frozen + dpos.long(), -1).to(torch.int32)
    if kd < k:  # pad the delta list to the frozen list's width
        B, pad = Q.shape[0], k - kd
        dd = torch.cat([dd, torch.full((B, pad), float("inf"), device=dd.device)], dim=1)
        di = torch.cat([di, torch.full((B, pad), -1, dtype=torch.int32,
                                       device=di.device)], dim=1)

    # frozen first (lower slot ids) -> merge keeps ties at the lowest id
    mdist, midx = scan_lib.merge_topk(
        torch.stack([fd, dd], dim=1), torch.stack([fi, di], dim=1), k=k
    )
    return midx, mdist


@index_lib.register_index("live")
class LiveIndex:
    """Mutable wrapper over any frozen engine: upsert / delete / compact.

    cfg keys (``registry_build``): ``engine`` (inner registry key),
    ``engine_cfg`` (its config, reused verbatim at every compaction),
    ``delta_cap``, ``compact_deleted_frac``, ``auto_compact``,
    ``compact_mode`` ('full' | 'refresh'), plus ``budget`` as a search
    default.  The original dissimilarity for delta scans / re-scoring is
    ``engine_cfg['metric']`` (default 'euclidean')."""

    registry_name = "live"

    def __init__(
        self, gen: _Generation, *, engine: str, engine_cfg: dict, metric: str,
        delta_cap: int, compact_deleted_frac: float, auto_compact: bool,
        compact_mode: str, search_defaults: Optional[dict] = None,
    ):
        self._gen = gen
        self.engine = engine
        self.engine_cfg = dict(engine_cfg)
        self.metric = metric
        self.delta_cap = int(delta_cap)
        self.compact_deleted_frac = float(compact_deleted_frac)
        self.auto_compact = bool(auto_compact)
        self.compact_mode = compact_mode
        self.compactions = 0
        self.search_defaults = dict(search_defaults or {})
        self.attrs = None  # slot-aligned core/attrs store (attach_attrs)
        self.quant = None  # slot-aligned core/quant store (attach_quant)
        self.chaos = None  # core/chaos.FaultPlan (attach_chaos)

    @property
    def device(self) -> torch.device:
        return self._gen.frozen_X.device

    @property
    def frozen_X(self) -> torch.Tensor:
        """The current generation's frozen rows (on the device)."""
        return self._gen.frozen_X

    # ------------------------------------------------------------------ attrs
    def attach_attrs(self, store) -> None:
        """Attach a ``core/attrs`` store, slot-aligned: frozen rows then the
        delta buffer's capacity.  Accepts a corpus-length store (registry
        build) or a full slot-capacity store (snapshot restore)."""
        gen = self._gen
        cap = gen.n_frozen + self.delta_cap
        if store.n == gen.n_frozen:
            store = store.take(np.arange(gen.n_frozen), capacity=cap)
        elif store.n != cap:
            raise ValueError(
                f"attrs cover {store.n} rows; need the corpus ({gen.n_frozen}) "
                f"or full slot capacity ({cap})"
            )
        self.attrs = store
        index_lib.attach_store(gen.frozen, store.take(np.arange(gen.n_frozen)))

    def attach_quant(self, store) -> None:
        """Attach a ``core/quant`` store, slot-aligned like the attribute
        store.  Upserted rows are quantized with the frozen generation's
        scales; compaction recomputes scales from the compacted corpus."""
        gen = self._gen
        cap = gen.n_frozen + self.delta_cap
        if store.rows == gen.n_frozen:
            store = store.take(np.arange(gen.n_frozen), capacity=cap)
            if gen.fill:
                store.set_rows(gen.n_frozen, gen.delta_X[: gen.fill], gen.fill)
        elif store.rows != cap:
            raise ValueError(
                f"quant codes cover {store.rows} rows; need the corpus "
                f"({gen.n_frozen}) or full slot capacity ({cap})"
            )
        self.quant = store
        index_lib.attach_quant_store(gen.frozen, store.take(np.arange(gen.n_frozen)))

    def attach_chaos(self, plan) -> None:
        """Hold the fault plan; the live fault sites are ``search`` (entry),
        ``delta`` (upsert — injected overflow) and ``compact`` (just before
        the atomic publish)."""
        self.chaos = plan

    # ------------------------------------------------------------------ build
    @classmethod
    def registry_build(cls, X, cfg: Optional[Mapping[str, Any]] = None, *,
                       device: DeviceLike = None) -> "LiveIndex":
        cfg = dict(cfg or {})
        engine = cfg.pop("engine", "brute")
        if engine == "live":
            raise TypeError("live: cannot wrap a live index in a live index")
        engine_cfg = cfg.pop("engine_cfg", None)
        kw = {
            k: cfg.pop(k)
            for k in ("delta_cap", "compact_deleted_frac", "auto_compact",
                      "compact_mode")
            if k in cfg
        }
        sdef = {k: cfg.pop(k) for k in ("budget",) if k in cfg}
        if engine_cfg is None:
            engine_cfg = cfg  # remaining keys configure the inner engine
        elif cfg:
            raise TypeError(
                f"live: pass inner-engine keys via engine_cfg OR inline, "
                f"not both: {sorted(cfg)}"
            )
        idx = cls.build(X, engine=engine, engine_cfg=engine_cfg, device=device, **kw)
        idx.search_defaults = sdef
        return idx

    @classmethod
    def build(
        cls, X, *, engine: str = "brute",
        engine_cfg: Optional[Mapping[str, Any]] = None, delta_cap: int = 1024,
        compact_deleted_frac: float = 0.25, auto_compact: bool = True,
        compact_mode: str = "full", device: DeviceLike = None,
    ) -> "LiveIndex":
        if compact_mode not in ("full", "refresh"):
            raise ValueError(f"compact_mode must be 'full' or 'refresh': {compact_mode!r}")
        X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
        if X.ndim != 2 or X.shape[0] < 1:
            raise ValueError(f"live: need a non-empty (n, d) corpus, got {tuple(X.shape)}")
        engine_cfg = dict(engine_cfg or {})
        delta_cap = int(delta_cap)
        if delta_cap < 1:
            raise ValueError(f"delta_cap must be >= 1: {delta_cap}")
        # the original dissimilarity every inner engine scores in — for a
        # sharded wrapper it lives on the inner engine's cfg, one level down
        metric_cfg = engine_cfg
        if engine == "sharded":
            inner = engine_cfg.get("engine_cfg")
            if inner is None:  # sharded's inline form: leftover keys = inner cfg
                inner = {k: v for k, v in engine_cfg.items()
                         if k not in ("engine", "shards", "mesh")}
            metric_cfg = inner
            if delta_cap < int(engine_cfg.get("shards", 2)):
                raise ValueError(
                    "live over sharded: delta_cap must be >= the shard count "
                    "(compaction carries up to shards-1 remainder rows)"
                )
        frozen = index_lib.build(engine, X, engine_cfg, device=X.device)
        gen = _Generation(
            frozen=frozen,
            frozen_X=X,
            delta_X=np.zeros((delta_cap, X.shape[1]), np.float32),
            delta_Z=cls._fresh_delta_Z(frozen, delta_cap),
            tomb=np.zeros((X.shape[0] + delta_cap,), bool),
        )
        return cls(
            gen, engine=engine, engine_cfg=engine_cfg,
            metric=metric_cfg.get("metric", "euclidean"), delta_cap=delta_cap,
            compact_deleted_frac=compact_deleted_frac, auto_compact=auto_compact,
            compact_mode=compact_mode,
        )

    @staticmethod
    def _fresh_delta_Z(frozen, cap: int) -> Optional[np.ndarray]:
        """Infinity engines get a parallel buffer of inductive embeddings:
        new rows are embedded at upsert and carried into refresh
        compactions."""
        Z = getattr(frozen, "Z", None)
        if Z is None:
            return None
        return np.zeros((cap, Z.shape[1]), np.float32)

    # ---------------------------------------------------------------- mutate
    def upsert(self, X_new, ids=None, attrs=None) -> np.ndarray:
        """Insert rows (optionally replacing existing slots); returns the
        assigned slot ids, valid in the final generation as a whole.

        ``ids``: existing slot ids to replace (tombstoned, the new vector
        appended; -1 = plain insert).  ``attrs``: ``{column: per-row
        values}`` for the inserted rows; columns left out get the missing
        sentinel."""
        X_new = np.asarray(X_new, np.float32)
        if X_new.ndim == 1:
            X_new = X_new[None]
        d = self._gen.delta_X.shape[1]
        if X_new.shape[1] != d:
            raise ValueError(f"upsert dim {X_new.shape[1]} != corpus dim {d}")
        if attrs and self.attrs is None:
            raise TypeError(
                "upsert got attrs but this index has no attribute store: "
                "build with an 'attrs' cfg mapping"
            )
        if self.chaos is not None:
            # injected buffer exhaustion: the whole upsert is rejected
            # before any tombstone or delta write
            self.chaos.on_delta()
        if self.attrs is not None:
            # validate before the destructive steps below
            self.attrs.validate_rows(attrs, X_new.shape[0])
        if ids is not None:
            ids = np.asarray(ids, np.int64)
            if ids.shape[0] != X_new.shape[0]:
                raise ValueError("upsert: ids and X_new length mismatch")
            self.delete(ids[ids >= 0])
        out = np.empty((X_new.shape[0],), np.int64)
        done = 0
        while done < X_new.shape[0]:
            gen = self._gen
            room = self.delta_cap - gen.fill
            if room == 0:
                remap = self.compact()
                # rows inserted before the swap live on under new slot ids
                out[:done] = remap[out[:done]]
                continue
            take = min(room, X_new.shape[0] - done)
            rows = X_new[done : done + take]
            gen.delta_X[gen.fill : gen.fill + take] = rows
            if gen.delta_Z is not None:
                gen.delta_Z[gen.fill : gen.fill + take] = embed_lib.apply(
                    gen.frozen.phi, torch.as_tensor(rows, device=self.device)
                ).cpu().numpy()
            if self.attrs is not None:
                chunk = None if attrs is None else {
                    c: np.asarray(v)[done : done + take]
                    for c, v in dict(attrs).items()
                }
                self.attrs.set_rows(gen.n_frozen + gen.fill, chunk, take)
            if self.quant is not None:
                # quantize under the frozen scales — visible to the very
                # next query's delta code scan
                self.quant.set_rows(gen.n_frozen + gen.fill, rows, take)
            out[done : done + take] = gen.n_frozen + gen.fill + np.arange(take)
            gen.fill += take  # publish the rows only after they are written
            gen.invalidate()
            done += take
        remap = self._maybe_autocompact()
        if remap is not None:
            out = remap[out]
        return out

    def delete(self, ids) -> int:
        """Tombstone slot ids; returns how many were newly marked dead.
        Unknown / out-of-range ids raise.  Deletes never renumber."""
        gen = self._gen
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size and ((ids < 0) | (ids >= gen.n_slots)).any():
            bad = ids[(ids < 0) | (ids >= gen.n_slots)]
            raise KeyError(f"delete: slot ids out of range: {bad[:8].tolist()}")
        newly = int((~gen.tomb[ids]).sum())
        gen.tomb[ids] = True
        gen.dead_count += newly
        gen.invalidate()
        return newly

    def _maybe_autocompact(self) -> Optional[np.ndarray]:
        """Compacts when the deleted fraction crosses the threshold;
        returns the remap when a swap happened."""
        gen = self._gen
        if not self.auto_compact:
            return None
        dead = gen.dead_total()
        if gen.n_slots and dead < gen.n_slots and dead / gen.n_slots >= self.compact_deleted_frac:
            return self.compact()
        return None

    # --------------------------------------------------------------- compact
    def compact(self, mode: Optional[str] = None) -> np.ndarray:
        """Generation swap: rebuild the frozen engine over the compacted
        corpus and publish it atomically.  Returns the old-slot -> new-slot
        remap (-1 = deleted).

        ``full`` rebuilds through the registry with the original
        ``engine_cfg``; ``refresh`` (infinity only; full elsewhere) keeps
        the frozen Phi and rebuilds only the VP tree.  Over a ``sharded``
        engine the trailing ``n % shards`` rows of the compacted corpus go
        into the new generation's delta buffer instead of the frozen
        segment; their slot ids equal their corpus positions, so the remap
        stays positional."""
        with telem.span("compaction", engine=self.engine,
                        mode=mode or self.compact_mode):
            return self._compact_impl(mode)

    def _compact_impl(self, mode: Optional[str]) -> np.ndarray:
        gen = self._gen
        mode = mode or self.compact_mode
        dev = self.device
        fill = gen.fill  # rows appended during the rebuild belong to the next generation
        alive_f = ~gen.tomb[: gen.n_frozen]
        alive_d = ~gen.tomb[gen.n_frozen : gen.n_frozen + fill]
        keep_f = torch.as_tensor(np.nonzero(alive_f)[0], device=dev)
        corpus = torch.cat([gen.frozen_X[keep_f],
                            torch.as_tensor(gen.delta_X[:fill][alive_d], device=dev)])
        if corpus.shape[0] < 1:
            raise ValueError("compact: every row is tombstoned; nothing to build on")
        carry = 0
        if self.engine == "sharded":
            shards = int(self.engine_cfg.get("shards", 2))
            carry = corpus.shape[0] % shards
            if corpus.shape[0] - carry < shards:
                raise ValueError(
                    f"compact: {corpus.shape[0]} alive rows cannot fill "
                    f"{shards} shards"
                )
        frozen_part = corpus[: corpus.shape[0] - carry]

        if mode == "refresh" and gen.delta_Z is not None:
            Z = torch.cat([gen.frozen.Z[keep_f],
                           torch.as_tensor(gen.delta_Z[:fill][alive_d], device=dev)])
            frozen = gen.frozen.refresh(corpus, Z=Z)
        else:
            frozen = index_lib.build(self.engine, frozen_part, self.engine_cfg, device=dev)

        remap = np.full((gen.n_slots,), -1, np.int64)
        alive = np.concatenate([alive_f, alive_d])
        remap[alive] = np.arange(int(alive.sum()))

        # realign the side stores into LOCALS: nothing on self mutates until
        # the single publish below.  Alive order is the compacted corpus
        # order is the new slot order (carried rows land in delta slots
        # whose ids equal their corpus positions), so one gather realigns
        n_new = frozen_part.shape[0]
        new_attrs = new_quant = None
        if self.attrs is not None:
            new_attrs = self.attrs.take(np.where(alive)[0], capacity=n_new + self.delta_cap)
            index_lib.attach_store(frozen, new_attrs.take(np.arange(n_new)))
        if self.quant is not None:
            # re-quantize from the compacted corpus (fresh scales), padded
            # back out to the new generation's slot capacity
            new_quant = quant_lib.QuantStore.build(corpus).take(
                np.arange(corpus.shape[0]), capacity=n_new + self.delta_cap)
            index_lib.attach_quant_store(frozen, new_quant.take(np.arange(n_new)))

        new_gen = _Generation(
            frozen=frozen,
            frozen_X=frozen_part,
            delta_X=np.zeros((self.delta_cap, corpus.shape[1]), np.float32),
            delta_Z=self._fresh_delta_Z(frozen, self.delta_cap),
            tomb=np.zeros((n_new + self.delta_cap,), bool),
            gen_id=gen.gen_id + 1,
        )
        if carry:  # carried rows land in delta slots 0..carry-1
            new_gen.delta_X[:carry] = corpus[n_new:].cpu().numpy()
            new_gen.fill = carry
        if self.chaos is not None:
            # the worst-case crash point: every rebuild cost paid, nothing
            # published
            self.chaos.on_compact()
        # the atomic publish: generation and realigned stores swap together
        self._gen = new_gen
        if new_attrs is not None:
            self.attrs = new_attrs
        if new_quant is not None:
            self.quant = new_quant
        self.compactions += 1
        telem.count("compactions_total", engine=self.engine)
        return remap

    # ---------------------------------------------------------------- search
    def search(self, Q, k: int = 1, *, budget: Optional[int] = None,
               filter=None) -> SearchResult:
        gen = self._gen  # one read: searches never straddle a generation swap
        if self.chaos is not None:
            self.chaos.on_search()
        budget = index_lib.resolve(budget, self.search_defaults, "budget")
        filter = index_lib.resolve(filter, self.search_defaults, "filter")
        dev = self.device
        Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
        k = int(k)
        # slot-aligned mask over the full capacity; filter AND tombstone
        cap = gen.n_frozen + self.delta_cap
        is_raw = isinstance(filter, (np.ndarray, torch.Tensor))
        if is_raw and filter.shape[0] == gen.n_slots and gen.n_slots < cap:
            # raw masks come slot-count sized; the unoccupied delta slots
            # hold no row to pass
            filter = torch.cat([torch.as_tensor(filter, device=dev).to(torch.bool),
                                torch.zeros((cap - gen.n_slots,), dtype=torch.bool,
                                            device=dev)])
        mask = filter_lib.resolve_mask(filter, self.attrs, cap, dev)
        # frozen-segment filter: predicates go down as-is (the frozen engine
        # resolves them against its own store view); raw masks slice
        if mask is None:
            f_filter = None
        elif not is_raw and getattr(gen.frozen, "attrs", None) is not None:
            f_filter = filter
        else:
            f_filter = mask[: gen.n_frozen]
        if gen.fill == 0 and gen.dead_total() == 0:
            # clean generation: the live wrapper is transparent
            telem.count("live_scan_total", engine=self.engine, segment="frozen")
            with telem.span("frozen_scan", engine=self.engine, clean=True):
                return gen.frozen.search(Q, k=k, budget=budget, filter=f_filter)

        delta_X, tomb_f, alive_d, dead_frozen, n_alive_d = gen.device_view()
        # oversample: every frozen tombstone can evict at most one live
        # answer; rounding up to a power of two bounds the distinct widths
        kf = min(gen.n_frozen, _pow2ceil(k + dead_frozen))
        telem.count("live_scan_total", engine=self.engine, segment="frozen")
        with telem.span("frozen_scan", engine=self.engine, oversample=kf, sync=dev):
            fres = gen.frozen.search(Q, k=kf, budget=budget, filter=f_filter)

        kd = min(k, self.delta_cap)
        delta_valid = alive_d if mask is None else alive_d & mask[gen.n_frozen :]
        quant = kq = None
        if self.quant is not None:
            # the delta region of the slot-aligned code buffer
            codes, scales, sqnorms = self.quant.device_view()
            quant = (codes[gen.n_frozen :], scales, sqnorms[gen.n_frozen :])
            kq = min(self.delta_cap, quant_lib.shortlist_width(kd, self.delta_cap))
        telem.count("live_scan_total", engine=self.engine, segment="delta")
        with telem.span("delta_scan", engine=self.engine, fill=gen.fill, sync=dev):
            midx, mdist = _merge_frozen_delta(
                Q, fres.idx, gen.frozen_X, tomb_f, delta_X, delta_valid, quant,
                k=k, kd=kd, kq=kq or 0, metric=self.metric,
            )
        # frozen work as counted by the engine + one comparison per alive
        # (and passing) delta row, plus the kq exact rescores when quantized
        if mask is None:
            comps = fres.comparisons + n_alive_d
        else:
            comps = fres.comparisons + delta_valid.sum().to(torch.int32)
        if kq:
            comps = comps + kq
        return SearchResult(midx, mdist, comps.to(torch.int32))

    # ------------------------------------------------------------ inspection
    def corpus(self) -> np.ndarray:
        """The live logical corpus (host): alive frozen rows then alive
        delta rows, in slot order — what the next compaction will freeze."""
        gen = self._gen
        alive_f = ~gen.tomb[: gen.n_frozen]
        alive_d = ~gen.tomb[gen.n_frozen : gen.n_frozen + gen.fill]
        return np.concatenate(
            [gen.frozen_X.cpu().numpy()[alive_f], gen.delta_X[: gen.fill][alive_d]],
            axis=0,
        )

    def slot_to_logical(self) -> np.ndarray:
        """Slot id -> position in ``corpus()`` (-1 = tombstoned)."""
        gen = self._gen
        alive = ~gen.tomb[: gen.n_slots]
        out = np.full((gen.n_slots,), -1, np.int64)
        out[alive] = np.arange(int(alive.sum()))
        return out

    def stats(self) -> dict:
        """Segment composition — the operator's compaction-pressure gauge."""
        gen = self._gen
        return {
            "engine": self.engine,
            "generation": gen.gen_id,
            "frozen_size": gen.n_frozen,
            "delta_fill": gen.fill,
            "delta_cap": self.delta_cap,
            "tombstones": gen.dead_total(),
            "deleted_frac": gen.dead_total() / max(1, gen.n_slots),
            "n_alive": gen.n_slots - gen.dead_total(),
            "compactions": self.compactions,
            "attr_columns": list(self.attrs.columns()) if self.attrs else [],
            "quant_bytes": self.quant.memory_bytes() if self.quant else 0,
        }

    def memory_bytes(self) -> int:
        gen = self._gen
        extra = index_lib.pytree_nbytes(gen.frozen_X)
        extra += gen.delta_X.nbytes + gen.tomb.nbytes
        if gen.delta_Z is not None:
            extra += gen.delta_Z.nbytes
        return gen.frozen.memory_bytes() + int(extra) + index_lib.side_store_bytes(self)

    # --------------------------------------------------------------- snapshot
    def snapshot_state(self):
        from repro_torch.core import store as store_lib

        gen = self._gen
        fa, fs = store_lib.engine_snapshot_state(gen.frozen)
        arrays = {
            "frozen": fa,
            "frozen_X": gen.frozen_X,
            "delta_X": gen.delta_X[: gen.fill],
            "tomb_bits": np.packbits(gen.tomb),  # the bitmap as actual bits
        }
        if gen.delta_Z is not None:
            arrays["delta_Z"] = gen.delta_Z[: gen.fill]
        statics = {
            "engine": self.engine,
            "engine_cfg": self.engine_cfg,
            "metric": self.metric,
            "delta_cap": self.delta_cap,
            "compact_deleted_frac": self.compact_deleted_frac,
            "auto_compact": self.auto_compact,
            "compact_mode": self.compact_mode,
            "compactions": self.compactions,
            "fill": gen.fill,
            "gen_id": gen.gen_id,
            "tomb_len": int(gen.tomb.shape[0]),
            "frozen_statics": fs,
            "search_defaults": self.search_defaults,
        }
        return arrays, statics

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "LiveIndex":
        from repro_torch.core import store as store_lib

        dev = resolve_device(device)
        engine = statics["engine"]
        frozen = store_lib.engine_from_snapshot(
            engine, arrays["frozen"], statics["frozen_statics"], device=dev
        )
        frozen_X = torch.tensor(np.asarray(arrays["frozen_X"], np.float32), device=dev)
        cap = int(statics["delta_cap"])
        fill = int(statics["fill"])
        delta_X = np.zeros((cap, frozen_X.shape[1]), np.float32)
        delta_X[:fill] = np.asarray(arrays["delta_X"], np.float32)
        delta_Z = cls._fresh_delta_Z(frozen, cap)
        if delta_Z is not None and "delta_Z" in arrays:
            delta_Z[:fill] = np.asarray(arrays["delta_Z"], np.float32)
        tomb = np.unpackbits(
            np.asarray(arrays["tomb_bits"], np.uint8), count=statics["tomb_len"]
        ).astype(bool)
        gen = _Generation(
            frozen=frozen, frozen_X=frozen_X, delta_X=delta_X, delta_Z=delta_Z,
            tomb=tomb, fill=fill, gen_id=int(statics["gen_id"]),
            dead_count=int(tomb.sum()),
        )
        idx = cls(
            gen, engine=engine, engine_cfg=dict(statics["engine_cfg"]),
            metric=statics["metric"], delta_cap=cap,
            compact_deleted_frac=statics["compact_deleted_frac"],
            auto_compact=statics["auto_compact"],
            compact_mode=statics["compact_mode"],
            search_defaults=dict(statics.get("search_defaults") or {}),
        )
        idx.compactions = int(statics.get("compactions", 0))
        return idx
