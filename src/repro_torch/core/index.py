"""Index protocol and registry — port of ``repro.core.index``:
``SearchResult``, ``register_index``, ``build`` with the reserved
``attrs``, ``quant`` and ``chaos`` keys, ``attach_store``,
``attach_quant_store``, ``attach_chaos``, ``list_engines``, the memory
audit helpers and ``resolve``.  The built-in engines are ``brute``,
``ivf_flat``, ``ivf_pq``, ``nsw`` (``core/baselines``), ``infinity``
(``core/search``), ``live`` (``core/live``, a mutable wrapper over any
of them) and ``sharded`` (``ShardedIndex``, any of the five over row
shards); each takes ``search(..., filter=)``.

``ShardedIndex`` splits the corpus into equal row shards and builds one
inner engine per shard.  Where the JAX package places one shard per
device under ``shard_map``, the port holds every shard on one device: the
per-shard states are stacked along a leading shard axis once, at build
(uneven leaves padded as ``jnp.pad`` pads them: -1 for integer leaves,
wrapped to the maximum for unsigned ones, +inf for floats, True for bool),
and a search runs each shard's ``shard_search`` on its slice of the stack
in ascending shard order, one after another.  Local ids get the shard
offset (-1 stays -1) and the lists merge through ``core/scan.merge_topk``,
which keeps the lowest global id on ties, so an exhaustive engine answers
as its one-shard build does.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch.core import attrs as attrs_lib
from repro_torch.core import chaos as chaos_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import telemetry as telem
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import Mesh, search_policy


class SearchResult(NamedTuple):
    """Uniform search answer: unpacks as (idx, dist, comparisons)."""

    idx: torch.Tensor  # (B, k) int32, -1 = no result
    dist: torch.Tensor  # (B, k) f32, ascending (ties -> lowest index)
    comparisons: torch.Tensor  # (B,) int32 distance evaluations


_REGISTRY: dict[str, type] = {}
BUILTIN = ("brute", "ivf_flat", "ivf_pq", "nsw", "infinity", "sharded", "live")


def register_index(name: str):
    """Class decorator: expose an engine under a stable string key."""

    def deco(cls):
        for attr in ("build", "search", "memory_bytes"):
            if not hasattr(cls, attr):
                raise TypeError(f"{cls.__name__} lacks Index.{attr}")
        cls.registry_name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtin() -> None:
    # engines self-register at module load
    import repro_torch.core.baselines  # noqa: F401
    import repro_torch.core.live  # noqa: F401
    import repro_torch.core.search  # noqa: F401


def available() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def list_engines() -> dict[str, str]:
    """{registry key: one-line summary} for every registered engine — the
    operator-facing discovery surface (``serve --list-engines``)."""
    _ensure_builtin()
    out = {}
    for name in sorted(_REGISTRY):
        doc = (_REGISTRY[name].__doc__ or "").strip()
        out[name] = doc.splitlines()[0].strip() if doc else ""
    return out


def get_index(name: str) -> type:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown index {name!r}; available: {available()}") from None


def build(name: str, X, cfg: Optional[Mapping[str, Any]] = None, *,
          device: DeviceLike = None):
    """Build a registered engine from one config mapping on ``device``
    (default CUDA).  Keys the engine's build does not take become its
    search defaults.

    The reserved key ``attrs`` — ``{column: per-row values}`` — builds a
    columnar ``core/attrs.AttributeStore`` aligned with the corpus rows and
    attaches it (``attach_store``), enabling predicate filters on every
    engine's ``search``.  It is handled here, once for every engine.

    The reserved key ``quant`` (truthy) quantizes the corpus to int8 codes
    (``core/quant.QuantStore``) and attaches the store
    (``attach_quant_store``): brute then scans codes first and reranks a
    ``quant.shortlist_width``-wide shortlist exactly; infinity scans its
    beam buckets on codes and prefilters its rerank on them; live extends
    the store to its slot capacity and quantizes upserts.

    The reserved key ``chaos`` — a ``core/chaos.FaultPlan`` or its dict
    sugar — arms deterministic fault injection: plain engines get their
    ``search`` wrapped with the latency/transient injector, live holds the
    plan and consults it at its own fault sites (compaction publish, delta
    overflow), and ``core/store.save`` consults it to corrupt a snapshot.
    A ``build``-site fault fires here, after construction: the poisoned
    instance never escapes."""
    cls = get_index(name)
    cfg = dict(cfg or {})
    attr_values = cfg.pop("attrs", None)
    quant_cfg = cfg.pop("quant", None)
    chaos_cfg = cfg.pop("chaos", None)
    hook = getattr(cls, "registry_build", None)
    if hook is not None:
        inst = hook(X, cfg, device=device)
    else:
        inst = generic_registry_build(cls, X, cfg, device=device)
    if attr_values:
        attach_store(inst, attrs_lib.AttributeStore.build(attr_values,
                                                          int(corpus_of(inst).shape[0])))
    if quant_cfg:
        attach_quant_store(inst, quant_lib.QuantStore.build(corpus_of(inst)))
    if chaos_cfg is not None:
        plan = chaos_lib.FaultPlan.from_cfg(chaos_cfg)
        plan.on_build()  # a poisoned build never escapes
        attach_chaos(inst, plan)
    return inst


def corpus_of(inst) -> torch.Tensor:
    """The rows an engine was built over (live: its frozen segment;
    sharded: the shards' rows in order)."""
    X = getattr(inst, "X", None)
    if X is None:
        X = getattr(inst, "frozen_X", None)
    return X if X is not None else inst.corpus_rows()


def generic_registry_build(cls, X, cfg: Optional[Mapping[str, Any]], *,
                           device: DeviceLike = None):
    """Split ``cfg`` against the engine's ``build`` / ``search`` signatures:
    build keys configure construction, search keys become the instance's
    search defaults."""
    cfg = dict(cfg or {})
    bkeys = set(inspect.signature(cls.build).parameters) - {"cls", "X", "device"}
    skeys = (set(inspect.signature(cls.search).parameters) - {"self", "Q", "k"}) | {"budget"}
    bkw = {k: cfg.pop(k) for k in list(cfg) if k in bkeys}
    skw = {k: cfg.pop(k) for k in list(cfg) if k in skeys}
    if cfg:
        raise TypeError(
            f"{cls.registry_name}: unknown cfg keys {sorted(cfg)} "
            f"(build takes {sorted(bkeys)}, search takes {sorted(skeys)})"
        )
    inst = cls.build(X, device=device, **bkw)
    inst.search_defaults = skw
    return inst


def attach_store(inst, store) -> None:
    """Attach a built ``core/attrs.AttributeStore`` — through the engine's
    ``attach_attrs`` hook when it has one, else as a plain ``attrs``
    attribute."""
    hook = getattr(inst, "attach_attrs", None)
    if hook is not None:
        hook(store)
    else:
        inst.attrs = store


def attach_quant_store(inst, store) -> None:
    """Attach a built ``core/quant.QuantStore`` — through the engine's
    ``attach_quant`` hook when it has one, else as a plain ``quant``
    attribute."""
    hook = getattr(inst, "attach_quant", None)
    if hook is not None:
        hook(store)
    else:
        inst.quant = store


def attach_chaos(inst, plan) -> None:
    """Arm an engine instance with a ``core/chaos.FaultPlan`` — through its
    ``attach_chaos`` hook when it has one (live fires compaction / delta
    faults itself), else by wrapping ``search`` with the generic injector:
    every call first runs the plan's ``search`` site (latency spikes sleep,
    transient rules raise), then the engine."""
    hook = getattr(inst, "attach_chaos", None)
    if hook is not None:
        hook(plan)
        return
    inst.chaos = plan
    orig = inst.search

    def chaotic_search(*args, **kwargs):
        plan.on_search()
        return orig(*args, **kwargs)

    inst.search = chaotic_search


def pytree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested structure (dicts, lists, tuples,
    ``nn.Module`` parameters and buffers); None counts 0."""
    if isinstance(tree, torch.nn.Module):
        return sum(pytree_nbytes(t) for t in
                   list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    return 0


def side_store_bytes(inst) -> int:
    """Bytes of the per-instance side stores (``attrs`` columns, ``quant``
    codes) — every engine's ``memory_bytes`` adds this."""
    total = 0
    for name in ("attrs", "quant"):
        store = getattr(inst, name, None)
        if store is not None:
            total += store.memory_bytes()
    return int(total)


def resolve(value, defaults: Optional[Mapping[str, Any]], key: str, fallback=None):
    """Search-kwarg resolution order: explicit arg > stored default > fallback."""
    if value is not None:
        return value
    if defaults and defaults.get(key) is not None:
        return defaults[key]
    return fallback


def default_merge_shard_static(statics: list[dict]) -> dict:
    """Per-shard static configs must agree (engines with per-shard statics —
    e.g. tree depth — override ``merge_shard_static``)."""
    merged = dict(statics[0])
    for s in statics[1:]:
        if s != merged:
            raise ValueError(f"shard statics disagree: {merged} vs {s}")
    return merged


# ---------------------------------------------------------------------------
# sharded engine
# ---------------------------------------------------------------------------

def _pad_fill(dtype: torch.dtype):
    """What ``jnp.pad(..., constant_values=-1 or inf)`` writes for a leaf of
    this dtype: -1 for signed integers (wrapped to the maximum for unsigned
    ones), +inf for floats, True for bool (inf cast to bool)."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return math.inf
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else -1


def _tree_map(fn, tree):
    """``fn`` over every tensor leaf of nested dicts / lists / tuples."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack_shard_states(states: list, device: torch.device):
    """Stack per-shard state trees along a new leading shard axis on
    ``device``.  Leaves whose shapes differ across shards (IVF's padded
    inverted lists, each shard's VP tree) are first padded to the
    elementwise max shape with ``_pad_fill`` of their dtype — the JAX
    package's ``_stack_shard_states``, so a JAX snapshot's stacked arrays
    and the port's agree element for element."""
    first = states[0]
    if isinstance(first, Mapping):
        return {k: _stack_shard_states([s[k] for s in states], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_shard_states(list(z), device) for z in zip(*states))
    leaves = [torch.as_tensor(s, device=device) for s in states]
    shapes = {tuple(l.shape) for l in leaves}
    if len(shapes) > 1:
        target = tuple(max(dims) for dims in zip(*shapes))
        fill = _pad_fill(leaves[0].dtype)
        padded = []
        for l in leaves:
            out = torch.full(target, fill, dtype=l.dtype, device=device)
            out[tuple(slice(0, n) for n in l.shape)] = l
            padded.append(out)
        leaves = padded
    return torch.stack(leaves)


@register_index("sharded")
@dataclasses.dataclass
class ShardedIndex:
    """Any registered engine over equal row shards of the corpus, every
    shard on one device.

    ``build`` splits the corpus into ``shards`` row slices, builds one
    inner engine per shard and stacks their ``shard_state`` trees along a
    leading shard axis, once.  ``search`` runs each shard's
    ``shard_search`` on its slice of the stack (ascending shard order),
    restores global ids from the shard offsets and merges the per-shard
    top-k lists with ``core/scan.merge_topk``.  Comparisons are summed over
    shards, and a per-query ``budget`` is split S ways (floor 1 each, the
    remainder to the first shards) so the summed count respects the same
    bound as an unsharded engine (engine-cfg knobs like ``rerank`` stay
    per shard)."""

    engine: str
    engine_cls: type
    stacked: Any  # tree; every leaf (S, ...) on the device
    static: dict
    shard_size: int
    n: int
    dctx: Any = None  # dist.sharding.DistCtx over a ("data",) mesh on the device
    search_defaults: dict = dataclasses.field(default_factory=dict)
    attrs: Any = None  # core/attrs store, placed over the shard rows
    quant: Any = None  # core/quant store, placed over the shard rows
    chaos: Any = None  # core/chaos.FaultPlan — per-shard fault injection
    _views: Optional[list] = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ build
    @classmethod
    def registry_build(cls, X, cfg: Optional[Mapping[str, Any]] = None, *,
                       device: DeviceLike = None) -> "ShardedIndex":
        cfg = dict(cfg or {})
        engine = cfg.pop("engine", "brute")
        shards = int(cfg.pop("shards", 2))
        mesh = cfg.pop("mesh", None)
        engine_cfg = cfg.pop("engine_cfg", None)
        if engine_cfg is None:
            engine_cfg = cfg  # remaining keys configure the inner engine
        elif cfg:
            raise TypeError(f"sharded: pass engine keys via engine_cfg OR inline, "
                            f"not both: {sorted(cfg)}")
        return cls.build(X, engine=engine, shards=shards, mesh=mesh, engine_cfg=engine_cfg,
                         device=device)

    @classmethod
    def build(cls, X, *, engine: str = "brute", shards: int = 2, mesh=None,
              engine_cfg: Optional[Mapping[str, Any]] = None,
              device: DeviceLike = None) -> "ShardedIndex":
        """``mesh``: a ``dist/sharding.Mesh`` whose ``data`` axis holds the
        shards (default: one of ``shards`` ranks on the device); the
        corpus goes to its device unless ``device`` is given.  The shards
        are searched in turn either way."""
        if mesh is not None and device is None:
            device = mesh.device
        X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
        n = X.shape[0]
        shards = int(shards)
        if shards < 1 or n % shards != 0:
            raise ValueError(f"corpus rows ({n}) must divide evenly into shards ({shards})")
        engine_cls = get_index(engine)
        if not hasattr(engine_cls, "shard_state"):
            raise TypeError(f"engine {engine!r} does not support sharding (no shard_state)")
        if mesh is None:
            mesh = Mesh((shards,), ("data",), X.device)
        if mesh.shape.get("data", 1) != shards:
            raise ValueError(f"mesh data axis {mesh.shape} != shards {shards}")
        if mesh.device != X.device:
            raise ValueError(f"mesh on {mesh.device}, corpus on {X.device}")
        shard_size = n // shards
        states, statics = [], []
        for s in range(shards):
            inner = build(engine, X[s * shard_size:(s + 1) * shard_size], engine_cfg,
                          device=X.device)
            st, stat = inner.shard_state()
            states.append(st)
            statics.append(stat)
        merge = getattr(engine_cls, "merge_shard_static", None)
        static = merge(statics) if merge is not None else default_merge_shard_static(statics)
        return cls(engine=engine, engine_cls=engine_cls,
                   stacked=_stack_shard_states(states, X.device), static=static,
                   shard_size=shard_size, n=n, dctx=search_policy(mesh))

    @property
    def shards(self) -> int:
        return self.n // self.shard_size

    @property
    def device(self) -> torch.device:
        return self.stacked["X"].device

    def corpus_rows(self) -> torch.Tensor:
        """The (n, d) corpus, the shards' rows in order (a view of the
        stack)."""
        X = self.stacked["X"]
        return X.reshape(self.n, X.shape[-1])

    def shard_views(self) -> list:
        """Per-shard state trees: each leaf is ``stacked_leaf[s]``, a view
        (no copy) of the stack."""
        if self._views is None:
            self._views = [_tree_map(lambda x, s=s: x[s], self.stacked)
                           for s in range(self.shards)]
        return self._views

    # ---------------------------------------------------------- side stores
    def attach_attrs(self, store) -> None:
        """Place the attribute columns over the shard rows: a compiled mask
        is sliced per shard (views), so each shard's engine gets its rows'
        validity with no copy."""
        if store.n != self.n:
            raise ValueError(f"attrs cover {store.n} rows != corpus {self.n}")
        store.place(self.shards, self.shard_size)
        self.attrs = store

    def attach_quant(self, store) -> None:
        """Place the int8 corpus codes over the shard rows: each shard's
        engine receives its (shard_size, d) code and sq-norm slices (plus
        the shared scales) as views.  Only engines whose ``shard_search``
        takes a ``quant=`` operand can use it; attaching to others would
        silently scan f32, so it raises instead."""
        if store.rows != self.n:
            raise ValueError(f"quant codes cover {store.rows} rows != corpus {self.n}")
        if not getattr(self.engine_cls, "shard_supports_quant", False):
            raise TypeError(f"engine {self.engine!r} has no quantized shard scan "
                            "(shard_supports_quant)")
        store.place(self.shards, self.shard_size)
        self.quant = store

    def attach_chaos(self, plan) -> None:
        """Hold the fault plan: ``search`` consults it per call — the
        generic ``search`` site, then the ``shard`` site, raising
        ``ShardFault`` for any drawn-dead shard the caller did not already
        exclude via ``shard_alive``."""
        self.chaos = plan

    # ----------------------------------------------------------------- search
    def search(self, Q, k: int = 1, *, budget: Optional[int] = None,
               filter=None, shard_alive=None) -> SearchResult:
        """``shard_alive`` — optional per-shard bool sequence: False shards
        are left out of the merge (their candidates are (-1, +inf) and
        their comparisons 0), the degraded-serving path.  The per-query
        budget split stays S-way, so surviving shards do not inherit the
        dead shard's comparison share."""
        from repro_torch.core import filter as filter_lib
        from repro_torch.core import scan as scan_lib

        S = self.shards
        if shard_alive is not None:
            shard_alive = tuple(bool(a) for a in shard_alive)
            if len(shard_alive) != S:
                raise ValueError(f"shard_alive covers {len(shard_alive)} shards, have {S}")
            if not any(shard_alive):
                raise ValueError("shard_alive: at least one shard must survive")
        if self.chaos is not None:
            self.chaos.on_search()
            excluded = (set() if shard_alive is None else
                        {i for i, a in enumerate(shard_alive) if not a})
            dead = {s for s in self.chaos.dead_shards(S) - excluded if s < S}
            if dead:
                raise chaos_lib.ShardFault(min(dead), n_shards=S)

        budget = resolve(budget, self.search_defaults, "budget")
        filter = resolve(filter, self.search_defaults, "filter")
        dev = self.device
        mask = filter_lib.resolve_mask(filter, self.attrs, self.n, dev)
        base = rem = None
        if budget is not None:
            # the budget is per QUERY: split it so the summed comparisons
            # stay within it (floor 1 per shard); the remainder goes to the
            # first ``rem`` shards, which engines with a per-call budget
            # (infinity's best-first gate) consume; engines with planned
            # knobs (IVF's nprobe, NSW's max_steps) resolve from the floor
            base, rem = divmod(int(budget), S)
            if base == 0:
                base, rem = 1, 0
        Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
        k = int(k)
        traced = budget is not None and getattr(self.engine_cls, "shard_traced_budget", False)
        # engines that size a knob off the filter's selectivity (infinity's
        # scaled rerank width) get the GLOBAL passing fraction, bucketed
        sel = None
        if mask is not None and getattr(self.engine_cls, "shard_uses_selectivity", False):
            sel = filter_lib.bucket_selectivity(
                filter_lib.cached_selectivity(filter, self.attrs, mask))
        alive = shard_alive or (True,) * S
        if not all(alive):
            telem.count("shard_masked_total", sum(1 for a in alive if not a),
                        engine=self.engine)
        with telem.span("shard_dispatch", engine=self.engine, shards=S, sync=dev):
            idx, dist, comps = self._search_shards(
                Q, k=k, base=base, rem=rem or 0, traced=traced, mask=mask, sel=sel,
                alive=alive)
            mdist, midx = scan_lib.merge_topk(dist, idx, k=k)
        return SearchResult(midx, mdist, comps.sum(1).to(torch.int32))

    def _search_shards(self, Q, *, k: int, base: Optional[int], rem: int,
                       traced: bool, mask, sel, alive):
        """Every live shard's (idx, dist, comps) with global ids, stacked as
        (B, S, k), (B, S, k), (B, S); a dead shard contributes (-1, +inf)
        slots and 0 comparisons and runs nothing."""
        B, S, ss = Q.shape[0], self.shards, self.shard_size
        idxs, dists, comps = [], [], []
        for s, state in enumerate(self.shard_views()):
            if not alive[s]:
                idxs.append(torch.full((B, k), -1, dtype=torch.int32, device=Q.device))
                dists.append(torch.full((B, k), math.inf, device=Q.device))
                comps.append(torch.zeros(B, dtype=torch.int32, device=Q.device))
                continue
            extra = {}
            if traced:
                extra["budget_t"] = base + (1 if s < rem else 0)
            if mask is not None:
                extra["valid"] = mask[s * ss:(s + 1) * ss]
                if sel is not None:
                    extra["sel"] = sel
            if self.quant is not None:
                extra["quant"] = self.quant.device_view(shard=s)
            i, d, c = self.engine_cls.shard_search(state, Q, k=k, budget=base,
                                                   static=self.static, **extra)
            idxs.append(torch.where(i >= 0, i + s * ss, -1).to(torch.int32))
            dists.append(d)
            comps.append(c.to(torch.int32))
        return torch.stack(idxs, 1), torch.stack(dists, 1), torch.stack(comps, 1)

    def memory_bytes(self) -> int:
        return pytree_nbytes(self.stacked) + side_store_bytes(self)

    # --------------------------------------------------------------- snapshot
    def snapshot_state(self):
        """(arrays, statics) in the JAX package's layout: the stacked tree
        under ``stacked``, so a JAX snapshot of S shards loads here on one
        device and this one loads in JAX on S devices."""
        statics = {"engine": self.engine, "static": self.static,
                   "shard_size": self.shard_size, "n": self.n,
                   "search_defaults": self.search_defaults}
        return {"stacked": self.stacked}, statics

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "ShardedIndex":
        """Every shard of the snapshot on ``device``, whatever number of
        devices wrote it."""
        dev = resolve_device(device)
        engine = statics["engine"]
        stacked = _tree_map(lambda x: torch.as_tensor(x).to(dev), arrays["stacked"])
        n, shard_size = int(statics["n"]), int(statics["shard_size"])
        return cls(engine=engine, engine_cls=get_index(engine), stacked=stacked,
                   static=dict(statics["static"]), shard_size=shard_size, n=n,
                   dctx=search_policy(Mesh((n // shard_size,), ("data",), dev)),
                   search_defaults=dict(statics.get("search_defaults") or {}))
