"""InfinitySearch — the paper's end-to-end pipeline (Fig. 18), port of
``repro.core.search``.

Build: sample the projection subset S; exact kNN graph of S (``topk``
kernel); dense dissimilarity on S (``pdist`` kernel); sparse canonical
q-projection by path doubling (``qpath`` kernel); fit Phi; embed X; build
the VP tree over the embedding.

Search: embed the queries, then Theorem-1 descent (q = inf, k = 1, no
rerank), the beam over the flattened tree (batches of
``AUTO_BEAM_MIN_BATCH`` or more) or best-first, then rerank the candidates
in the ORIGINAL metric (two-stage search, App. F.5) with a gather, the
metric's pair form and a stable sort.

On a CUDA device the kernels are the default; the CPU runs their plain
versions.  With a ``quant`` store attached (``index.attach_quant_store``)
the beam's bucket scans read int8 codes of the embedding rows and the
rerank prefilters its candidates on the store's codes.

``shard_state`` / ``merge_shard_static`` / ``shard_search`` let
``ShardedIndex`` run the engine over row shards: each shard's X, Z, Phi's
params tree, VP tree and flattened beam state (no quant store: infinity
takes no ``quant=`` shard operand).  ``search`` and ``shard_search`` only
resolve their inputs; ``_infinity_search`` is the one body behind both:
the route, the candidate widths, the traversal and the rerank.

Telemetry (``core/telemetry``): the ``embed``, ``traversal`` and
``rerank`` spans here, the beam's ``traversal`` (its level loop) and
``bucket_scan`` spans inside ``core/vptree.search_beam``, and
``comparisons_total{stage=...}`` per branch, the beam's counted by stage
(``traversal``, ``centroid_rank``, ``bucket_scan``: the centroid ranking
runs inside each level, so it has a counter and no span); a sharded
search records them per shard.  Every device sync that closes a span
(``span(sync=dev)``) and every read-back that feeds a counter runs only
while telemetry is enabled, so the disabled path adds no host sync to a
search; under ``torch.profiler`` the spans are its ranges.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import embedding as embed_lib
from repro_torch.core import filter as filter_lib
from repro_torch.core import index as index_lib
from repro_torch.core import knn_graph as knn_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import qmetric
from repro_torch.core import quant as quant_lib
from repro_torch.core import scan as scan_lib
from repro_torch.core import telemetry as telem
from repro_torch.core import vptree as vptree_lib
from repro_torch.core.index import SearchResult
from repro_torch.device import DeviceLike, resolve_device, sync


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    q: float = math.inf
    metric: str = "euclidean"  # original dissimilarity
    # sparse projection
    knn_k: int = 16
    num_hops: int = 6  # doubling schedule: paths up to 2^num_hops edges
    extra_links: int = 2  # random long-range edges per node (connectivity)
    proj_sample: int = 2048
    # embedding operator
    embed_dim: int = 32
    hidden: tuple[int, ...] = (256, 256)
    train_steps: int = 2000
    batch_pairs: int = 1024
    lr: float = 1e-3
    alpha_t: float = 0.0
    dropout: float = 0.0
    local_frac: float = 0.5
    stress_weight: str = "sammon"
    # embedding validation (held-out pairs vs the canonical projection)
    val_pairs: int = 1024
    val_target: float = 0.0  # 0 = always accept the first fit
    max_retrain: int = 2
    # beam traversal (flattened tree)
    leaf_size: int = 16
    # misc
    seed: int = 0
    #: kept so JAX configs load; the port dispatches by device instead
    impl: str = "jnp"


#: ``mode='auto'`` batch threshold: batches at least this large take the
#: beam traversal, smaller ones best-first
AUTO_BEAM_MIN_BATCH = 64

SEARCH_KEYS = ("mode", "budget", "max_comparisons", "rerank", "beam_width",
               "bucket_cap")


class _StageClock:
    """Seconds per build stage, the device synchronised at each boundary."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


@index_lib.register_index("infinity")
@dataclasses.dataclass
class InfinityIndex:
    """The paper's pipeline: sparse q-metric projection, learned embedding
    Phi, VP-tree search in embedding space, two-stage original-metric
    rerank."""

    config: IndexConfig
    X: torch.Tensor  # (n, d) original vectors
    Z: torch.Tensor  # (n, s) embedded vectors
    phi: embed_lib.Phi
    tree: vptree_lib.VPTree
    train_history: dict
    search_defaults: dict = dataclasses.field(default_factory=dict)
    #: lazily-built beam state: {"flat": FlatVPTree, "Zf": Z[perm],
    #: "zcodes": (int8 codes of Zf, scales) once a quant store is attached}
    _flat: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)
    #: int8 codes of X (``index.attach_quant_store``), or None
    quant: Optional[quant_lib.QuantStore] = dataclasses.field(
        default=None, repr=False, compare=False)

    #: the best-first budget is a per-call gate, so ShardedIndex hands this
    #: engine its exact per-shard share (remainder included)
    shard_traced_budget = True
    #: ShardedIndex passes the filter's (bucketed) global selectivity so the
    #: per-shard rerank width scales as the unsharded search's does
    shard_uses_selectivity = True

    # ------------------------------------------------------------------ build
    @classmethod
    def registry_build(cls, X, cfg=None, *, device: DeviceLike = None) -> "InfinityIndex":
        """Registry entry: cfg is an ``IndexConfig`` or a mapping whose keys
        split into IndexConfig fields and search defaults."""
        if isinstance(cfg, IndexConfig):
            return cls.build(X, cfg, device=device)
        cfg = dict(cfg or {})
        sdef = {k: cfg.pop(k) for k in SEARCH_KEYS if k in cfg}
        fields = {f.name for f in dataclasses.fields(IndexConfig)}
        unknown = set(cfg) - fields
        if unknown:
            raise TypeError(f"infinity: unknown cfg keys {sorted(unknown)}")
        idx = cls.build(X, IndexConfig(**cfg), device=device)
        idx.search_defaults = sdef
        return idx

    @classmethod
    def build(cls, X, config: IndexConfig = IndexConfig(), *,
              device: DeviceLike = None) -> "InfinityIndex":
        """Build the index on ``device`` (default CUDA).
        ``train_history["stage_seconds"]`` records each stage's wall time."""
        dev = resolve_device(device)
        clock = _StageClock(dev)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        n = X.shape[0]
        rng = np.random.default_rng(config.seed)

        # 1) projection subset
        if n > config.proj_sample:
            sub = np.sort(rng.choice(n, size=config.proj_sample, replace=False))
            S = X[torch.as_tensor(sub, device=dev)]
        else:
            S = X
        clock.lap("subset")

        # 2) sparse canonical projection on the subset, with a few random
        # long-range links per node for connectivity
        ns = S.shape[0]
        idx, _ = knn_lib.knn_graph(S, k=min(config.knn_k, ns - 1), metric=config.metric)
        mask = knn_lib.knn_mask(idx, ns)
        if config.extra_links > 0:
            links = torch.as_tensor(
                rng.integers(0, ns, size=(ns, config.extra_links)), device=dev
            )
            mask = mask | knn_lib.knn_mask(links, ns)
        clock.lap("knn_graph")
        D = metrics_lib.pairwise(S, S, metric=config.metric)
        D = torch.where(torch.eye(ns, dtype=torch.bool, device=dev), 0.0, D)
        clock.lap("pdist")
        Dq = qmetric.sparse_canonical_projection(
            D, mask, config.q, num_hops=config.num_hops, schedule="doubling",
        )
        clock.lap("projection")

        # 3) fit Phi, validate it on held-out pairs, retrain while it misses
        # the configured neighbour-overlap target (the best attempt wins)
        ecfg = embed_lib.EmbedConfig(
            in_dim=X.shape[1], out_dim=config.embed_dim, hidden=config.hidden,
            dropout=config.dropout, q=config.q, lr=config.lr,
            steps=config.train_steps, batch_pairs=config.batch_pairs,
            alpha_t=config.alpha_t, seed=config.seed,
            local_frac=config.local_frac, weight=config.stress_weight,
        )
        phi, history = embed_lib.train_embedding(S, Dq, ecfg, knn_idx=idx,
                                                 log_every=100)
        val = _phi_validation(phi, S, Dq, config)
        attempts = 1
        while val["nn_overlap10"] < config.val_target and attempts <= config.max_retrain:
            ecfg2 = dataclasses.replace(ecfg, seed=config.seed + 1000 * attempts)
            phi2, hist2 = embed_lib.train_embedding(S, Dq, ecfg2, knn_idx=idx,
                                                    log_every=100)
            val2 = _phi_validation(phi2, S, Dq, config)
            if val2["nn_overlap10"] > val["nn_overlap10"]:
                phi, history, val = phi2, hist2, val2
            attempts += 1
        history["validation"] = dict(val, attempts=attempts)
        clock.lap("train_phi")

        # 4) embed the full dataset, build the VP tree in embedding space
        Z = embed_lib.apply(phi, X)
        clock.lap("embed")
        tree = vptree_lib.build_vptree(Z.cpu().numpy(), metric="euclidean",
                                       seed=config.seed, device=dev)
        clock.lap("vptree")
        history["stage_seconds"] = clock.seconds
        return cls(config=config, X=X, Z=Z, phi=phi, tree=tree,
                   train_history=history)

    # ----------------------------------------------------------------- search
    def search(
        self,
        Q,
        k: int = 1,
        *,
        mode: Optional[str] = None,
        max_comparisons: Optional[int] = None,
        rerank: Optional[int] = None,
        budget: Optional[int] = None,
        beam_width: Optional[int] = None,
        bucket_cap: Optional[int] = None,
        filter=None,
    ) -> SearchResult:
        """Returns ``SearchResult``: indices (B, k) int32, distances (B, k)
        in the ORIGINAL metric (ascending), comparisons (B,) int32.

        mode: 'descend' (Theorem-1 single path), 'best_first' (Algorithm 2),
        'beam' (level-synchronous traversal of the flattened tree), or
        'auto' = descend for q=inf & k==1 & no rerank, beam for batches of
        at least ``AUTO_BEAM_MIN_BATCH`` queries, else best_first.
        budget: alias of ``max_comparisons`` (a plan for the beam, a gate
        for best-first).  rerank: two-stage width K (0 = off); each
        reranked candidate counts as one comparison.
        filter: predicate spec / (n,) bool mask.  The tree accepts only
        passing candidates (every visit still counts), descent is disabled
        (a single path may hold no passing point), and the two-stage width
        is scaled by the bucketed 1/selectivity so recall holds on narrow
        filters."""
        sd = self.search_defaults
        mode = index_lib.resolve(mode, sd, "mode", "auto")
        if max_comparisons is None:
            budget = index_lib.resolve(budget, sd, "budget")
            max_comparisons = budget if budget is not None else (sd or {}).get("max_comparisons")
        rerank = int(index_lib.resolve(rerank, sd, "rerank", 0))
        filter = index_lib.resolve(filter, sd, "filter")
        attrs = getattr(self, "attrs", None)
        mask = filter_lib.resolve_mask(filter, attrs, self.X.shape[0], self.X.device)
        dev = self.X.device
        Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
        with telem.span("embed", engine="infinity", sync=dev):
            Zq = embed_lib.apply(self.phi, Q)
        sel = None
        if mask is not None and rerank:
            # the fraction is cached per predicate, one host sync each
            sel = filter_lib.bucket_selectivity(
                filter_lib.cached_selectivity(filter, attrs, mask))
        return _infinity_search(
            self.tree, self._flat_view, self.Z, self.X, Zq, Q, q=self.config.q,
            metric=self.config.metric, k=k, mode=mode, rerank=rerank,
            beam_width=index_lib.resolve(beam_width, sd, "beam_width"),
            bucket_cap=index_lib.resolve(bucket_cap, sd, "bucket_cap"),
            plan_budget=max_comparisons, gate_budget=max_comparisons, mask=mask,
            sel=sel, quant=self.quant)

    def _flat_view(self):
        """The lazily-built beam state: the flattened tree, the
        layout-ordered embedding rows and, with a quant store attached,
        their int8 codes.  ``refresh`` returns a new instance, which resets
        it."""
        if self._flat is None:
            flat = vptree_lib.flatten_vptree(
                self.tree, leaf_size=self.config.leaf_size,
                Z=self.Z.cpu().numpy(), metric="euclidean",
            )
            self._flat = {"flat": flat, "Zf": self.Z[flat.perm.long()],
                          "zcodes": None}
        cache = self._flat
        if self.quant is not None and cache["zcodes"] is None:
            # bucket scans read EMBEDDING rows, so they need codes of Zf
            # under their own scales; the store quantizes the ORIGINAL rows
            # for the rerank
            scales = quant_lib.absmax_scales(cache["Zf"], axis=0)
            cache["zcodes"] = (quant_lib.encode(cache["Zf"], scales), scales)
        zc = cache["zcodes"] if self.quant is not None else None
        return cache["flat"], cache["Zf"], zc

    def memory_bytes(self) -> int:
        """Bytes of every resident tensor: X, Z, Phi, the tree, the quant
        store and, once built, the beam state."""
        tree = self.tree
        total = index_lib.pytree_nbytes(
            (self.X, self.Z, self.phi, (tree.vantage, tree.mu, tree.left, tree.right))
        ) + index_lib.side_store_bytes(self)
        if self._flat is not None:
            flat = self._flat["flat"]
            total += index_lib.pytree_nbytes(
                (flat.mu, flat.child_in, flat.child_out, flat.rad_in,
                 flat.rad_out, flat.centroids, flat.bucket_rows, flat.perm,
                 self._flat["Zf"], self._flat["zcodes"])
            )
        return total

    # -------------------------------------------------------------- sharding
    def shard_state(self):
        """(arrays, static) for ``ShardedIndex``, in the JAX package's
        layout: Phi as its params tree, the VP tree, and the flattened beam
        state (pad-safe across shards: the stacker's -1 / +inf fills make
        phantom nodes no child pointer reaches and phantom buckets no node
        points to)."""
        sd = self.search_defaults or {}
        flat, Zf, _ = self._flat_view()
        arrays = {
            "X": self.X, "Z": self.Z, "phi": embed_lib.params_of(self.phi),
            "vantage": self.tree.vantage, "mu": self.tree.mu,
            "left": self.tree.left, "right": self.tree.right,
            "fmu": flat.mu, "fcin": flat.child_in, "fcout": flat.child_out,
            "frin": flat.rad_in, "frout": flat.rad_out, "fcent": flat.centroids,
            "fbuckets": flat.bucket_rows, "fperm": flat.perm, "Zf": Zf,
        }
        static = {
            "q": self.config.q, "metric": self.config.metric,
            "depth": self.tree.depth, "flat_depth": flat.depth,
            "leaf_size": flat.leaf_size, "mode": sd.get("mode", "auto"),
            "rerank": int(sd.get("rerank") or 0),
            "budget": sd.get("budget", sd.get("max_comparisons")),
            "beam_width": sd.get("beam_width"), "bucket_cap": sd.get("bucket_cap"),
        }
        return arrays, static

    @classmethod
    def merge_shard_static(cls, statics: list[dict]) -> dict:
        """Per-shard trees differ only in their depths — take the max (a
        deeper loop bound only iterates on an empty frontier / node -1)."""
        depth_keys = ("depth", "flat_depth")
        merged = dict(statics[0])
        for key in depth_keys:
            merged[key] = max(s[key] for s in statics)
        rest = {k: v for k, v in merged.items() if k not in depth_keys}
        for s in statics[1:]:
            if {k: v for k, v in s.items() if k not in depth_keys} != rest:
                raise ValueError(f"shard statics disagree: {merged} vs {s}")
        return merged

    @classmethod
    def shard_search(cls, state, Q, *, k, budget, static, budget_t=None,
                     valid=None, sel=None):
        """One shard's search.  ``budget`` is the shard's base share of the
        per-query budget, ``budget_t`` its exact share (remainder included)
        for the best-first gate; ``valid`` the shard's rows of the filter
        mask; ``sel`` the GLOBAL bucketed selectivity that sizes the rerank
        width.  The beam plans its knobs from the base share."""
        plan_budget = budget if budget is not None else static.get("budget")
        tree = vptree_lib.VPTree(vantage=state["vantage"], mu=state["mu"],
                                 left=state["left"], right=state["right"],
                                 depth=int(static["depth"]))
        flat = vptree_lib.FlatVPTree(
            mu=state["fmu"], child_in=state["fcin"], child_out=state["fcout"],
            rad_in=state["frin"], rad_out=state["frout"],
            bucket_rows=state["fbuckets"], centroids=state["fcent"],
            perm=state["fperm"], depth=int(static["flat_depth"]),
            leaf_size=int(static["leaf_size"]))
        with telem.span("embed", engine="infinity", sync=Q.device):
            Zq = embed_lib.apply_params(state["phi"], Q)
        return _infinity_search(
            tree, lambda: (flat, state["Zf"], None), state["Z"], state["X"], Zq, Q,
            q=static["q"], metric=static["metric"], k=k, mode=static.get("mode", "auto"),
            rerank=int(static.get("rerank") or 0), beam_width=static.get("beam_width"),
            bucket_cap=static.get("bucket_cap"), plan_budget=plan_budget,
            gate_budget=budget_t if budget_t is not None else plan_budget,
            mask=valid, sel=sel)

    # -------------------------------------------------------------- snapshot
    def snapshot_state(self):
        """(arrays, statics) in the JAX package's layout: Phi as its params
        tree (``convert.params_from_phi``), so either package loads it."""
        from repro_torch import convert

        arrays = {
            "X": self.X, "Z": self.Z, "phi": convert.params_from_phi(self.phi),
            "vantage": self.tree.vantage, "mu": self.tree.mu,
            "left": self.tree.left, "right": self.tree.right,
        }
        statics = {
            "config": dataclasses.asdict(self.config),  # tuples -> lists in JSON
            "depth": self.tree.depth,
            "search_defaults": self.search_defaults,
        }
        return arrays, statics

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "InfinityIndex":
        from repro_torch import convert

        return convert.index_from_jax_state(arrays, statics, device=device)

    # --------------------------------------------------------------- refresh
    def refresh(self, X, *, Z: Optional[torch.Tensor] = None) -> "InfinityIndex":
        """New index over a changed corpus WITHOUT retraining Phi: embed the
        rows (unless ``Z`` is given) and rebuild the VP tree."""
        dev = self.X.device
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        Z = embed_lib.apply(self.phi, X) if Z is None else torch.as_tensor(Z, device=dev)
        tree = vptree_lib.build_vptree(Z.cpu().numpy(), metric="euclidean",
                                       seed=self.config.seed, device=dev)
        return InfinityIndex(
            config=self.config, X=X, Z=Z, phi=self.phi, tree=tree,
            train_history=self.train_history,
            search_defaults=dict(self.search_defaults),
        )


def _route(mode: str, q: float, K: int, batch: int, masked: bool) -> str:
    """The traversal a search takes: ``mode`` itself, or for ``'auto'``
    descent at q = inf with K = 1, the beam for batches of at least
    ``AUTO_BEAM_MIN_BATCH``, else best-first.  A filter rules descent out
    (a single path may hold no passing point)."""
    if not masked and (mode == "descend" or (mode == "auto" and math.isinf(q) and K == 1)):
        return "descend"
    if mode == "beam" or (mode == "auto" and batch >= AUTO_BEAM_MIN_BATCH):
        return "beam"
    return "best_first"


def _count_comps(q: float, **stages) -> None:
    """``comparisons_total{engine=infinity, stage=...}`` per stage, from a
    (B,) device counter (read back) or a host count — only while telemetry
    is enabled, so the disabled path never blocks."""
    if not telem.enabled():
        return
    qs = telem.q_label(q)
    for stage, c in stages.items():
        telem.count("comparisons_total", int(c.sum()) if torch.is_tensor(c) else int(c),
                    engine="infinity", stage=stage, q=qs)


def _rerank(Q: torch.Tensor, idx: torch.Tensor, X: torch.Tensor, *, k: int,
            metric: str, quant: Optional[quant_lib.QuantStore]):
    """Specific search (F.5): original-metric distances to the candidates,
    the best k kept.  With a quant store, a candidate list wider than
    ``quant.shortlist_width(k, n)`` is first cut to that width on int8
    codes, so only the sub-shortlist reads f32 rows."""
    if quant is not None:
        w = quant_lib.shortlist_width(k, X.shape[0])
        if idx.shape[1] > w:
            codes, scales, _ = quant.device_view()
            idx, _ = scan_lib.quant_candidates(Q, idx, codes, scales, k=w, metric=metric)
    return scan_lib.topk_candidates(Q, idx, X, k=k, metric=metric)


def _infinity_search(tree: vptree_lib.VPTree, beam_state, Z: torch.Tensor,
                     X: torch.Tensor, Zq: torch.Tensor, Q: torch.Tensor, *, q: float,
                     metric: str, k: int, mode: str, rerank: int, beam_width, bucket_cap,
                     plan_budget, gate_budget, mask: Optional[torch.Tensor],
                     sel: Optional[float],
                     quant: Optional[quant_lib.QuantStore] = None) -> SearchResult:
    """The engine's search over one tree, behind ``InfinityIndex.search``
    and ``shard_search``: route, candidate width K, traversal in embedding
    space (``Zq``), rerank of the K candidates against ``X`` in the
    ORIGINAL metric.

    ``beam_state()`` gives the beam's (FlatVPTree, layout rows Zf, their
    int8 (codes, scales) or None), asked for only when the beam runs.
    ``plan_budget`` plans the beam's knobs, ``gate_budget`` stops
    best-first.  ``sel`` is the filter's bucketed selectivity (global when
    sharded); ``quant`` the store whose codes prefilter the rerank."""
    k, dev, n = int(k), Zq.device, X.shape[0]
    K = max(k, rerank)
    if mask is not None and rerank:
        # widen the candidate stage by the bucketed 1/selectivity
        K = filter_lib.scaled_width(K, 1.0 if sel is None else sel, n)
    route = _route(mode, q, K, Q.shape[0], mask is not None)
    if route == "beam":
        if rerank:
            # the beam reaches whole buckets: widen the shortlist to at
            # least the 8x-k rule
            K = max(K, quant_lib.shortlist_width(k, n, mult=8))
        flat, Zf, zc = beam_state()
        codes, scales = zc if zc is not None else (None, None)
        idx, _, comps, stages = vptree_lib.search_beam(
            flat, Zq, q=q, k=K, X=Zf, metric="euclidean",
            max_comparisons=None if plan_budget is None else int(plan_budget),
            beam_width=beam_width, bucket_cap=bucket_cap, valid=mask,
            codes=codes, scales=scales, with_stages=True,
        )
    else:
        with telem.span("traversal", engine="infinity", mode=route, sync=dev):
            if route == "descend":
                bi, _, comps = vptree_lib.descend_infty(tree, Zq, X=Z, metric="euclidean")
                idx = bi[:, None]
            else:
                idx, _, comps = vptree_lib.search_best_first(
                    tree, Zq, q=q, k=K, X=Z, metric="euclidean",
                    max_comparisons=gate_budget, valid=mask)
        stages = {"traversal": comps}
    _count_comps(q, **stages)
    if rerank and K > k:
        with telem.span("rerank", engine="infinity", sync=dev):
            idx, dists = _rerank(Q, idx, X, k=k, metric=metric, quant=quant)
        # each reranked candidate costs one original-metric comparison
        _count_comps(q, rerank=K * idx.shape[0])
        comps = comps + K
    else:
        # the k survivors are scored in the ORIGINAL metric and returned
        # ascending; comps keeps counting tree visits only
        idx, dists = _rerank(Q, idx[:, :k], X, k=k, metric=metric, quant=quant)
    return SearchResult(idx, dists, comps.int())


def _phi_validation(phi, S: torch.Tensor, Dq: torch.Tensor, config: IndexConfig) -> dict:
    """Held-out check that Phi reproduces the canonical projection's
    geometry (host numpy, as in the JAX package): Pearson correlation of
    embedding vs projected distances on ``val_pairs`` random finite pairs,
    and the mean top-10 neighbour overlap over up to 64 anchors."""
    ZS = embed_lib.apply(phi, S).cpu().numpy()
    Dq = Dq.cpu().numpy()
    ns = ZS.shape[0]
    rng = np.random.default_rng(config.seed + 17)
    npairs = max(int(config.val_pairs), 1)
    ii = rng.integers(0, ns, size=npairs)
    jj = rng.integers(0, ns, size=npairs)
    keep = (ii != jj) & np.isfinite(Dq[ii, jj])
    ii, jj = ii[keep], jj[keep]
    corr = 0.0
    if ii.size >= 2:
        e = np.sqrt(np.maximum(((ZS[ii] - ZS[jj]) ** 2).sum(-1), 0.0))
        t = Dq[ii, jj]
        if e.std() > 1e-12 and t.std() > 1e-12:
            corr = float(np.corrcoef(e, t)[0, 1])
    anchors = rng.choice(ns, size=min(64, ns), replace=False)
    kk = min(10, ns - 1)
    overlap = 0.0
    for a in anchors:
        row = Dq[a].copy()
        row[a] = np.inf
        row = np.where(np.isfinite(row), row, np.inf)
        true_nn = np.argpartition(row, kk - 1)[:kk]
        erow = np.sqrt(np.maximum(((ZS - ZS[a]) ** 2).sum(-1), 0.0))
        erow[a] = np.inf
        est_nn = np.argpartition(erow, kk - 1)[:kk]
        overlap += len(set(true_nn.tolist()) & set(est_nn.tolist())) / kk
    overlap /= max(len(anchors), 1)
    return {"pair_corr": corr, "nn_overlap10": float(overlap),
            "val_pairs": int(ii.size)}
