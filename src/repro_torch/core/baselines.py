"""ANN baselines the paper compares against (§5.1, App. F.7) — port of
``repro.core.baselines``:

* ``brute_force`` / ``BruteIndex`` — exact blocked top-k (the ground-truth
  oracle), f32 or quantized two-stage;
* ``IVFFlat`` — k-means coarse quantizer + probed exact scoring;
* ``IVFPQ`` — IVF + product quantization with ADC lookup tables;
* ``NSWGraph`` — greedy beam search over a kNN graph with random long
  links.

Every engine takes ``search(..., filter=)``: a predicate spec compiled
against its attribute store (the registry's ``attrs`` key) or a raw
``(n,)`` bool mask, ANDed into its candidate validity.  On the card the
scans go through the topk kernels (masked where filtered), k-means and the
coarse probes through the pdist kernel, and the NSW graph through the topk
kernel with ``exclude_self``; the CPU runs their plain versions.

Selections reproduce the JAX package's tie order: ``lax.top_k`` and
``jnp.argsort`` keep the lowest index on ties, so every selection here is a
stable sort.  The k-means seeding draws from ``torch.Generator(seed)``
where JAX draws from ``PRNGKey(seed)``; ``_lloyd`` takes any initial
centroids, so both packages can be held to the same start.

Each engine exposes ``shard_state`` (its state tree and static knobs) and
``shard_search`` (a search over one shard's slice of ``ShardedIndex``'s
stack, taking the shard's rows of a filter mask as ``valid=``; brute and
IVF-Flat also take ``quant=(codes, scales, sqnorms)``, the shard's code
and sq-norm rows with the shared scales).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import filter as filter_lib
from repro_torch.core import index as index_lib
from repro_torch.core import knn_graph as knn_lib
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import scan as scan_lib
from repro_torch.core.index import SearchResult
from repro_torch.device import DeviceLike, resolve_device

INF = float("inf")


def _mask(inst, filter) -> Optional[torch.Tensor]:
    """The engine's filter (explicit or its search default) as a (n,) bool
    mask on the engine's device, or None."""
    filter = index_lib.resolve(filter, inst.search_defaults, "filter")
    return filter_lib.resolve_mask(filter, getattr(inst, "attrs", None),
                                   inst.X.shape[0], inst.X.device)


def _tensor(arrays, key: str, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(arrays[key], dtype), device=dev)


def _smallest(vals: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``count`` smallest entries of each row and their positions, ties
    to the lowest position (``lax.top_k`` on the negated row)."""
    order = torch.sort(vals, dim=1, stable=True).indices[:, :count]
    return vals.gather(1, order), order


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------

def _scanned(valid: Optional[torch.Tensor], n: int, B: int, dev) -> torch.Tensor:
    """(B,) int32 rows a scan scores: n, or the passing rows under a mask."""
    if valid is None:
        return torch.full((B,), n, dtype=torch.int32, device=dev)
    return valid.sum().to(torch.int32).expand(B)


def brute_force(X: torch.Tensor, Q: torch.Tensor, *, k: int = 1,
                metric: str = "euclidean", block: int = 0,
                valid: Optional[torch.Tensor] = None) -> SearchResult:
    """Exact search: SearchResult (idx (B, k), dist (B, k), comps (B,)),
    streamed over X by ``core/scan`` (the topk kernel on the card), so the
    (B, n) score matrix never exists.  ``valid`` (n,) bool restricts the
    candidates (the kernel's masked regime): the answer is that of a scan
    over the passing sub-corpus, and comparisons count the passing rows."""
    dists, idx = scan_lib.topk_scan(Q, X, k=k, metric=metric, valid=valid,
                                    block=block or scan_lib.DEFAULT_BLOCK)
    return SearchResult(idx, dists, _scanned(valid, X.shape[0], Q.shape[0], Q.device))


def _brute_quant_search(Q, codes, scales, sqnorms, X, *, k: int, K: int,
                        metric: str, block: int,
                        valid: Optional[torch.Tensor] = None) -> SearchResult:
    """Quantized two-stage brute scan: the first pass over int8 codes (the
    int8 kernel on the card for the euclidean family, masked under a
    filter) keeps the ``K = quant.shortlist_width(k, n)`` best, the
    shortlist is re-scored exactly in f32 (``topk_candidates``) and the best
    k survive.  Comparisons count both stages: n code scores (the passing
    rows under a filter) + K exact re-scores."""
    _, qpos = scan_lib.topk_scan_quant(
        Q, codes, scales, k=K, metric=metric, sqnorms=sqnorms, valid=valid,
        block=block or scan_lib.DEFAULT_BLOCK,
    )
    idx, dists = scan_lib.topk_candidates(Q, qpos, X, k=k, metric=metric)
    comps = _scanned(valid, codes.shape[0], Q.shape[0], Q.device) + K
    return SearchResult(idx, dists, comps)


@index_lib.register_index("brute")
@dataclasses.dataclass
class BruteIndex:
    """The exact oracle behind the uniform contract (budget is ignored — a
    brute scan always pays n comparisons per query).  With a ``quant``
    store attached (the registry's ``quant`` cfg key) the scan becomes the
    quantized two-stage: int8 first pass, exact f32 rerank of the pow2
    shortlist."""

    X: torch.Tensor
    metric: str = "euclidean"
    #: kept so JAX configs and snapshots load; the port dispatches by device
    impl: str = "jnp"
    block: int = 0
    search_defaults: dict = dataclasses.field(default_factory=dict)
    quant: Optional[quant_lib.QuantStore] = None

    #: ShardedIndex may hand this engine per-shard code slices
    shard_supports_quant = True

    @classmethod
    def build(cls, X, *, metric: str = "euclidean", impl: str = "jnp",
              block: int = 0, device: DeviceLike = None) -> "BruteIndex":
        """Hold X on ``device`` (default CUDA)."""
        X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
        return cls(X=X, metric=metric, impl=impl, block=block)

    def search(self, Q, k: int = 1, *, budget: Optional[int] = None,
               filter=None) -> SearchResult:
        mask = _mask(self, filter)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)
        k = int(k)
        if self.quant is not None:
            codes, scales, sqnorms = self.quant.device_view()
            return _brute_quant_search(
                Q, codes, scales, sqnorms, self.X, k=k,
                K=quant_lib.shortlist_width(k, self.X.shape[0]),
                metric=self.metric, block=self.block, valid=mask,
            )
        return brute_force(self.X, Q, k=k, metric=self.metric, block=self.block,
                           valid=mask)

    def memory_bytes(self) -> int:
        return index_lib.pytree_nbytes(self.X) + index_lib.side_store_bytes(self)

    def snapshot_state(self):
        return {"X": self.X}, {
            "metric": self.metric, "impl": self.impl, "block": self.block,
            "search_defaults": self.search_defaults,
        }

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "BruteIndex":
        X = _tensor(arrays, "X", np.float32, resolve_device(device))
        return cls(X=X, metric=statics["metric"], impl=statics["impl"],
                   block=int(statics["block"]),
                   search_defaults=dict(statics.get("search_defaults") or {}))

    def shard_state(self):
        return {"X": self.X}, {"metric": self.metric, "impl": self.impl, "block": self.block}

    @classmethod
    def shard_search(cls, state, Q, *, k, budget, static, valid=None, quant=None):
        X = state["X"]
        if quant is not None:
            codes, scales, sqnorms = quant
            res = _brute_quant_search(
                Q, codes, scales, sqnorms, X, k=k,
                K=quant_lib.shortlist_width(k, X.shape[0]), metric=static["metric"],
                block=static["block"], valid=valid)
        else:
            res = brute_force(X, Q, k=k, metric=static["metric"], block=static["block"],
                              valid=valid)
        return res.idx, res.dist, res.comparisons


# ---------------------------------------------------------------------------
# k-means (shared by the IVF engines)
# ---------------------------------------------------------------------------

def _lloyd(X: torch.Tensor, init: torch.Tensor, iters: int,
           metric: str = "sqeuclidean") -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's iterations from the centroids ``init`` (C, d); returns
    (centroids (C, d), assignment (n,) int64).  Distances go through
    ``metrics.pairwise`` (the pdist kernel on the card); an empty cluster
    keeps its centroid.  The sums are one f32 matmul of the one-hot
    assignment, as in the JAX package: it runs in full f32 while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (torch's default)."""
    cents = init.float()
    C = cents.shape[0]
    for _ in range(int(iters)):
        assign = metrics_lib.pairwise(X, cents, metric=metric).argmin(1)
        one_hot = torch.nn.functional.one_hot(assign, C).to(X.dtype)
        counts = one_hot.sum(0)[:, None]
        new = (one_hot.T @ X) / counts.clamp_min(1.0)
        cents = torch.where(counts > 0, new, cents)
    assign = metrics_lib.pairwise(X, cents, metric=metric).argmin(1)
    return cents, assign


def kmeans(X: torch.Tensor, *, num_clusters: int, iters: int = 10,
           metric: str = "sqeuclidean", seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from ``num_clusters`` distinct rows drawn by
    ``torch.Generator().manual_seed(seed)``; returns (centroids (C, d),
    assignment (n,) int64)."""
    gen = torch.Generator().manual_seed(int(seed))
    init = torch.randperm(X.shape[0], generator=gen)[:num_clusters].to(X.device)
    return _lloyd(X, X[init], iters, metric)


def _build_lists(assign: np.ndarray, num_clusters: int) -> tuple[np.ndarray, np.ndarray]:
    """Padded inverted lists: (C, Lmax) member indices (-1 pad) + lengths."""
    lists = [np.where(assign == c)[0] for c in range(num_clusters)]
    lmax = max(1, max(len(l) for l in lists))
    padded = np.full((num_clusters, lmax), -1, np.int32)
    lens = np.zeros((num_clusters,), np.int32)
    for c, l in enumerate(lists):
        padded[c, :len(l)] = l
        lens[c] = len(l)
    return padded, lens


def _resolve_nprobe(nprobe: Optional[int], budget: Optional[int], *, n: int,
                    num_clusters: int, default: int = 4) -> int:
    """The one IVF probe policy (Flat and PQ): explicit nprobe wins; else a
    comparison budget converts via "probing one list costs ~n/C scored
    candidates"; else ``default``.  Always clamped to [1, C]."""
    if nprobe is None and budget is not None:
        per_list = max(1, -(-n // num_clusters))
        nprobe = int(budget) // per_list
    if nprobe is None:
        nprobe = default
    return max(1, min(num_clusters, int(nprobe)))


def _passing(lists: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Ids that fail the filter become -1 padding, at the source, so the
    scoring, the comparison count and any shortlist see passing rows
    only."""
    if valid is None:
        return lists
    return torch.where(valid[lists.long().clamp_min(0)] & (lists >= 0), lists, -1)


# ---------------------------------------------------------------------------
# IVF-Flat
# ---------------------------------------------------------------------------

@index_lib.register_index("ivf_flat")
@dataclasses.dataclass
class IVFFlat:
    """k-means coarse quantizer + probed exact scoring (FAISS IVF-Flat
    semantics); nprobe trades recall for comparisons.  With a ``quant``
    store attached, probed members are first scored on int8 codes and only
    the pow2 shortlist is re-scored in f32."""

    X: torch.Tensor
    centroids: torch.Tensor
    lists: torch.Tensor  # (C, Lmax) int32, -1 padded
    list_lens: torch.Tensor
    metric: str
    search_defaults: dict = dataclasses.field(default_factory=dict)
    quant: Optional[quant_lib.QuantStore] = None

    #: ShardedIndex may hand this engine per-shard code slices
    shard_supports_quant = True

    @classmethod
    def build(cls, X, *, num_clusters: int = 64, iters: int = 10,
              metric: str = "euclidean", seed: int = 0,
              device: DeviceLike = None) -> "IVFFlat":
        dev = resolve_device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        cents, assign = kmeans(X, num_clusters=num_clusters, iters=iters, seed=seed)
        lists, lens = _build_lists(assign.cpu().numpy(), num_clusters)
        return cls(X=X, centroids=cents, lists=torch.as_tensor(lists, device=dev),
                   list_lens=torch.as_tensor(lens, device=dev), metric=metric)

    def search(self, Q, k: int = 1, *, nprobe: Optional[int] = None,
               budget: Optional[int] = None, filter=None) -> SearchResult:
        nprobe = _resolve_nprobe(
            index_lib.resolve(nprobe, self.search_defaults, "nprobe"),
            index_lib.resolve(budget, self.search_defaults, "budget"),
            n=self.X.shape[0], num_clusters=self.centroids.shape[0],
        )
        mask = _mask(self, filter)
        quant = None
        if self.quant is not None:
            codes, scales, _ = self.quant.device_view()
            quant = (codes, scales)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)
        return SearchResult(*_ivf_flat_search(
            self.X, self.centroids, self.lists, Q, k=int(k), nprobe=nprobe,
            metric=self.metric, valid=mask, quant=quant))

    def memory_bytes(self) -> int:
        return index_lib.pytree_nbytes(
            (self.X, self.centroids, self.lists, self.list_lens)
        ) + index_lib.side_store_bytes(self)

    def snapshot_state(self):
        return ({"X": self.X, "centroids": self.centroids, "lists": self.lists,
                 "list_lens": self.list_lens},
                {"metric": self.metric, "search_defaults": self.search_defaults})

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "IVFFlat":
        dev = resolve_device(device)
        return cls(
            X=_tensor(arrays, "X", np.float32, dev),
            centroids=_tensor(arrays, "centroids", np.float32, dev),
            lists=_tensor(arrays, "lists", np.int32, dev),
            list_lens=_tensor(arrays, "list_lens", np.int32, dev),
            metric=statics["metric"],
            search_defaults=dict(statics.get("search_defaults") or {}),
        )

    def shard_state(self):
        sd = self.search_defaults or {}
        static = {"metric": self.metric, "nprobe": sd.get("nprobe"),
                  "budget": sd.get("budget")}
        return ({"X": self.X, "centroids": self.centroids, "lists": self.lists,
                 "list_lens": self.list_lens}, static)

    @classmethod
    def shard_search(cls, state, Q, *, k, budget, static, valid=None, quant=None):
        nprobe = _resolve_nprobe(
            static.get("nprobe"), budget if budget is not None else static.get("budget"),
            n=state["X"].shape[0], num_clusters=state["centroids"].shape[0])
        return _ivf_flat_search(
            state["X"], state["centroids"], state["lists"], Q, k=k, nprobe=nprobe,
            metric=static["metric"], valid=valid,
            quant=None if quant is None else quant[:2])


def _ivf_flat_search(X, cents, lists, Q, *, k: int, nprobe: int, metric: str,
                     valid: Optional[torch.Tensor] = None, quant=None):
    """Probe the ``nprobe`` nearest lists, score their (passing) members
    exactly, keep k.  With ``quant`` (codes, scales), members are first cut
    to ``shortlist_width(k, n)`` on int8 codes when that is narrower than
    the gathered lists.  Returns (idx, dist, comps)."""
    B = Q.shape[0]
    _, probe = _smallest(metrics_lib.pairwise(Q, cents, metric=metric), nprobe)
    cand = _passing(lists[probe].reshape(B, -1), valid)  # (B, nprobe * Lmax)
    comps = (cand >= 0).sum(1)
    if quant is not None:
        w = quant_lib.shortlist_width(k, X.shape[0])
        if w < cand.shape[1]:
            cand, _ = scan_lib.quant_candidates(Q, cand, *quant, k=w, metric=metric)
            comps = comps + w
    idx, dist = scan_lib.topk_candidates(Q, cand, X, k=k, metric=metric)
    return idx, dist, comps.to(torch.int32)


# ---------------------------------------------------------------------------
# IVF-PQ (ADC)
# ---------------------------------------------------------------------------

@index_lib.register_index("ivf_pq")
@dataclasses.dataclass
class IVFPQ:
    """IVF + product quantization with ADC lookup tables (Jégou et al.
    2011); optional exact rerank of the ADC shortlist."""

    X: torch.Tensor
    centroids: torch.Tensor  # coarse (C, d)
    codebooks: torch.Tensor  # (M, ksub, dsub)
    codes: torch.Tensor  # (n, M) int32 PQ codes of the residuals
    lists: torch.Tensor
    list_lens: torch.Tensor
    metric: str
    search_defaults: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, X, *, num_clusters: int = 64, M: int = 8, ksub: int = 32,
              iters: int = 10, metric: str = "euclidean", seed: int = 0,
              device: DeviceLike = None) -> "IVFPQ":
        """PQ on residuals (x - coarse centroid): M subspaces, ksub
        centroids each (<= 256), subspace m seeded ``seed + m + 1``."""
        dev = resolve_device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        n, d = X.shape
        if d % M:
            raise ValueError(f"ivf_pq: d = {d} is not a multiple of M = {M}")
        cents, assign = kmeans(X, num_clusters=num_clusters, iters=iters, seed=seed)
        sub = (X - cents[assign]).reshape(n, M, d // M)
        books, codes = [], []
        for m in range(M):
            cb, cd = kmeans(sub[:, m].contiguous(), num_clusters=ksub, iters=iters,
                            seed=seed + m + 1)
            books.append(cb)
            codes.append(cd)
        lists, lens = _build_lists(assign.cpu().numpy(), num_clusters)
        return cls(X=X, centroids=cents, codebooks=torch.stack(books),
                   codes=torch.stack(codes, dim=1).to(torch.int32),
                   lists=torch.as_tensor(lists, device=dev),
                   list_lens=torch.as_tensor(lens, device=dev), metric=metric)

    def search(self, Q, k: int = 1, *, nprobe: Optional[int] = None,
               rerank: Optional[int] = None, budget: Optional[int] = None,
               filter=None) -> SearchResult:
        nprobe = _resolve_nprobe(
            index_lib.resolve(nprobe, self.search_defaults, "nprobe"),
            index_lib.resolve(budget, self.search_defaults, "budget"),
            n=self.X.shape[0], num_clusters=self.centroids.shape[0],
        )
        rerank = int(index_lib.resolve(rerank, self.search_defaults, "rerank", 0))
        mask = _mask(self, filter)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)
        return SearchResult(*_ivf_pq_search(
            self.X, self.centroids, self.codebooks, self.codes, self.lists, Q,
            k=int(k), nprobe=nprobe, rerank=rerank, metric=self.metric, valid=mask))

    def memory_bytes(self) -> int:
        return index_lib.pytree_nbytes(
            (self.X, self.centroids, self.codebooks, self.codes, self.lists,
             self.list_lens)
        ) + index_lib.side_store_bytes(self)

    def snapshot_state(self):
        return ({"X": self.X, "centroids": self.centroids, "codebooks": self.codebooks,
                 "codes": self.codes, "lists": self.lists, "list_lens": self.list_lens},
                {"metric": self.metric, "search_defaults": self.search_defaults})

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "IVFPQ":
        dev = resolve_device(device)
        return cls(
            X=_tensor(arrays, "X", np.float32, dev),
            centroids=_tensor(arrays, "centroids", np.float32, dev),
            codebooks=_tensor(arrays, "codebooks", np.float32, dev),
            codes=_tensor(arrays, "codes", np.int32, dev),
            lists=_tensor(arrays, "lists", np.int32, dev),
            list_lens=_tensor(arrays, "list_lens", np.int32, dev),
            metric=statics["metric"],
            search_defaults=dict(statics.get("search_defaults") or {}),
        )

    def shard_state(self):
        sd = self.search_defaults or {}
        static = {"metric": self.metric, "nprobe": sd.get("nprobe"),
                  "rerank": int(sd.get("rerank") or 0), "budget": sd.get("budget")}
        return ({"X": self.X, "centroids": self.centroids, "codebooks": self.codebooks,
                 "codes": self.codes, "lists": self.lists, "list_lens": self.list_lens},
                static)

    @classmethod
    def shard_search(cls, state, Q, *, k, budget, static, valid=None):
        nprobe = _resolve_nprobe(
            static.get("nprobe"), budget if budget is not None else static.get("budget"),
            n=state["X"].shape[0], num_clusters=state["centroids"].shape[0])
        return _ivf_pq_search(
            state["X"], state["centroids"], state["codebooks"], state["codes"],
            state["lists"], Q, k=k, nprobe=nprobe, rerank=int(static.get("rerank") or 0),
            metric=static["metric"], valid=valid)


def _ivf_pq_search(X, cents, books, codes, lists, Q, *, k: int, nprobe: int,
                   rerank: int, metric: str, valid: Optional[torch.Tensor] = None):
    """ADC: per (query, probed list) a table of the query residual's squared
    distance to every subspace centroid (elementwise form); a member's
    distance is the sum of its M table entries, in subspace order.  The
    ``max(k, rerank)`` smallest are kept (and exactly re-scored with
    ``rerank``).  ``comps`` counts the finite ADC entries, i.e. the passing
    members scored.  Returns (idx, dist, comps)."""
    M, _, dsub = books.shape
    lists = _passing(lists, valid)
    _, probe = _smallest(metrics_lib.pairwise(Q, cents, metric="sqeuclidean"), nprobe)
    kk = max(k, rerank)

    def adc_shortlist(q, p):
        b = q.shape[0]
        r = (q[:, None, :] - cents[p]).reshape(b, nprobe, M, 1, dsub)
        lut = ((r - books) ** 2).sum(-1)  # (b, nprobe, M, ksub)
        members = lists[p].long()  # (b, nprobe, Lmax)
        mcodes = codes[members.clamp_min(0)].long().transpose(2, 3)  # (b, nprobe, M, Lmax)
        g = lut.gather(3, mcodes)
        adc = g[:, :, 0]
        for m in range(1, M):
            adc = adc + g[:, :, m]
        adc = torch.where(members >= 0, adc, INF).reshape(b, -1)
        mem = members.reshape(b, -1)
        if adc.shape[1] < kk:  # fewer probed slots than the shortlist
            adc = torch.nn.functional.pad(adc, (0, kk - adc.shape[1]), value=INF)
            mem = torch.nn.functional.pad(mem, (0, kk - mem.shape[1]), value=-1)
        dist, pos = _smallest(adc, kk)
        return mem.gather(1, pos), dist, torch.isfinite(adc).sum(1)

    L = lists.shape[1]
    row_bytes = 4 * nprobe * books.shape[1] * Q.shape[1] + 20 * nprobe * M * L
    cand, adc, comps = scan_lib.in_chunks(adc_shortlist, row_bytes, Q, probe)
    if rerank:
        idx, dist = scan_lib.topk_candidates(Q, cand, X, k=k, metric=metric)
        return idx, dist, comps.to(torch.int32)
    return cand[:, :k].to(torch.int32), adc[:, :k], comps.to(torch.int32)


# ---------------------------------------------------------------------------
# NSW graph beam search
# ---------------------------------------------------------------------------

#: NSW steps between two host checks that a query is still running (the
#: answers do not depend on it: a finished query's state is frozen)
NSW_SYNC_EVERY = 8


@index_lib.register_index("nsw")
@dataclasses.dataclass
class NSWGraph:
    """Greedy beam search over a kNN graph with random long-range links
    (the navigable-small-world core of HNSW, single layer)."""

    X: torch.Tensor
    neighbors: torch.Tensor  # (n, deg) int32
    metric: str
    entry: int
    search_defaults: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, X, *, degree: int = 16, random_links: int = 4,
              metric: str = "euclidean", seed: int = 0,
              device: DeviceLike = None) -> "NSWGraph":
        """kNN edges (the topk kernel, self excluded) + ``random_links``
        uniform long-range links per node and the entry point, both drawn
        from ``np.random.default_rng(seed)`` as in the JAX package."""
        dev = resolve_device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        n = X.shape[0]
        idx, _ = knn_lib.knn_graph(X, k=degree, metric=metric)
        rng = np.random.default_rng(seed)
        if random_links > 0:
            extra = rng.integers(0, n, size=(n, random_links))
            idx = torch.cat([idx, torch.as_tensor(extra, dtype=torch.int32, device=dev)], 1)
        return cls(X=X, neighbors=idx, metric=metric, entry=int(rng.integers(n)))

    def search(self, Q, k: int = 1, *, ef: Optional[int] = None,
               max_steps: Optional[int] = None, budget: Optional[int] = None,
               filter=None) -> SearchResult:
        ef, max_steps = self._resolve_beam(
            int(k),
            index_lib.resolve(ef, self.search_defaults, "ef"),
            index_lib.resolve(max_steps, self.search_defaults, "max_steps"),
            index_lib.resolve(budget, self.search_defaults, "budget"),
            deg=self.neighbors.shape[1],
        )
        mask = _mask(self, filter)
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)
        return SearchResult(*_nsw_search(
            self.X, self.neighbors, Q, self.entry, k=int(k), ef=ef,
            max_steps=max_steps, metric=self.metric, valid=mask))

    @staticmethod
    def _resolve_beam(k, ef, max_steps, budget, *, deg) -> tuple[int, int]:
        """The one beam policy: explicit knobs win; else a budget converts
        via "each expansion scores <= deg fresh neighbours"."""
        ef = 32 if ef is None else int(ef)
        if max_steps is None and budget is not None:
            max_steps = max(1, int(budget) // max(1, deg))
        return max(ef, int(k)), int(max_steps if max_steps is not None else 64)

    def memory_bytes(self) -> int:
        return index_lib.pytree_nbytes((self.X, self.neighbors)) \
            + index_lib.side_store_bytes(self)

    def snapshot_state(self):
        return ({"X": self.X, "neighbors": self.neighbors},
                {"metric": self.metric, "entry": int(self.entry),
                 "search_defaults": self.search_defaults})

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "NSWGraph":
        dev = resolve_device(device)
        return cls(
            X=_tensor(arrays, "X", np.float32, dev),
            neighbors=_tensor(arrays, "neighbors", np.int32, dev),
            metric=statics["metric"], entry=int(statics["entry"]),
            search_defaults=dict(statics.get("search_defaults") or {}),
        )

    def shard_state(self):
        sd = self.search_defaults or {}
        static = {"metric": self.metric, "ef": sd.get("ef"),
                  "max_steps": sd.get("max_steps"), "budget": sd.get("budget")}
        entry = torch.tensor(self.entry, dtype=torch.int32, device=self.X.device)
        return {"X": self.X, "neighbors": self.neighbors, "entry": entry}, static

    @classmethod
    def shard_search(cls, state, Q, *, k, budget, static, valid=None):
        ef, max_steps = cls._resolve_beam(
            k, static.get("ef"), static.get("max_steps"),
            budget if budget is not None else static.get("budget"),
            deg=state["neighbors"].shape[1])
        return _nsw_search(state["X"], state["neighbors"], Q, int(state["entry"]), k=k,
                           ef=ef, max_steps=max_steps, metric=static["metric"],
                           valid=valid)


def _nsw_search(X, neighbors, Q, entry: int, *, k: int, ef: int, max_steps: int,
                metric: str, valid: Optional[torch.Tensor] = None):
    """Greedy best-first beam (HNSW layer-0 semantics), the whole batch in
    lockstep: the frontier holds the ef best visited nodes; each step
    expands every running query's best unexpanded node.  A query stops on
    its own (nothing left to expand, or ``max_steps``) and its state is
    frozen from then on, as under the JAX package's ``vmap``-ed
    ``while_loop``.  Neighbours are scored in the metric's elementwise
    form.

    ``valid`` (n,) bool: the beam navigates over every node while a
    separate result buffer collects the best passing nodes seen (each node
    is evaluated once, so it enters the buffer at most once; comps counts
    every evaluation).  Returns (idx, dist, comps)."""
    n, deg = neighbors.shape
    B = Q.shape[0]
    dev = Q.device
    pair = metrics_lib.pair_fn(metric)
    nbr_ids = neighbors.long()
    rows = torch.arange(B, device=dev)
    slots = torch.arange(ef, device=dev)
    pos = torch.arange(deg, device=dev)
    earlier = pos[None, :] < pos[:, None]  # [i, j]: j comes before i in a row

    cand_i = torch.full((B, ef), -1, dtype=torch.long, device=dev)
    cand_i[:, 0] = entry
    cand_d = torch.full((B, ef), INF, device=dev)
    cand_d[:, 0] = pair(Q, X[entry])
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((B, n), dtype=torch.bool, device=dev)
    visited[:, entry] = True
    comps = torch.ones(B, dtype=torch.long, device=dev)
    if valid is not None:  # the passing-node buffer, seeded with a passing entry
        res_i = torch.where(valid[entry], cand_i, -1)
        res_d = torch.where(valid[entry], cand_d, INF)
    for step in range(int(max_steps)):
        open_ = (cand_i >= 0) & ~expanded
        active = open_.any(1)
        if step % NSW_SYNC_EVERY == 0 and not bool(active.any()):
            break
        d_mask = torch.where(open_, cand_d, INF)
        # the first slot holding the minimum (jnp.argmin's rule)
        b = torch.where(d_mask == d_mask.min(1, keepdim=True).values, slots, ef).min(1).values
        node = cand_i[rows, b]
        exp_new = expanded.clone()
        exp_new[rows, b] = True
        nbrs = nbr_ids[node.clamp_min(0)]  # (B, deg) ids as stored
        at = torch.where(nbrs < 0, nbrs + n, nbrs)  # JAX wraps negative indices
        # a row can list a node twice (a long link duplicating a kNN edge):
        # only its first occurrence is fresh
        dup = ((nbrs[:, None, :] == nbrs[:, :, None]) & earlier).any(2)
        fresh = ~visited.gather(1, at) & ~dup
        # a finished query's visited set is never read again
        visited.scatter_(1, at, True)
        nd = torch.where(fresh, pair(Q[:, None, :], X[at]), INF)
        comps = torch.where(active, comps + fresh.sum(1), comps)
        if valid is not None:
            rd = torch.cat([res_d, torch.where(valid[at], nd, INF)], 1)
            ri = torch.cat([res_i, nbrs], 1)
            keep = torch.sort(rd, dim=1, stable=True).indices[:, :ef]
            res_i = torch.where(active[:, None], ri.gather(1, keep), res_i)
            res_d = torch.where(active[:, None], rd.gather(1, keep), res_d)
        all_i = torch.cat([cand_i, nbrs], 1)
        all_d = torch.cat([cand_d, nd], 1)
        all_e = torch.cat([exp_new, torch.zeros_like(fresh)], 1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
        cand_i = torch.where(active[:, None], all_i.gather(1, order), cand_i)
        cand_d = torch.where(active[:, None], all_d.gather(1, order), cand_d)
        expanded = torch.where(active[:, None], all_e.gather(1, order), expanded)
    if valid is None:
        out_i, out_d = cand_i, cand_d
    else:  # answers come from the passing-node buffer, not the frontier
        out_i, out_d = torch.where(torch.isinf(res_d), -1, res_i), res_d
    return out_i[:, :k].to(torch.int32), out_d[:, :k], comps.to(torch.int32)
