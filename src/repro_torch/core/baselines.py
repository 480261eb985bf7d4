"""Exact brute-force search — the part of ``repro.core.baselines`` the port
serves: ``brute_force``, the quantized two-stage ``_brute_quant_search``
and the registered ``BruteIndex`` (the ground-truth oracle behind the
uniform contract).  k-means, IVF and NSW are not ported yet; neither are
filters (``search(filter=...)`` raises) nor ``shard_state`` /
``shard_search`` (they wait for ``ShardedIndex``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import scan as scan_lib
from repro_torch.core.index import SearchResult
from repro_torch.device import DeviceLike, resolve_device


def brute_force(X: torch.Tensor, Q: torch.Tensor, *, k: int = 1,
                metric: str = "euclidean", block: int = 0) -> SearchResult:
    """Exact search: SearchResult (idx (B, k), dist (B, k), comps (B,)),
    streamed over X by ``core/scan`` (the topk kernel on the card), so the
    (B, n) score matrix never exists.  Every query pays n comparisons."""
    dists, idx = scan_lib.topk_scan(Q, X, k=k, metric=metric,
                                    block=block or scan_lib.DEFAULT_BLOCK)
    comps = torch.full((Q.shape[0],), X.shape[0], dtype=torch.int32, device=Q.device)
    return SearchResult(idx, dists, comps)


def _brute_quant_search(Q, codes, scales, sqnorms, X, *, k: int, K: int,
                        metric: str, block: int) -> SearchResult:
    """Quantized two-stage brute scan: the first pass over int8 codes (the
    int8 kernel on the card for the euclidean family) keeps the
    ``K = quant.shortlist_width(k, n)`` best, the shortlist is re-scored
    exactly in f32 (``topk_candidates``) and the best k survive.
    Comparisons count both stages: n code scores + K exact re-scores."""
    _, qpos = scan_lib.topk_scan_quant(
        Q, codes, scales, k=K, metric=metric, sqnorms=sqnorms,
        block=block or scan_lib.DEFAULT_BLOCK,
    )
    idx, dists = scan_lib.topk_candidates(Q, qpos, X, k=k, metric=metric)
    comps = torch.full((Q.shape[0],), codes.shape[0] + K, dtype=torch.int32,
                       device=Q.device)
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

    @classmethod
    def build(cls, X, *, metric: str = "euclidean", impl: str = "jnp",
              block: int = 0, device: DeviceLike = None) -> "BruteIndex":
        """Hold X on ``device`` (default CUDA)."""
        X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
        return cls(X=X, metric=metric, impl=impl, block=block)

    def search(self, Q, k: int = 1, *, budget: Optional[int] = None,
               filter=None) -> SearchResult:
        if index_lib.resolve(filter, self.search_defaults, "filter") is not None:
            raise NotImplementedError(
                "brute: filters are not ported to repro_torch yet")
        Q = torch.as_tensor(Q, dtype=torch.float32, device=self.X.device)
        k = int(k)
        if self.quant is not None:
            codes, scales, sqnorms = self.quant.device_view()
            return _brute_quant_search(
                Q, codes, scales, sqnorms, self.X, k=k,
                K=quant_lib.shortlist_width(k, self.X.shape[0]),
                metric=self.metric, block=self.block,
            )
        return brute_force(self.X, Q, k=k, metric=self.metric, block=self.block)

    def memory_bytes(self) -> int:
        return index_lib.pytree_nbytes(self.X) + index_lib.side_store_bytes(self)

    def snapshot_state(self):
        return {"X": self.X}, {
            "metric": self.metric, "impl": self.impl, "block": self.block,
            "search_defaults": self.search_defaults,
        }

    @classmethod
    def from_snapshot(cls, arrays, statics, *, device: DeviceLike = None) -> "BruteIndex":
        X = torch.tensor(np.asarray(arrays["X"], np.float32),
                         device=resolve_device(device))
        return cls(X=X, metric=statics["metric"], impl=statics["impl"],
                   block=int(statics["block"]),
                   search_defaults=dict(statics.get("search_defaults") or {}))
