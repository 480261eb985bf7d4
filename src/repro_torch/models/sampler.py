"""Host-side fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg``
— ``repro/models/sampler.py``, copied (numpy only, so the same ``rng``
gives the same subgraph in both packages).

Produces padded, static-shape subgraph batches from a CSR adjacency:
seed nodes -> fanout[0] neighbors -> fanout[1] neighbors of those, with
relabeled local node ids, padded edge lists (-1 padding, masked by the GCN
conv) and the seed positions for the loss.  Sampling runs on the
host and the device step consumes fixed shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (n+1,)
    indices: np.ndarray  # (nnz,)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_edges(cls, edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edges
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=src.astype(np.int32))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def random_graph(n_nodes: int, avg_degree: int, *, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    return CSRGraph.from_edges(np.stack([src, dst]), n_nodes)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple[int, ...],
    *,
    rng: np.random.Generator,
):
    """Returns dict with local_x_index (map to global), edges (2, E_max) with
    -1 padding, seed_local (positions of seeds), sized statically by
    (len(seeds), fanout)."""
    layers = [np.asarray(seeds, np.int64)]
    edge_src: list[np.ndarray] = []
    edge_dst: list[np.ndarray] = []
    frontier = layers[0]
    for f in fanout:
        nbrs = np.full((len(frontier), f), -1, np.int64)
        for i, v in enumerate(frontier):
            nb = graph.neighbors(int(v))
            if len(nb) == 0:
                continue
            take = rng.choice(nb, size=f, replace=len(nb) < f)
            nbrs[i] = take
        src = nbrs.reshape(-1)
        dst = np.repeat(frontier, f)
        ok = src >= 0
        edge_src.append(src[ok])
        edge_dst.append(dst[ok])
        frontier = np.unique(src[ok])
        layers.append(frontier)

    nodes = np.unique(np.concatenate(layers))
    relabel = {int(g): i for i, g in enumerate(nodes)}
    e_src = np.array([relabel[int(s)] for s in np.concatenate(edge_src)], np.int32)
    e_dst = np.array([relabel[int(d)] for d in np.concatenate(edge_dst)], np.int32)

    # static max sizes from the fanout tree
    max_nodes = int(len(seeds) * np.prod([f + 1 for f in fanout]))
    max_edges = int(len(seeds) * sum(np.prod([fanout[j] for j in range(i + 1)]) for i in range(len(fanout))))
    n_loc = len(nodes)
    edges = np.full((2, max_edges), -1, np.int32)
    edges[0, : len(e_src)] = e_src
    edges[1, : len(e_dst)] = e_dst
    node_index = np.full((max_nodes,), 0, np.int32)
    node_index[:n_loc] = nodes.astype(np.int32)
    node_valid = np.zeros((max_nodes,), bool)
    node_valid[:n_loc] = True
    seed_local = np.array([relabel[int(s)] for s in seeds], np.int32)
    return {
        "node_index": node_index,  # (max_nodes,) global node id per local id
        "node_valid": node_valid,
        "edges": edges,  # (2, max_edges) local ids, -1 padded
        "seed_local": seed_local,  # (n_seeds,)
        "num_nodes": max_nodes,
    }
