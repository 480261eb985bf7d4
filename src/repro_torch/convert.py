"""Load JAX-built state into the port.

Each function takes what the JAX object's ``snapshot_state()`` returns,
with every array already turned into numpy by the caller (this package
never imports JAX), and gives the port's object over the same state — so
both packages can be held to one index:

* ``index_from_jax_state`` — ``InfinityIndex`` (X, Z, Phi, VP tree);
  ``params_from_phi`` is the way back, a ``Phi`` as JAX's params tree;
* ``brute_from_jax_state`` — ``BruteIndex``;
* ``ivf_flat_from_jax_state``, ``ivf_pq_from_jax_state``,
  ``nsw_from_jax_state`` — ``IVFFlat``, ``IVFPQ``, ``NSWGraph`` (the
  k-means centroids, lists, PQ codes and graph as JAX built them);
* ``sharded_from_jax_state`` — ``ShardedIndex``: a JAX index of S shards
  (one per device) with every shard on one device;
* ``attrs_from_jax_state`` — ``AttributeStore`` (columns and vocabularies);
* ``quant_store_from_jax`` — ``QuantStore`` (the same codes and scales;
  the squared norms are recomputed, as every store derives them);
* ``params_from_jax`` — the port's tree of tensors from any JAX params
  tree and its declarations; ``recsys_params_from_jax``,
  ``gcn_params_from_jax`` and ``lm_params_from_jax`` wrap it in
  ``RecsysModel``, ``GCNModel`` and ``LMModel`` (``.tree()`` gives the
  plain tree the train step takes);
* ``opt_state_from_jax`` / ``opt_state_to_jax`` — optimizer state both
  ways (``AdamWState``, ``AdafactorState``, the sgd tuple): JAX's ``step``
  is an int32 scalar array, the port's a host int.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import attrs as attrs_lib
from repro_torch.core import embedding as embed_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.baselines import IVFPQ, BruteIndex, IVFFlat, NSWGraph
from repro_torch.core.index import ShardedIndex
from repro_torch.core import vptree as vptree_lib
from repro_torch.core.search import IndexConfig, InfinityIndex
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import params as params_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as lm_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tree_lib


def phi_from_params(params: Mapping[str, Any], device: torch.device) -> embed_lib.Phi:
    """A ``Phi`` module from the JAX params tree: ``layers`` of {"w" (din,
    dout), "b"}, plus the optional ``x_mean`` / ``x_std`` / ``d_scale``."""
    layers = params["layers"]
    dims = (np.asarray(layers[0]["w"]).shape[0],) + tuple(
        np.asarray(layer["w"]).shape[1] for layer in layers
    )
    phi = embed_lib.Phi(dims).to(device)
    with torch.no_grad():
        for mod, layer in zip(phi.layers, layers):
            mod.weight.copy_(torch.tensor(np.asarray(layer["w"], np.float32)).T)
            mod.bias.copy_(torch.tensor(np.asarray(layer["b"], np.float32)))
    for name in ("x_mean", "x_std", "d_scale"):
        if name in params:
            setattr(phi, name, torch.tensor(np.asarray(params[name], np.float32),
                                               device=device))
    return phi


def params_from_phi(phi: embed_lib.Phi) -> dict:
    """The inverse of ``phi_from_params``: JAX's params tree as numpy —
    ``layers`` of {"w" (din, dout), "b"} (``nn.Linear.weight`` transposed)
    plus the normalisers the trainer attached."""
    params = embed_lib.params_of(phi)
    out: dict = {"layers": [{k: v.cpu().numpy() for k, v in layer.items()}
                            for layer in params.pop("layers")]}
    out.update({k: v.detach().cpu().numpy() for k, v in params.items()})
    return out


def index_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                         device: DeviceLike = None) -> InfinityIndex:
    """``arrays``: {"X", "Z", "phi", "vantage", "mu", "left", "right"} as
    numpy; ``statics``: {"config", "depth", "search_defaults"}.  Returns the
    port index on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    cfg = dict(statics["config"])
    cfg["hidden"] = tuple(cfg["hidden"])
    tree = vptree_lib.VPTree(
        vantage=torch.tensor(np.asarray(arrays["vantage"], np.int32), device=dev),
        mu=torch.tensor(np.asarray(arrays["mu"], np.float32), device=dev),
        left=torch.tensor(np.asarray(arrays["left"], np.int32), device=dev),
        right=torch.tensor(np.asarray(arrays["right"], np.int32), device=dev),
        depth=int(statics["depth"]),
    )
    return InfinityIndex(
        config=IndexConfig(**cfg),
        X=torch.tensor(np.asarray(arrays["X"], np.float32), device=dev),
        Z=torch.tensor(np.asarray(arrays["Z"], np.float32), device=dev),
        phi=phi_from_params(arrays["phi"], dev),
        tree=tree,
        train_history={},
        search_defaults=dict(statics.get("search_defaults") or {}),
    )


def brute_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                         device: DeviceLike = None) -> BruteIndex:
    """``arrays``: {"X"} as numpy; ``statics``: {"metric", "impl", "block",
    "search_defaults"}.  Returns the port ``BruteIndex`` on ``device``."""
    return BruteIndex.from_snapshot(arrays, statics, device=device)


def ivf_flat_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                            device: DeviceLike = None) -> IVFFlat:
    """``arrays``: {"X", "centroids", "lists", "list_lens"} as numpy;
    ``statics``: {"metric", "search_defaults"}."""
    return IVFFlat.from_snapshot(arrays, statics, device=device)


def ivf_pq_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                          device: DeviceLike = None) -> IVFPQ:
    """``arrays``: {"X", "centroids", "codebooks", "codes", "lists",
    "list_lens"} as numpy; ``statics``: {"metric", "search_defaults"}."""
    return IVFPQ.from_snapshot(arrays, statics, device=device)


def nsw_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                       device: DeviceLike = None) -> NSWGraph:
    """``arrays``: {"X", "neighbors"} as numpy; ``statics``: {"metric",
    "entry", "search_defaults"}."""
    return NSWGraph.from_snapshot(arrays, statics, device=device)


def sharded_from_jax_state(arrays: Mapping[str, Any], statics: Mapping[str, Any], *,
                           device: DeviceLike = None) -> ShardedIndex:
    """``arrays``: {"stacked": the per-shard state tree, every leaf with a
    leading shard axis} as numpy; ``statics``: {"engine", "static",
    "shard_size", "n", "search_defaults"}.  Every shard goes to ``device``,
    whatever number of devices the JAX index ran on."""
    return ShardedIndex.from_snapshot(arrays, statics, device=device)


def attrs_from_jax_state(arrays: Mapping[str, Any],
                         statics: Mapping[str, Any]) -> attrs_lib.AttributeStore:
    """``arrays``: {"num_<col>", "cat_<col>"} as numpy; ``statics``:
    {"numeric", "categorical"}.  Attach it with ``index.attach_store``."""
    return attrs_lib.AttributeStore.from_snapshot(dict(arrays), dict(statics))


def quant_store_from_jax(arrays: Mapping[str, Any], *,
                         device: DeviceLike = None) -> quant_lib.QuantStore:
    """``arrays``: {"codes", "scales"} as numpy.  Returns the port store
    whose views go to ``device``."""
    return quant_lib.QuantStore.from_snapshot(arrays, {}, device=device)


def params_from_jax(params_np: Mapping[str, Any], decls, *,
                    device: DeviceLike = None) -> dict:
    """The port's tree of tensors on ``device`` (default CUDA) from a JAX
    params tree (dicts and lists of numpy arrays, as ``init_params`` of
    ``decls`` gives them).  The port keeps JAX's layouts (``x @ w``, w
    (fan-in, fan-out); stacked (L, ...) layers), so nothing is transposed;
    each leaf must have its declaration's shape, and takes its dtype."""
    dev = resolve_device(device)

    def take(path: str, decl) -> torch.Tensor:
        node: Any = params_np
        for key in path.split("."):
            node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
        arr = np.asarray(node, np.float32)
        if arr.shape != decl.shape:
            raise ValueError(f"{path}: shape {arr.shape}, declared {decl.shape}")
        return torch.tensor(arr, device=dev).to(getattr(torch, decl.dtype))

    return params_lib.map_decls(take, decls)


def recsys_params_from_jax(params_np: Mapping[str, Any], cfg, *,
                           device: DeviceLike = None) -> recsys_lib.RecsysModel:
    """A ``RecsysModel`` for ``cfg`` from the JAX recsys params tree."""
    return recsys_lib.RecsysModel(
        cfg, params_from_jax(params_np, recsys_lib.recsys_decls(cfg), device=device))


def gcn_params_from_jax(params_np: Mapping[str, Any], cfg, *,
                        device: DeviceLike = None) -> gnn_lib.GCNModel:
    """A ``GCNModel`` for ``cfg`` from the JAX GCN params tree; the input
    width is its first layer's."""
    d_feat = np.shape(params_np["layers"][0]["w"])[0]
    return gnn_lib.GCNModel(
        cfg, params_from_jax(params_np, gnn_lib.gcn_decls(cfg, d_feat), device=device))


def lm_params_from_jax(params_np: Mapping[str, Any], cfg, *,
                       device: DeviceLike = None) -> lm_lib.LMModel:
    """An ``LMModel`` for ``cfg`` from the JAX LM params tree (``lm_decls``:
    wq (L, d, H, Dh), wo (L, H, Dh, d), ...)."""
    return lm_lib.LMModel(
        cfg, params_from_jax(params_np, lm_lib.lm_decls(cfg), device=device))


def _tensors(tree_np, dev: torch.device):
    return tree_lib.tree_map(
        lambda a: torch.tensor(np.asarray(a), device=dev), tree_np)


def opt_state_from_jax(state_np, *, device: DeviceLike = None):
    """The port's optimizer state from a JAX one whose arrays the caller
    turned into numpy (``jax.tree_util.tree_map(np.asarray, state)``):
    ``AdamWState(step, mu, nu)`` and ``AdafactorState(step, stats)`` are
    told apart by their fields, anything else is sgd's ``(step, velocity
    or None)``.  Moments go to ``device`` (default CUDA) in their dtype;
    ``step`` becomes a host int."""
    dev = resolve_device(device)
    fields = getattr(state_np, "_fields", None)
    step = int(np.asarray(state_np[0]))
    if fields == ("step", "mu", "nu"):
        return opt_lib.AdamWState(step=step, mu=_tensors(state_np.mu, dev),
                                  nu=_tensors(state_np.nu, dev))
    if fields == ("step", "stats"):
        return opt_lib.AdafactorState(step=step, stats=_tensors(state_np.stats, dev))
    if fields is None and len(state_np) == 2:
        vel = state_np[1]
        return (step, None if vel is None else _tensors(vel, dev))
    raise ValueError(f"not an optimizer state the port knows: fields {fields}")


def opt_state_to_jax(state, cls=None):
    """The inverse: JAX's fields as numpy, in JAX's order — ``step`` an
    int32 scalar array — wrapped in ``cls`` (JAX's ``AdamWState`` or
    ``AdafactorState``) where given, else a plain tuple (sgd's state is
    one)."""
    def host(tree):
        return tree_lib.tree_map(lambda t: t.detach().cpu().numpy(), tree)

    step = np.asarray(state[0], np.int32)
    rest = [None if part is None else host(part) for part in state[1:]]
    return cls(step, *rest) if cls is not None else (step, *rest)
