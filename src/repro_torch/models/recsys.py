"""RecSys CTR models: FM, DeepFM, xDeepFM (CIN), AutoInt — port of
``repro/models/recsys.py``, serving on one device.

The shared substrate: 39 categorical fields, one id per field, embedded
through one concatenated table (per-field offsets).  The per-field gather
(B, F, D) that feeds the FM term, the MLP, the CIN and the attention is a
plain gather (``dist/embedlookup``), as ``jnp.take`` is in JAX.  The two
sum-pooled lookups are the embedding bag's function and go through
``kernels/bag`` (the CUDA kernel on the card, its plain version on the
CPU): the first-order term ``sum_f linear[id_f]`` on the (V, 1) table, and
the query-side ``user_embedding`` ``sum_f table[id_f]``.  The FM trick
``0.5 * ((sum_f v)^2 - sum_f v^2)`` gives the O(F·D) pairwise interaction.

Parameters are a tree under the declaration names of ``recsys_decls``, in
JAX's layouts (``x @ w`` with w (fan-in, fan-out)): a plain dict of
tensors, or a ``RecsysModel``, which holds the same tree as an
``nn.Module``.  ``retrieval_score`` serves the ``retrieval_cand`` shape:
one query embedding against n_candidates item embeddings.  Under autograd
the bags run through ``kernels/bag``'s ``BagFunction`` (the bag's
backward kernel on the card), so ``recsys_loss`` trains every table.
The xDeepFM CIN runs over batch chunks of ``CIN_CHUNK`` rows (the
``serve_bulk`` batch would need an 82 GB outer product whole).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.embedlookup import embedding_lookup
from repro_torch.dist.sharding import DistCtx, act
from repro_torch.kernels.bag.ops import embedding_bag
from repro_torch.models import params as params_lib
from repro_torch.models.params import Param

PyTree = Any


#: rows of the xDeepFM CIN computed at once: its (rows, 200, 39, 10) f32
#: outer product is 5.1 GB at 16 384 rows, against 81.8 GB for the whole
#: serve_bulk batch of 262 144 (training microbatches are 8 192 rows)
CIN_CHUNK = 16384

#: (config, device) -> its field offsets on that device, made once
_OFFSETS: dict = {}


def field_offsets(cfg: RecsysConfig, device: DeviceLike = "cpu") -> torch.Tensor:
    """(F,) int32: the first row of each field in the concatenated table.
    Cached per (config, device), so a step copies nothing to the card;
    made outside inference mode, so training may use it too.  Read-only."""
    dev = torch.device(device)
    key = (cfg, dev)
    out = _OFFSETS.get(key)
    if out is None:
        vocabs = list(cfg.vocabs[: cfg.n_sparse])
        starts = [0]
        for v in vocabs[:-1]:
            starts.append(starts[-1] + v)
        with torch.inference_mode(False):
            out = _OFFSETS[key] = torch.tensor(starts, dtype=torch.int32, device=dev)
    return out


def _padded_vocab(cfg: RecsysConfig, multiple: int = 2048) -> int:
    v = cfg.total_vocab
    return v + (-v) % multiple


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def recsys_decls(cfg: RecsysConfig) -> dict:
    V = _padded_vocab(cfg)
    D = cfg.embed_dim
    Fs = cfg.n_sparse
    decls: dict = {
        "table": Param((V, D), ("table", "edim"), scale=0.01),
        "linear": Param((V, 1), ("table", "edim"), scale=0.01),
        "bias": Param((1,), ("edim",), init="zeros"),
    }
    if cfg.interaction in ("fm", "cin", "self-attn") and cfg.mlp:
        dims = (Fs * D,) + tuple(cfg.mlp) + (1,)
        decls["mlp"] = [
            {
                "w": Param((dims[i], dims[i + 1]), ("hidden", "hidden")),
                "b": Param((dims[i + 1],), ("hidden",), init="zeros"),
            }
            for i in range(len(dims) - 1)
        ]
    if cfg.interaction == "cin":
        hs = (Fs,) + tuple(cfg.cin_layers)
        decls["cin"] = [
            {"w": Param((hs[i + 1], hs[i], Fs), ("cin", "cin", "fields"))}
            for i in range(len(cfg.cin_layers))
        ]
        decls["cin_out"] = Param((sum(cfg.cin_layers), 1), ("cin", "edim"))
    if cfg.interaction == "self-attn":
        layers = []
        d_in = D
        for _ in range(cfg.n_attn_layers):
            layers.append(
                {
                    "wq": Param((d_in, cfg.n_heads, cfg.d_attn), ("edim", "heads", "attn")),
                    "wk": Param((d_in, cfg.n_heads, cfg.d_attn), ("edim", "heads", "attn")),
                    "wv": Param((d_in, cfg.n_heads, cfg.d_attn), ("edim", "heads", "attn")),
                    "wres": Param((d_in, cfg.n_heads * cfg.d_attn), ("edim", "attn")),
                }
            )
            d_in = cfg.n_heads * cfg.d_attn
        decls["attn"] = layers
        decls["attn_out"] = Param((cfg.n_sparse * d_in, 1), ("hidden", "edim"))
    return decls


class RecsysModel(params_lib.TreeModule):
    """The parameters of one recsys config under their declaration names
    (``table``, ``linear``, ``bias``, ``mlp.<i>.w``, ``cin.<i>.w``,
    ``attn.<i>.wq``, ...) and JAX's shapes, so the functions below read it
    as they read a plain tree (``model["mlp"][0]["w"]``); ``model(ids)`` is
    ``recsys_forward``; ``.tree()`` gives the plain tree."""

    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def build(cls, cfg: RecsysConfig, *, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> "RecsysModel":
        """Fresh weights for ``cfg`` on ``device`` (default CUDA), drawn
        from ``generator`` (default: one on ``device`` seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        tree = params_lib.init_params(recsys_decls(cfg), generator=generator, device=dev)
        return cls(cfg, tree)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return recsys_forward(self, ids, self.cfg)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _flat_ids(ids: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Per-field ids (B, F) -> rows of the concatenated table (B, F) int32."""
    return ids.to(torch.int32) + field_offsets(cfg, ids.device)[None, :]


def _embed_fields(params, ids: torch.Tensor, cfg: RecsysConfig,
                  dctx: Optional[DistCtx] = None):
    """ids (B, F) per-field -> (emb (B, F, D), first-order term (B,)).

    ``emb`` is the plain per-field gather; the first-order term is
    ``sum_f linear[id_f]`` by the embedding bag (JAX returns the (B, F)
    gather and sums it in ``recsys_forward``)."""
    flat = _flat_ids(ids, cfg)
    emb = embedding_lookup(params["table"], flat, dctx)
    first = embedding_bag(params["linear"], flat, combine="sum")[:, 0]
    return emb, first


def _fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """0.5 * ((sum_f v)^2 - sum_f v^2) summed over D. emb (B, F, D) -> (B,)."""
    s = emb.sum(1)
    s2 = (emb * emb).sum(1)
    return 0.5 * (s * s - s2).sum(-1)


def _mlp(params_list, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params_list):
        h = h @ layer["w"] + layer["b"]
        if i < len(params_list) - 1:
            h = torch.relu(h)
    return h


def _cin(params_list, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM). x0 (B, F, D) -> (B, sum Hk),
    ``CIN_CHUNK`` rows at a time: each row's value is its own, but a batched
    product rounds with its batch size, so chunked and whole agree to
    rounding (rtol 1e-5, tests/test_torch_train.py)."""
    if x0.shape[0] > CIN_CHUNK:
        return torch.cat([_cin_rows(params_list, x0[i:i + CIN_CHUNK])
                          for i in range(0, x0.shape[0], CIN_CHUNK)])
    return _cin_rows(params_list, x0)


def _cin_rows(params_list, x0: torch.Tensor) -> torch.Tensor:
    pooled = []
    xk = x0
    for layer in params_list:
        # z (B, Hk, F, D) = outer product of current row-features with x0
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)
        xk = torch.einsum("bhfd,ghf->bgd", z, layer["w"])
        pooled.append(xk.sum(-1))  # (B, Hk+1)
    return torch.cat(pooled, dim=-1)


def _autoint(params_list, emb: torch.Tensor) -> torch.Tensor:
    """Self-attention over field tokens. emb (B, F, D) -> (B, F, H*dA)."""
    h = emb
    for layer in params_list:
        q = torch.einsum("bfd,dha->bfha", h, layer["wq"])
        k = torch.einsum("bfd,dha->bfha", h, layer["wk"])
        v = torch.einsum("bfd,dha->bfha", h, layer["wv"])
        scores = torch.einsum("bfha,bgha->bhfg", q, k) / math.sqrt(q.shape[-1])
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhfg,bgha->bfha", probs, v)
        B, Fs = h.shape[:2]
        ctx = ctx.reshape(B, Fs, -1)
        res = h @ layer["wres"]
        h = torch.relu(ctx + res)
    return h


# ---------------------------------------------------------------------------
# forward / loss / serving
# ---------------------------------------------------------------------------

def recsys_forward(params: PyTree, ids: torch.Tensor, cfg: RecsysConfig,
                   dctx: Optional[DistCtx] = None) -> torch.Tensor:
    """ids (B, F) -> logits (B,)."""
    ids = act(dctx, ids, "batch", "fields")
    emb, first = _embed_fields(params, ids, cfg, dctx)
    emb = act(dctx, emb, "batch", "fields", "edim")
    logit = first + params["bias"][0]

    if cfg.interaction == "fm2":  # pure FM (Rendle)
        return logit + _fm_pairwise(emb)
    if cfg.interaction == "fm":  # DeepFM: FM + deep MLP
        deep = _mlp(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
        return logit + _fm_pairwise(emb) + deep
    if cfg.interaction == "cin":  # xDeepFM: CIN + deep MLP
        cin = _cin(params["cin"], emb) @ params["cin_out"]
        deep = _mlp(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
        return logit + cin[:, 0] + deep
    if cfg.interaction == "self-attn":  # AutoInt
        h = _autoint(params["attn"], emb)
        out = h.reshape(h.shape[0], -1) @ params["attn_out"]
        return logit + out[:, 0]
    raise ValueError(cfg.interaction)


def recsys_loss(params: PyTree, batch: dict, cfg: RecsysConfig,
                dctx: Optional[DistCtx] = None) -> tuple[torch.Tensor, dict]:
    """Binary cross-entropy CTR loss. batch: ids (B, F), labels (B,)."""
    logits = recsys_forward(params, batch["ids"], cfg, dctx)
    y = batch["labels"].to(torch.float32)
    ll = F.logsigmoid(logits)
    lnl = F.logsigmoid(-logits)
    loss = -torch.mean(y * ll + (1.0 - y) * lnl)
    auc_proxy = ((logits > 0) == (y > 0.5)).float().mean()
    return loss, {"loss": loss, "acc": auc_proxy}


def user_embedding(params: PyTree, ids: torch.Tensor, cfg: RecsysConfig,
                   dctx: Optional[DistCtx] = None) -> torch.Tensor:
    """Pooled query-side embedding for retrieval: the sum of the field
    embeddings, by the embedding bag.  ids (B, F) -> (B, D)."""
    return embedding_bag(params["table"], _flat_ids(ids, cfg), combine="sum")


def retrieval_score(
    user: torch.Tensor,  # (B, D)
    cand: torch.Tensor,  # (N, D)
    *,
    k: int = 100,
    dctx: Optional[DistCtx] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates by inner product -> (scores (B, k), ids (B, k)
    int32), highest first.  ``lax.top_k``'s tie rule — equal scores to the
    lowest index — by a stable descending sort of each row (``torch.topk``
    breaks ties otherwise)."""
    cand = act(dctx, cand, "cand", None)
    scores = user @ cand.T
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k].to(torch.int32)
