"""Mixture-of-Experts FFN on one device — port of ``repro/models/moe.py``'s
router, top-k, load-balance loss, slot maps, expert FFN and dense path.

Routing: softmax (Switch / GShard, qwen3) or sigmoid (DeepSeek-V3 style),
then the top k experts per token, their weights renormalised to sum to 1.
``lax.top_k`` puts the lowest index first among equal values; the port
selects with a stable descending sort, which does the same on every
device (``torch.topk``'s tie order on CUDA is not fixed).

Two ways to compute the same function:

* ``moe_ffn_dense`` — JAX's reference path, copied: every expert on every
  token, combined by the routing weights.  The tests' oracle; nothing on
  the serving or training path calls it.
* ``moe_ffn_dispatch`` — what ``transformer._moe_ffn`` runs.  Without a
  mesh JAX always takes the dense path, which drops no token; the port
  computes that function from JAX's expert-parallel pieces instead:
  ``_slot_maps`` with every expert local and the capacity C set to the
  largest expert load of the chunk (so nothing drops), the gathered
  (E, C, d) slots through ``_expert_ffn``, and a weighted scatter-add.
  Tokens go in chunks of ``MOE_CHUNK_TOKENS``, experts in groups of
  ``EXPERT_GROUP``: each group's f32 weights are cast to the activation
  dtype on their own, so the cast copy of an (E, d, f) leaf never exists
  whole (7.5 GB bf16 per leaf at DeepSeek-V3's widths).  Groups no token
  routes to are skipped.

The expert-parallel functions (``moe_ffn_ep``, ``moe_ffn_ep_zero3``,
``ep_mode``, ``expert_weight_specs``) need a mesh and wait for the port's
``dist/sharding`` (ROADMAP Queue 1, item 4); ``_slot_maps`` keeps its
offset and capacity arguments for them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig

MOE_CHUNK_TOKENS = 32768  # JAX's chunk of gathered tokens per EP step
EXPERT_GROUP = 32  # experts whose weights are cast and multiplied together


def router_probs(x: torch.Tensor, wr: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """(B, S, d) -> (B, S, E) routing probabilities (f32)."""
    logits = torch.einsum("bsd,de->bse", x, wr.to(x.dtype)).float()
    if cfg.router == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, the
    lowest index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_weights(probs: torch.Tensor, cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k selection + renormalisation.  probs (..., E) f32.  The routed
    scaling is JAX's ``getattr(cfg, "routed_scaling", 1.0)``: ``LMConfig``
    has no such field, so the weights sum to 1 (ROADMAP Queue 3)."""
    top_w, top_i = top_k(probs, cfg.num_experts_per_tok)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_w * getattr(cfg, "routed_scaling", 1.0), top_i


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    E = cfg.num_experts
    pe = probs.reshape(-1, E).mean(0)
    counts = torch.bincount(top_i.reshape(-1), minlength=E).float()
    fe = counts / counts.sum().clamp_min(1.0)
    return E * (fe * pe).sum()


def _slot_maps(top_i, top_w, eo: int, E_loc: int, C: int, T: int, k: int, dtype):
    """Capacity-slot assignment without materialising (T*k, d) anything.

    Returns slot_tok (E_loc, C) int32 — source token per expert slot (T =
    empty), and slot_w (E_loc, C) — routing weight per slot in ``dtype``
    (0 = empty).  Experts ``eo .. eo + E_loc`` are local; position-in-expert
    comes from a (T*k, E_loc) one-hot cumsum in token order; assignments
    past capacity C land in a trash column that is sliced off.
    """
    dev = top_i.device
    flat_i = top_i.reshape(-1)
    flat_w = top_w.reshape(-1).to(dtype)
    tok = torch.arange(T, device=dev, dtype=torch.int32).repeat_interleave(k)
    local = (flat_i >= eo) & (flat_i < eo + E_loc)
    lid = (flat_i - eo).clamp(0, E_loc - 1)
    onehot = (lid[:, None] == torch.arange(E_loc, device=dev)[None, :]) & local[:, None]
    pos_all = onehot.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    pos = pos_all.gather(1, lid[:, None])[:, 0]
    keep = local & (pos < C)
    wpos = torch.where(keep, pos, C).long()  # C = trash column
    slot_tok = torch.full((E_loc, C + 1), T, dtype=torch.int32, device=dev)
    slot_tok = slot_tok.index_put((lid, wpos), tok)
    slot_w = torch.zeros((E_loc, C + 1), dtype=dtype, device=dev)
    slot_w = slot_w.index_put((lid, wpos), flat_w * keep.to(dtype))
    return slot_tok[:, :C], slot_w[:, :C]


def _act(activation: str):
    if activation == "swiglu":
        return F.silu
    return lambda g: F.gelu(g, approximate="tanh")


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                activation: str) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d) through per-expert GLU FFNs."""
    dt = buf.dtype
    g = torch.einsum("ecd,edf->ecf", buf, wg.to(dt))
    u = torch.einsum("ecd,edf->ecf", buf, wu.to(dt))
    return torch.einsum("ecf,efd->ecd", _act(activation)(g) * u, wd.to(dt))


def moe_ffn_dense(x: torch.Tensor, probs: torch.Tensor, p: dict, cfg: LMConfig) -> torch.Tensor:
    """All experts on all tokens; exact combine.  JAX's reference path, for
    tests and tiny configs: at DeepSeek-V3's widths its (T, 256, 7168)
    temporaries hold 32 times the routed work."""
    top_w, top_i = topk_weights(probs, cfg)  # (B, S, k)
    oh = F.one_hot(top_i, cfg.num_experts).float()  # (B, S, k, E)
    full_w = torch.einsum("bsk,bske->bse", top_w, oh)
    dt = x.dtype
    g = torch.einsum("bsd,edf->bsef", x, p["wg"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, p["wu"].to(dt))
    h = torch.einsum("bsef,efd->bsed", _act(cfg.activation)(g) * u, p["wd"].to(dt))
    return torch.einsum("bsed,bse->bsd", h, full_w.to(dt))


def moe_ffn_dispatch(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor, p: dict,
                     cfg: LMConfig) -> torch.Tensor:
    """``moe_ffn_dense``'s function by dispatch: x (B, S, d), the routing
    ``topk_weights`` (B, S, k) -> (B, S, d).  Per chunk of
    ``MOE_CHUNK_TOKENS`` tokens, C is the largest expert load (one host
    read), so no token drops; the slots' outputs are weighted in the
    activation dtype and scatter-added into their tokens (the trash row T
    takes the empty slots)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = x.dtype
    xf, wf, idf = x.reshape(-1, d), top_w.reshape(-1, k), top_i.reshape(-1, k)
    outs = []
    for t0 in range(0, xf.shape[0], MOE_CHUNK_TOKENS):
        xc = xf[t0:t0 + MOE_CHUNK_TOKENS]
        ic = idf[t0:t0 + MOE_CHUNK_TOKENS]
        T = xc.shape[0]
        loads = torch.bincount(ic.reshape(-1), minlength=E).tolist()
        slot_tok, slot_w = _slot_maps(ic, wf[t0:t0 + MOE_CHUNK_TOKENS], 0, E, max(loads),
                                      T, k, dt)
        xpad = torch.cat([xc, xc.new_zeros((1, d))])
        out = xc.new_zeros((T + 1, d))
        for e0 in range(0, E, EXPERT_GROUP):
            grp = slice(e0, e0 + EXPERT_GROUP)
            if not any(loads[grp]):
                continue
            tok = slot_tok[grp].long()
            h = _expert_ffn(xpad[tok], p["wg"][grp], p["wu"][grp], p["wd"][grp],
                            cfg.activation)
            out = out.index_add(0, tok.reshape(-1), (h * slot_w[grp, :, None]).reshape(-1, d))
        outs.append(out[:T])
    return torch.cat(outs).reshape(B, S, d)
