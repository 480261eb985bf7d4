"""LM transformer (llama / gemma / qwen3 / deepseek families) — port of
``repro/models/transformer.py``: every architecture's declarations,
serving (forward, prefill, greedy decode through the cache) and the loss.

The parameter tree is JAX's: per-layer leaves stacked on a leading (L, ...)
axis under ``dense_blocks`` and ``moe_blocks`` (and ``mtp``), ``wq`` (L, d,
H, Dh), ``wo`` (L, H, Dh, d).  Where JAX scans a stack, the port loops over
its layers, each a view of the stacked leaves; MoE models with leading
dense layers (deepseek-v3) run the dense stack, then the MoE stack.  The
decode cache is JAX's too: ``{"dense": ..., "moe": ...}``, each {"k",
"v"} of (L, B, T, KV, Dh) (MLA: {"ckv", "krope"} of (L, B, T, kv_lora) /
(L, B, T, rope)) in the activation dtype.  Under a ``DistCtx`` (``dctx``,
``dist/sharding.lm_policy``) a MoE layer whose batch splits over the
mesh's batch axes runs JAX's expert-parallel path (``moe.moe_ffn_ep``, or
``moe_ffn_ep_zero3`` where the policy says ``moe_impl="zero3"``);
``act`` marks JAX's layout constraints, which move nothing on the port's
one-device mesh.  Where ``cfg.remat`` is set and
gradients flow, each layer runs under ``torch.utils.checkpoint``
(``jax.checkpoint``'s role): its activations are recomputed in the
backward pass, and no value changes.

Public entry points:
  lm_decls(cfg)                              — Param declarations
  lm_forward(params, tokens, cfg, dctx)      — (B,S) -> (logits, h, aux)
  lm_loss(params, batch, cfg, dctx)          — next-token CE + MoE aux + MTP
  init_cache(cfg, batch, max_len, dctx, device=)  — zeroed decode cache
  lm_prefill(params, tokens, cfg, dctx, max_len=) -> (last logits, cache)
  lm_decode_step(params, cache, tokens, pos, cfg, dctx, mla_absorb=)
                                             -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import DistCtx, act
from repro_torch.models import moe as moe_lib
from repro_torch.models import params as params_lib
from repro_torch.models.attention import gqa_attention, mla_attention
from repro_torch.models.layers import glu_mlp, rms_norm, softmax_cross_entropy
from repro_torch.models.params import Param

PyTree = Any


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def _attn_decls(cfg: LMConfig, L: int) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pdt = cfg.param_dtype
    if cfg.attention == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wdq": Param((L, d, m.q_lora_rank), ("layers", "embed", "q_lora"), dtype=pdt),
            "q_norm": Param((L, m.q_lora_rank), ("layers", "q_lora"), init="ones", dtype=pdt),
            "wuq": Param((L, m.q_lora_rank, H, qk), ("layers", "q_lora", "q_heads", "head_dim"), dtype=pdt),
            "wdkv": Param((L, d, m.kv_lora_rank + m.qk_rope_head_dim), ("layers", "embed", "kv_lora"), dtype=pdt),
            "kv_norm": Param((L, m.kv_lora_rank), ("layers", "kv_lora"), init="ones", dtype=pdt),
            "wuk": Param((L, m.kv_lora_rank, H, m.qk_nope_head_dim), ("layers", "kv_lora", "q_heads", "head_dim"), dtype=pdt),
            "wuv": Param((L, m.kv_lora_rank, H, m.v_head_dim), ("layers", "kv_lora", "q_heads", "head_dim"), dtype=pdt),
            "wo": Param((L, H, m.v_head_dim, d), ("layers", "q_heads", "head_dim", "embed"), dtype=pdt),
        }
    out = {
        "wq": Param((L, d, H, Dh), ("layers", "embed", "q_heads", "head_dim"), dtype=pdt),
        "wk": Param((L, d, KV, Dh), ("layers", "embed", "kv_heads", "head_dim"), dtype=pdt),
        "wv": Param((L, d, KV, Dh), ("layers", "embed", "kv_heads", "head_dim"), dtype=pdt),
        "wo": Param((L, H, Dh, d), ("layers", "q_heads", "head_dim", "embed"), dtype=pdt),
    }
    if cfg.qk_norm:
        out["q_norm"] = Param((L, Dh), ("layers", "head_dim"), init="ones", dtype=pdt)
        out["k_norm"] = Param((L, Dh), ("layers", "head_dim"), init="ones", dtype=pdt)
    return out


def _dense_mlp_decls(cfg: LMConfig, L: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    return {
        "wg": Param((L, d, f), ("layers", "embed", "mlp"), dtype=pdt),
        "wu": Param((L, d, f), ("layers", "embed", "mlp"), dtype=pdt),
        "wd": Param((L, f, d), ("layers", "mlp", "embed"), dtype=pdt),
    }


def _moe_decls(cfg: LMConfig, L: int) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    pdt = cfg.param_dtype
    out = {
        "router": Param((L, d, E), ("layers", "embed", "experts_r"), dtype=pdt),
        "wg": Param((L, E, d, f), ("layers", "experts", "embed_x", "expert_mlp"), dtype=pdt),
        "wu": Param((L, E, d, f), ("layers", "experts", "embed_x", "expert_mlp"), dtype=pdt),
        "wd": Param((L, E, f, d), ("layers", "experts", "expert_mlp", "embed_x"), dtype=pdt),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        out["shared_wg"] = Param((L, d, fs), ("layers", "embed", "mlp"), dtype=pdt)
        out["shared_wu"] = Param((L, d, fs), ("layers", "embed", "mlp"), dtype=pdt)
        out["shared_wd"] = Param((L, fs, d), ("layers", "mlp", "embed"), dtype=pdt)
    return out


def _block_decls(cfg: LMConfig, L: int, *, moe: bool) -> dict:
    pdt = cfg.param_dtype
    norm_init = "zeros" if cfg.gemma_norm else "ones"
    return {
        "attn": _attn_decls(cfg, L),
        "attn_norm": Param((L, cfg.d_model), ("layers", "embed"), init=norm_init, dtype=pdt),
        "mlp_norm": Param((L, cfg.d_model), ("layers", "embed"), init=norm_init, dtype=pdt),
        "mlp": _moe_decls(cfg, L) if moe else _dense_mlp_decls(cfg, L),
    }


def lm_decls(cfg: LMConfig) -> dict:
    pdt = cfg.param_dtype
    decls: dict = {
        "embed": Param((cfg.vocab_size, cfg.d_model), ("vocab_in", "embed_tbl"), init="embed", dtype=pdt),
        "final_norm": Param((cfg.d_model,), ("embed",), init="zeros" if cfg.gemma_norm else "ones", dtype=pdt),
    }
    if not cfg.tie_embeddings:
        decls["head"] = Param((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), dtype=pdt)
    if cfg.num_dense_layers > 0:
        decls["dense_blocks"] = _block_decls(cfg, cfg.num_dense_layers, moe=False)
    if cfg.num_moe_layers > 0:
        decls["moe_blocks"] = _block_decls(cfg, cfg.num_moe_layers, moe=True)
    if cfg.mtp:
        decls["mtp"] = {
            "proj": Param((2 * cfg.d_model, cfg.d_model), ("embed2", "embed"), dtype=pdt),
            "block": _block_decls(cfg, 1, moe=False),
        }
    return decls


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _layer(blocks, i: int):
    """Layer ``i`` of a stacked block tree (dicts or ``TreeModule``s):
    every leaf's row ``i``, a view."""
    if isinstance(blocks, torch.Tensor):
        return blocks[i]
    return {key: _layer(blocks[key], i) for key in blocks.keys()}


def _attn_call(p, x, positions, cfg, dctx, cache=None, cache_index=None,
               mla_absorb=False):
    x = act(dctx, x, "batch", "attn_seq", "embed_act")
    if cfg.attention == "mla":
        out, kv = mla_attention(p, x, positions, cfg, cache=cache, cache_index=cache_index,
                                absorb=mla_absorb)
    else:
        out, kv = gqa_attention(p, x, positions, cfg, cache=cache, cache_index=cache_index)
    return act(dctx, out, "batch", "seq", "embed_act"), kv


def moe_takes_ep(cfg: LMConfig, dctx: Optional[DistCtx], batch: int) -> bool:
    """JAX's test for the expert-parallel path: a mesh whose model axis
    divides the experts and whose batch axes split a batch of ``batch``
    sequences."""
    if dctx is None or not dctx.batch_axes or "model" not in dctx.mesh.shape:
        return False
    shards = 1
    for a in dctx.batch_axes:
        shards *= dctx.mesh.shape[a]
    return cfg.num_experts % dctx.mesh.shape["model"] == 0 and batch % shards == 0


def _moe_ffn(p, x, cfg, dctx=None):
    """Routed experts (+ the shared expert).  Returns (out, aux loss).
    JAX's test: under a mesh whose model axis divides the experts and
    whose batch axes split the batch, the expert-parallel path (fed the
    probabilities in the activation dtype); otherwise the routing of JAX's
    dense path, computed by dispatch (``moe.moe_ffn_dispatch``) where JAX
    computes every expert."""
    probs = moe_lib.router_probs(x, p["router"], cfg)
    top_w, top_i = moe_lib.topk_weights(probs, cfg)
    aux = moe_lib.load_balance_loss(probs, top_i, cfg)
    if moe_takes_ep(cfg, dctx, x.shape[0]):
        impl = dctx.opt("moe_impl", "gathered")
        fn = moe_lib.moe_ffn_ep_zero3 if impl == "zero3" else moe_lib.moe_ffn_ep
        out = fn(x, probs.to(x.dtype), p, cfg, mesh=dctx.mesh, batch_axes=dctx.batch_axes)
    else:
        out = moe_lib.moe_ffn_dispatch(x, top_w, top_i, p, cfg)
    if cfg.num_shared_experts:
        out = out + glu_mlp(x, p["shared_wg"], p["shared_wu"], p["shared_wd"],
                            activation=cfg.activation)
    return act(dctx, out, "batch", "seq", "embed_act"), aux


def _block(p, h, positions, cfg, dctx=None, *, moe=False, cache=None, cache_index=None,
           mla_absorb=False):
    """One layer.  Returns (h, this layer's K/V or cache, MoE aux loss)."""
    hn = rms_norm(h, p["attn_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    attn_out, kv = _attn_call(p["attn"], hn, positions, cfg, dctx, cache=cache,
                              cache_index=cache_index, mla_absorb=mla_absorb)
    h = h + attn_out
    hn = rms_norm(h, p["mlp_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    mlp = p["mlp"]
    if moe:
        ffn_out, aux = _moe_ffn(mlp, hn, cfg, dctx)
    else:
        ffn_out = act(dctx, glu_mlp(hn, mlp["wg"], mlp["wu"], mlp["wd"],
                                    activation=cfg.activation),
                      "batch", "seq", "embed_act")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ffn_out, kv, aux


def _stacks(cfg: LMConfig) -> list[tuple[str, str, bool, int]]:
    """(cache key, parameter key, moe, layers) of each stack, in order."""
    out = []
    if cfg.num_dense_layers > 0:
        out.append(("dense", "dense_blocks", False, cfg.num_dense_layers))
    if cfg.num_moe_layers > 0:
        out.append(("moe", "moe_blocks", True, cfg.num_moe_layers))
    return out


def _run_stack(blocks, h, positions, cfg, dctx, *, moe: bool, layers: int):
    """The full forward of a stack (no cache): (h, the summed aux loss).
    With ``cfg.remat`` and gradients on, each layer is checkpointed."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(layers):
        p = _layer(blocks, i)
        if remat:
            h, a = checkpoint(lambda p, h: _block(p, h, positions, cfg, dctx, moe=moe)[::2],
                              p, h, use_reentrant=False)
        else:
            h, _, a = _block(p, h, positions, cfg, dctx, moe=moe)
        aux = aux + a
    return h, aux


def _embed(params, tokens, cfg, dctx):
    h = params["embed"][tokens.long()].to(cfg.act_dtype())
    if cfg.gemma_norm:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return act(dctx, h, "batch", "seq", "embed_act")


def _head(params, h, cfg, dctx):
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return act(dctx, h @ w.to(h.dtype), "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# forward / loss / prefill / decode
# ---------------------------------------------------------------------------

def lm_forward(params: PyTree, tokens: torch.Tensor, cfg: LMConfig,
               dctx: Optional[DistCtx] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full causal forward. Returns (logits, final_hidden, moe_aux_loss);
    the aux loss, summed over the MoE layers, is 0 without them."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    h = _embed(params, tokens, cfg, dctx)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, key, moe, layers in _stacks(cfg):
        h, a = _run_stack(params[key], h, positions, cfg, dctx, moe=moe, layers=layers)
        if moe:
            aux = aux + a
    return _head(params, h, cfg, dctx), h, aux


def lm_loss(params: PyTree, batch: dict, cfg: LMConfig, dctx: Optional[DistCtx] = None,
            *, aux_weight: float = 0.01, mtp_weight: float = 0.1
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE (the last position masked) + ``aux_weight`` times the
    MoE aux loss + (with ``cfg.mtp``) ``mtp_weight`` times the MTP CE: one
    dense block over ``proj`` of [h ; embed(next token)], through the
    shared head, predicting the token two ahead (the last two positions
    masked).  Returns (loss, {"ce", "moe_aux"[, "mtp_ce"], "loss"})."""
    tokens, mask = batch["tokens"], batch.get("mask")
    logits, h, aux = lm_forward(params, tokens, cfg, dctx)
    labels = F.pad(tokens[:, 1:], (0, 1))
    valid = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device) \
        if mask is None else mask.float()
    valid = torch.cat([valid[:, :-1], torch.zeros_like(valid[:, -1:])], dim=1)
    ce = softmax_cross_entropy(logits, labels, valid)
    loss = ce + aux_weight * aux
    metrics = {"ce": ce, "moe_aux": aux}
    if cfg.mtp:
        emb_next = params["embed"][labels.long()].to(h.dtype)
        mtp_in = torch.cat([h, emb_next], dim=-1) @ params["mtp"]["proj"].to(h.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        hm, _ = _run_stack(params["mtp"]["block"], mtp_in, positions, cfg, dctx, moe=False,
                           layers=1)
        logits2 = _head(params, hm, cfg, dctx)
        labels2 = F.pad(tokens[:, 2:], (0, 2))
        valid2 = torch.cat([valid[:, :-2], torch.zeros_like(valid[:, -2:])], dim=1)
        ce2 = softmax_cross_entropy(logits2, labels2, valid2)
        loss = loss + mtp_weight * ce2
        metrics["mtp_ce"] = ce2
    metrics["loss"] = loss
    return loss, metrics


def _cache_shapes(cfg: LMConfig, L: int, batch: int, max_len: int) -> dict:
    if cfg.attention == "mla":
        m = cfg.mla
        return {"ckv": (L, batch, max_len, m.kv_lora_rank),
                "krope": (L, batch, max_len, m.qk_rope_head_dim)}
    shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


#: the activation axes of each cache leaf (JAX's ``init_cache``)
_CACHE_AXES = {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
               "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
               "ckv": ("layers", "batch", "kv_seq", "kv_lora"),
               "krope": ("layers", "batch", "kv_seq", "rope")}


def init_cache(cfg: LMConfig, batch: int, max_len: int, dctx: Optional[DistCtx] = None,
               *, device: DeviceLike = None) -> dict:
    """Stacked per-layer decode caches, zeroed, in the activation dtype on
    ``device`` (default CUDA): per stack ("dense", "moe") {"k", "v"} (L, B,
    T, KV, Dh), or MLA's {"ckv" (L, B, T, kv_lora), "krope" (L, B, T,
    rope)}."""
    dev = resolve_device(device)
    return {name: {key: act(dctx, torch.zeros(shape, dtype=cfg.act_dtype(), device=dev),
                            *_CACHE_AXES[key])
                   for key, shape in _cache_shapes(cfg, layers, batch, max_len).items()}
            for name, _, _, layers in _stacks(cfg)}


def lm_decode_step(params: PyTree, cache: dict, tokens: torch.Tensor, pos,
                   cfg: LMConfig, dctx: Optional[DistCtx] = None, *,
                   mla_absorb: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int; ``pos`` the write index (an int
    or a 0-d tensor, every sequence at the same position).  The new K/V
    (MLA: latent and rope key) are written into ``cache`` in place; MLA
    attends naively or, with ``mla_absorb``, through the latent.  Returns
    (logits (B, 1, V), cache)."""
    h = _embed(params, tokens, cfg, dctx)
    positions = torch.as_tensor(pos, device=h.device).reshape(-1)
    for name, key, moe, layers in _stacks(cfg):
        blocks, stack = params[key], cache[name]
        for i in range(layers):
            h, _, _ = _block(_layer(blocks, i), h, positions, cfg, dctx, moe=moe,
                             cache={k: v[i] for k, v in stack.items()},
                             cache_index=positions[0], mla_absorb=mla_absorb)
    return _head(params, h, cfg, dctx), cache


def lm_prefill(params: PyTree, tokens: torch.Tensor, cfg: LMConfig,
               dctx: Optional[DistCtx] = None, *, max_len: Optional[int] = None
               ) -> tuple[torch.Tensor, dict]:
    """Prefill: the full forward over the prompt.  Returns (the last
    token's logits (B, 1, V), the cache padded with zeros to ``max_len``
    positions, default S)."""
    B, S = tokens.shape
    T = max_len or S
    positions = torch.arange(S, device=tokens.device)
    h = _embed(params, tokens, cfg, dctx)
    cache = init_cache(cfg, B, T, dctx, device=tokens.device)
    for name, key, moe, layers in _stacks(cfg):
        blocks, stack = params[key], cache[name]
        for i in range(layers):
            h, kv, _ = _block(_layer(blocks, i), h, positions, cfg, dctx, moe=moe)
            for k, v in kv.items():
                stack[k][i, :, :S] = v
    return _head(params, h[:, -1:, :], cfg, dctx), cache


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of every sequence: the argmax of the last position's
    logits (the first of equal maxima), int32 (B,)."""
    return logits[:, -1].argmax(-1).to(torch.int32)


class LMModel(params_lib.TreeModule):
    """The parameters of one LM config under ``lm_decls``' names and
    shapes (``embed``, ``dense_blocks.attn.wq``, ...); ``model(tokens)`` is
    ``lm_forward``'s logits; ``.tree()`` gives the plain tree."""

    def __init__(self, cfg: LMConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def build(cls, cfg: LMConfig, *, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> "LMModel":
        """Random weights for ``cfg`` on ``device`` (default CUDA), drawn
        from ``generator`` (default: one on ``device`` seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return cls(cfg, params_lib.init_params(lm_decls(cfg), generator=generator,
                                               device=dev))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self, tokens, self.cfg)[0]

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, steps: int, max_len: Optional[int] = None,
                 *, mla_absorb: bool = False) -> torch.Tensor:
        """Greedy generation: ``lm_prefill`` over the prompt (B, S), then
        ``steps`` ``lm_decode_step`` calls, each fed the token before it.
        Returns the ``steps + 1`` tokens chosen, (B, steps + 1) int32: the
        prefill's, then one per decode call.  ``max_len`` (default S +
        steps) sizes the cache; ``mla_absorb`` picks MLA's decode."""
        S = tokens.shape[1]
        logits, cache = lm_prefill(self, tokens, self.cfg, max_len=max_len or S + steps)
        out = [greedy(logits)]
        for t in range(steps):
            logits, cache = lm_decode_step(self, cache, out[-1][:, None], S + t, self.cfg,
                                           mla_absorb=mla_absorb)
            out.append(greedy(logits))
        return torch.stack(out, dim=1)
