"""LM transformer (llama / gemma / qwen3 / deepseek families) — port of
``repro/models/transformer.py``: every architecture's declarations, and
the dense GQA path for serving.

The parameter tree is JAX's: per-layer leaves stacked on a leading (L, ...)
axis under ``dense_blocks`` (and ``moe_blocks`` / ``mtp``), ``wq`` (L, d, H,
Dh), ``wo`` (L, H, Dh, d).  Where JAX scans the stack, the port loops over
its layers, each a view of the stacked leaves.  The decode cache is JAX's
too: ``{"dense": {"k", "v"}}`` of (L, B, T, KV, Dh) in the activation dtype.

Public entry points:
  lm_decls(cfg)                              — Param declarations
  lm_forward(params, tokens, cfg)            — (B,S) -> (logits, h, aux)
  init_cache(cfg, batch, max_len, device=)   — zeroed decode cache
  lm_prefill(params, tokens, cfg, max_len=)  -> (last logits, cache)
  lm_decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

MoE (routed experts, ``moe=True``) and MLA (``attention="mla"``) are
declared, so every architecture's parameter count is exact, but their
forward passes raise a ``KeyError`` naming the ROADMAP item that brings
them (``UNPORTED``).  ``lm_loss`` comes with LM training.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import glu_mlp, rms_norm
from repro_torch.models.params import Param

PyTree = Any

#: what the port does not run yet, and the ROADMAP item that brings it
UNPORTED = "MoE and MLA serving (ROADMAP Queue 1, item 3b)"


def _check_ported(cfg: LMConfig) -> None:
    if cfg.moe or cfg.attention == "mla":
        raise KeyError(f"{cfg.name!r} is not ported yet: its "
                       f"{'MoE' if cfg.moe else 'MLA'} layers come with {UNPORTED}")


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


def _block(p, h, positions, cfg, *, cache=None, cache_index=None):
    hn = rms_norm(h, p["attn_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    attn_out, kv = gqa_attention(p["attn"], hn, positions, cfg, cache=cache,
                                 cache_index=cache_index)
    h = h + attn_out
    hn = rms_norm(h, p["mlp_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    mlp = p["mlp"]
    return h + glu_mlp(hn, mlp["wg"], mlp["wu"], mlp["wd"], activation=cfg.activation), kv


def _embed(params, tokens, cfg):
    h = params["embed"][tokens.long()].to(cfg.act_dtype())
    if cfg.gemma_norm:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def _head(params, h, cfg):
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def lm_forward(params: PyTree, tokens: torch.Tensor, cfg: LMConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full causal forward. Returns (logits, final_hidden, moe_aux_loss);
    the aux loss is 0 on the dense path."""
    _check_ported(cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    h = _embed(params, tokens, cfg)
    blocks = params["dense_blocks"]
    for i in range(cfg.num_dense_layers):
        h, _ = _block(_layer(blocks, i), h, positions, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _head(params, h, cfg), h, aux


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> dict:
    """Stacked per-layer decode caches (L, B, T, KV, Dh), zeroed, in the
    activation dtype on ``device`` (default CUDA)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_dense_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"dense": {name: torch.zeros(shape, dtype=cfg.act_dtype(), device=dev)
                      for name in ("k", "v")}}


def lm_decode_step(params: PyTree, cache: dict, tokens: torch.Tensor, pos,
                   cfg: LMConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B, 1) int; ``pos`` the write index (an int
    or a 0-d tensor, every sequence at the same position).  The new K/V are
    written into ``cache`` in place.  Returns (logits (B, 1, V), cache)."""
    _check_ported(cfg)
    h = _embed(params, tokens, cfg)
    positions = torch.as_tensor(pos, device=h.device).reshape(-1)
    blocks = params["dense_blocks"]
    kc, vc = cache["dense"]["k"], cache["dense"]["v"]
    for i in range(cfg.num_dense_layers):
        h, _ = _block(_layer(blocks, i), h, positions, cfg,
                      cache={"k": kc[i], "v": vc[i]}, cache_index=positions[0])
    return _head(params, h, cfg), cache


def lm_prefill(params: PyTree, tokens: torch.Tensor, cfg: LMConfig, *,
               max_len: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Prefill: the full forward over the prompt.  Returns (the last
    token's logits (B, 1, V), the cache padded with zeros to ``max_len``
    positions, default S)."""
    _check_ported(cfg)
    B, S = tokens.shape
    T = max_len or S
    positions = torch.arange(S, device=tokens.device)
    h = _embed(params, tokens, cfg)
    cache = init_cache(cfg, B, T, device=tokens.device)["dense"]
    blocks = params["dense_blocks"]
    for i in range(cfg.num_dense_layers):
        h, kv = _block(_layer(blocks, i), h, positions, cfg)
        cache["k"][i, :, :S] = kv["k"]
        cache["v"][i, :, :S] = kv["v"]
    return _head(params, h[:, -1:, :], cfg), {"dense": cache}


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
    def generate(self, tokens: torch.Tensor, steps: int,
                 max_len: Optional[int] = None) -> torch.Tensor:
        """Greedy generation: ``lm_prefill`` over the prompt (B, S), then
        ``steps`` ``lm_decode_step`` calls, each fed the token before it.
        Returns the ``steps + 1`` tokens chosen, (B, steps + 1) int32: the
        prefill's, then one per decode call.  ``max_len`` (default S +
        steps) sizes the cache."""
        S = tokens.shape[1]
        logits, cache = lm_prefill(self, tokens, self.cfg, max_len=max_len or S + steps)
        out = [greedy(logits)]
        for t in range(steps):
            logits, cache = lm_decode_step(self, cache, out[-1][:, None], S + t, self.cfg)
            out.append(greedy(logits))
        return torch.stack(out, dim=1)
