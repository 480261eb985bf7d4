"""GQA / MQA / MHA attention with full (prefill) and KV-cache decode paths —
port of ``repro/models/attention.py``'s ``gqa_attention``.

Layout conventions
------------------
activations  x        : (B, S, d_model)
query        q        : (B, S, H, Dh)
key/value    k, v     : (B, T, KV, Dh)
GQA grouping          : H = KV * G; the scores keep the group axis through
                        a (B, S, KV, G, Dh) view, so no KV repeat is ever
                        materialised.
decode cache          : {'k': (B, T, KV, Dh), 'v': ...}

The schedule and dtypes are JAX's: q pre-scaled by Dh^-1/2; softmax in
f32 with -1e30 masking; at ``CHUNK_THRESHOLD`` and above (S a multiple of
``CHUNK_SIZE``) the online-softmax loop over KV chunks, whose score tiles
are in the activation dtype and whose running max / sum and accumulator
are f32.  Decode writes the new K/V into the cache in place at
``cache_index`` and attends over all T cache positions, masked to
``cache_index + S``.  The einsums are torch's; there is no fused
attention kernel on this path.  MLA (``mla_attention``) waits for ROADMAP
Queue 1 item 3b.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import apply_rotary, rms_norm, rotary_embedding

NEG = -1e30


def _softmax_f32(scores: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scores = torch.where(mask, scores.float(), NEG)
    return torch.softmax(scores, dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) causal attention — O(S * C) live memory
# ---------------------------------------------------------------------------

CHUNK_THRESHOLD = 2048  # direct softmax below this sequence length
CHUNK_SIZE = 1024


def _chunked_causal(q: torch.Tensor, kv_chunk_fn: Callable, n_chunks: int, chunk: int,
                    positions: torch.Tensor, dtype: torch.dtype,
                    v_dim: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the Rabe & Staats /
    FlashAttention schedule of JAX's ``lax.scan``, as a loop).

    q: (B, S, KV, G, Dh) pre-scaled.  kv_chunk_fn(c) -> (kc, vc) with
    kc/vc (B, C, KV, Dh).  positions (S,) absolute query positions; chunk c
    covers absolute positions [c*chunk, (c+1)*chunk).
    Returns (B, S, KV, G, Dh) in ``dtype``.

    Where ``positions`` ascend, the query rows that lie wholly before chunk
    c are not computed for it: JAX's scan gives them a fully masked tile,
    whose update is exactly the identity (corr = exp(0) = 1, p = 0), since
    chunk 0 gave every row a finite running max.
    """
    B, S, KV, G, Dh = q.shape
    Dv = Dh if v_dim is None else v_dim
    # score/probability tiles in the ACTIVATION dtype; the online-softmax
    # statistics (m, l) and the accumulator in f32
    sdt = q.dtype
    qt = q.permute(0, 2, 3, 1, 4)  # (B, KV, G, S, Dh)
    m = torch.full((B, KV, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, Dv), dtype=torch.float32, device=q.device)
    host = positions.cpu()
    ascending = bool((host[1:] >= host[:-1]).all())
    for c in range(n_chunks):
        lo = int((host < c * chunk).sum()) if ascending else 0
        if lo == S:
            break
        kc, vc = kv_chunk_fn(c)
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bkgsd,bckd->bkgsc", qt[:, :, :, lo:], kc.to(sdt))
        mask = positions[lo:, None] >= kpos[None, :]  # (S - lo, C)
        s32 = torch.where(mask, s.float(), NEG)
        del s
        m_old = m[..., lo:]
        m_new = torch.maximum(m_old, s32.amax(-1))
        corr = torch.exp(m_old - m_new)
        p = torch.exp(s32.sub_(m_new[..., None])).to(sdt)
        del s32
        l[..., lo:] = l[..., lo:] * corr + p.sum(-1, dtype=torch.float32)
        # JAX's preferred_element_type=f32: the tile's products exact and
        # summed in f32 (an f32 product of the activation-dtype values)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.float(), vc.to(sdt).float())
        acc[..., lo:, :] = acc[..., lo:, :] * corr[..., None] + pv
        m[..., lo:] = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(dtype)  # -> (B, S, KV, G, Dv)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_attention(
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LMConfig,
    *,
    cache: Optional[dict] = None,
    cache_index=None,
):
    """Returns (out (B, S, d), cache).

    Full mode (cache=None): causal self-attention over x; the returned
    cache is this call's {"k", "v"} (B, S, KV, Dh).
    Decode mode: cache holds T positions; ``cache_index`` (an int or a 0-d
    tensor) is the write position, the new K/V are written into
    ``cache``'s tensors in place (which are returned), and the first
    ``cache_index + S`` positions are attended to.
    """
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    dt = x.dtype

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)

    sin, cos = rotary_embedding(positions, Dh, theta=cfg.rope_theta)
    q = apply_rotary(q, sin, cos)
    k = apply_rotary(k, sin, cos)

    q = q * Dh ** -0.5

    if cache is None:
        # ---------------- full causal self-attention (positions: (S,))
        qg = q.reshape(B, S, KV, G, Dh)
        if S >= CHUNK_THRESHOLD and S % CHUNK_SIZE == 0:
            chunk = CHUNK_SIZE

            def kv_chunk(c):
                return k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]

            ctx = _chunked_causal(qg, kv_chunk, S // chunk, chunk, positions, dt)
            ctx = ctx.reshape(B, S, H, Dh)
        else:
            scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
            mask = (positions[:, None] >= positions[None, :])[None, None, None]
            probs = _softmax_f32(scores, mask, dt)
            ctx = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, Dh)
        out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(dt))
        return out, {"k": k, "v": v}

    # ---------------- decode against the cache
    k_cache, v_cache = cache["k"], cache["v"]
    start = torch.as_tensor(cache_index, device=x.device)
    rows = start + torch.arange(S, device=x.device)
    k_cache.index_copy_(1, rows, k.to(k_cache.dtype))
    v_cache.index_copy_(1, rows, v.to(v_cache.dtype))
    T = k_cache.shape[1]
    qg = q.reshape(B, S, KV, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache.to(dt))
    mask = (torch.arange(T, device=x.device) < start + S)[None, None, None, None, :]
    probs = _softmax_f32(scores, mask, dt)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v_cache.to(dt)).reshape(B, S, H, Dh)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(dt))
    return out, {"k": k_cache, "v": v_cache}
