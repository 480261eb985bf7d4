"""Attention: GQA / MQA / MHA and MLA (DeepSeek-style latent attention),
with full (prefill / train) and KV-cache decode paths — port of
``repro/models/attention.py``.

Layout conventions
------------------
activations  x        : (B, S, d_model)
query        q        : (B, S, H, Dh)
key/value    k, v     : (B, T, KV, Dh)
GQA grouping          : H = KV * G; the scores keep the group axis through
                        a (B, S, KV, G, Dh) view, so no KV repeat is ever
                        materialised.
decode cache (gqa)    : {'k': (B, T, KV, Dh), 'v': ...}
decode cache (mla)    : {'ckv': (B, T, kv_lora), 'krope': (B, T, rope_dim)}

The schedule and dtypes are JAX's: softmax in f32 with -1e30 masking; at
``CHUNK_THRESHOLD`` and above (S a multiple of ``CHUNK_SIZE``) the
online-softmax loop over KV chunks, whose score tiles are in the
activation dtype and whose running max / sum and accumulator are f32.
GQA pre-scales q by Dh^-1/2; MLA scales by (nope + rope)^-1/2 where JAX
does (q before the product in the chunked branch, the scores after it in
the others).  Decode writes the new K/V (or MLA's latent and rope key)
into the cache in place at ``cache_index`` and attends over all T cache
positions, masked to ``cache_index + S``.  MLA decode is naive (K/V
expanded from the latent per step) or absorbed (``absorb=True``: W_uk
folded into the query, W_uv into the output).  The einsums are torch's;
there is no fused attention kernel on this path.
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


def _write(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``new`` (B, S, ...) written into ``cache`` (B, T, ...) in place at
    rows ``start .. start + S`` (``dynamic_update_slice`` under ``jit``)."""
    rows = start + torch.arange(new.shape[1], device=cache.device)
    return cache.index_copy_(1, rows, new.to(cache.dtype))


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
    kc (B, C, KV, Dh), vc (B, C, KV, Dv).  positions (S,) absolute query
    positions; chunk c covers absolute positions [c*chunk, (c+1)*chunk).
    Returns (B, S, KV, G, Dv) in ``dtype``.

    Where ``positions`` ascend, the query rows that lie wholly before chunk
    c are not computed for it: JAX's scan gives them a fully masked tile,
    whose update is exactly the identity (corr = exp(0) = 1, p = 0), since
    chunk 0 gave every row a finite running max.  The running statistics
    are rebuilt out of place each chunk (the untouched rows, then the
    updated ones), so autograd runs through the loop; with gradients off
    the score tile is shifted in place, which saves one tile of memory and
    changes no value.
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
    # a meta tensor holds no values: the dry-run's meta steps reach this
    # loop only from lm_forward, lm_loss and lm_prefill, whose positions
    # are 0 .. S - 1
    host = torch.arange(S) if positions.device.type == "meta" else positions.cpu()
    ascending = bool((host[1:] >= host[:-1]).all())
    in_place = not torch.is_grad_enabled()
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
        shifted = s32.sub_(m_new[..., None]) if in_place else s32 - m_new[..., None]
        p = torch.exp(shifted).to(sdt)
        del s32, shifted
        l_new = l[..., lo:] * corr + p.sum(-1, dtype=torch.float32)
        # JAX's preferred_element_type=f32: the tile's products exact and
        # summed in f32 (an f32 product of the activation-dtype values)
        pv = torch.einsum("bkgsc,bckd->bkgsd", p.float(), vc.to(sdt).float())
        acc_new = acc[..., lo:, :] * corr[..., None] + pv
        m = torch.cat([m[..., :lo], m_new], dim=-1)
        l = torch.cat([l[..., :lo], l_new], dim=-1)
        acc = torch.cat([acc[..., :lo, :], acc_new], dim=-2)
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
    start = torch.as_tensor(cache_index, device=x.device)
    k_cache, v_cache = _write(cache["k"], k, start), _write(cache["v"], v, start)
    T = k_cache.shape[1]
    qg = q.reshape(B, S, KV, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache.to(dt))
    mask = (torch.arange(T, device=x.device) < start + S)[None, None, None, None, :]
    probs = _softmax_f32(scores, mask, dt)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v_cache.to(dt)).reshape(B, S, H, Dh)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(dt))
    return out, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def mla_attention(
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: LMConfig,
    *,
    cache: Optional[dict] = None,
    cache_index=None,
    absorb: bool = False,
):
    """DeepSeek-V2/V3 multi-head latent attention.  Returns (out (B, S, d),
    cache).

    Params: wdq (d, q_lora), q_norm (q_lora,), wuq (q_lora, H, nope+rope),
            wdkv (d, kv_lora + rope), kv_norm (kv_lora,),
            wuk (kv_lora, H, nope), wuv (kv_lora, H, v_dim),
            wo (H, v_dim, d).
    Full mode (cache=None): causal self-attention over x, K/V expanded
    from the latent per head (per chunk at ``CHUNK_THRESHOLD`` and above);
    the returned cache is this call's {"ckv", "krope"}.  Decode mode: the
    latent and the rope key are written into ``cache``'s tensors in place
    at ``cache_index`` (returned), and the first ``cache_index + S``
    positions are attended to, naively or, with ``absorb``, through the
    latent.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    dt = x.dtype

    # queries through the low-rank bottleneck
    cq = rms_norm(x @ p["wdq"].to(dt), p["q_norm"], eps=cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wuq"].to(dt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    sin, cos = rotary_embedding(positions, rope, theta=cfg.rope_theta)
    q_rope = apply_rotary(q_rope, sin, cos)

    # compressed KV + shared rope key
    ckv_full = x @ p["wdkv"].to(dt)  # (B, S, kv_lora + rope)
    ckv = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_norm"], eps=cfg.norm_eps)
    k_rope = apply_rotary(ckv_full[..., m.kv_lora_rank:][..., None, :], sin, cos)[..., 0, :]

    scale = (nope + rope) ** -0.5

    if cache is not None:
        start = torch.as_tensor(cache_index, device=x.device)
        new_cache = {"ckv": _write(cache["ckv"], ckv, start),
                     "krope": _write(cache["krope"], k_rope, start)}
        ckv, k_rope = new_cache["ckv"].to(dt), new_cache["krope"].to(dt)
        T = ckv.shape[1]
        mask = (torch.arange(T, device=x.device) < start + S)[None, None, None, :]
    else:
        new_cache = {"ckv": ckv, "krope": k_rope}
        mask = (positions[:, None] >= positions[None, :])[None, None]

    if absorb and cache is not None:
        # fold W_uk into q, W_uv into the output: never expand K/V to H heads
        qa = torch.einsum("bshn,rhn->bshr", q_nope, p["wuk"].to(dt))
        scores = (torch.einsum("bshr,btr->bhst", qa, ckv)
                  + torch.einsum("bshr,btr->bhst", q_rope, k_rope)) * scale
        probs = _softmax_f32(scores, mask, dt)
        ctxa = torch.einsum("bhst,btr->bshr", probs, ckv)  # (B, S, H, kv_lora)
        ctx = torch.einsum("bshr,rhv->bshv", ctxa, p["wuv"].to(dt))
    elif cache is None and S >= CHUNK_THRESHOLD and S % CHUNK_SIZE == 0:
        # chunked prefill / train: K/V expanded from the latent one chunk at
        # a time (never the (S, T) scores or the whole expanded K/V)
        chunk = CHUNK_SIZE
        wuk, wuv = p["wuk"].to(dt), p["wuv"].to(dt)

        def kv_chunk(c):
            ckv_c = ckv[:, c * chunk:(c + 1) * chunk]
            kr_c = k_rope[:, c * chunk:(c + 1) * chunk]
            k_nope_c = torch.einsum("btr,rhn->bthn", ckv_c, wuk)
            kr_b = kr_c[:, :, None, :].expand(*kr_c.shape[:2], H, rope)
            kc = torch.cat([k_nope_c, kr_b], dim=-1)
            vc = torch.einsum("btr,rhv->bthv", ckv_c, wuv)
            return kc, vc

        # a (B, S, H, 1, D) view: KV = H, G = 1
        q5 = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :] * scale
        ctx = _chunked_causal(q5, kv_chunk, S // chunk, chunk, positions, dt,
                              v_dim=vdim)[:, :, :, 0, :]
    else:
        # naive: per-head keys and values expanded from the latent
        k_nope = torch.einsum("btr,rhn->bthn", ckv, p["wuk"].to(dt))
        v = torch.einsum("btr,rhv->bthv", ckv, p["wuv"].to(dt))
        scores = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
                  + torch.einsum("bshr,btr->bhst", q_rope, k_rope)) * scale
        probs = _softmax_f32(scores, mask, dt)
        ctx = torch.einsum("bhst,bthv->bshv", probs, v)

    out = torch.einsum("bshv,hvd->bsd", ctx, p["wo"].to(dt))
    return out, new_cache
