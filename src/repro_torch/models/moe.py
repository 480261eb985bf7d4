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

* ``moe_ffn_ep`` / ``moe_ffn_ep_zero3`` — JAX's expert-parallel paths,
  under the port's ``dist/sharding.shard_map`` over a ``Mesh`` whose
  ranks share one device: each rank dispatches (``_slot_maps`` with its
  expert offset and capacity C) to the experts it holds, and one psum
  combines the groups.  At ``capacity_factor`` 1.25 slots past C drop, as
  in JAX; ``_expert_ffn`` casts every local expert, empty ones included,
  so one call reads every expert's weights.  ``ep_plan`` gives the
  numbers a call runs with (mode, E_loc, C, chunks).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P

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
    flat = top_i.reshape(-1)
    # bincount's counts by an integer scatter-add, which has a meta kernel
    counts = flat.new_zeros(E).scatter_add_(0, flat, torch.ones_like(flat)).float()
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


# ---------------------------------------------------------------------------
# expert-parallel path (shard_map)
# ---------------------------------------------------------------------------

def ep_mode(cfg: LMConfig, mesh, *, model_axis="model", data_axis="data") -> str:
    """How expert weights shard:

    '2d'     — experts over (model x data): E % (model*data) == 0.
               Every rank owns whole experts; nothing else to slice.
    'fslice' — experts over model, expert d_ff over data.
    'model'  — experts over model only (weights replicated over data — only
               sane for small E*d*f).
    """
    msz = mesh.shape.get(model_axis, 1)
    dsz = mesh.shape.get(data_axis, 1)
    E, f = cfg.num_experts, cfg.moe_d_ff
    if E % (msz * dsz) == 0:
        return "2d"
    if E % msz == 0 and f % dsz == 0:
        return "fslice"
    return "model"


def expert_weight_specs(cfg: LMConfig, mesh, *, model_axis="model", data_axis="data"):
    mode = ep_mode(cfg, mesh, model_axis=model_axis, data_axis=data_axis)
    if mode == "2d":
        e = P((model_axis, data_axis), None, None)
        return mode, {"wg": e, "wu": e, "wd": e}
    if mode == "fslice":
        return mode, {
            "wg": P(model_axis, None, data_axis),
            "wu": P(model_axis, None, data_axis),
            "wd": P(model_axis, data_axis, None),
        }
    e = P(model_axis, None, None)
    return mode, {"wg": e, "wu": e, "wd": e}


@dataclasses.dataclass(frozen=True)
class EPPlan:
    """What one ``moe_ffn_ep`` call on a (B, S) batch runs with."""

    mode: str
    ranks: int
    E_loc: int  # experts a rank holds
    C: int  # slots per local expert and chunk
    chunks: int
    tc_loc: int  # a rank's tokens per chunk, before the gather
    T_g: int  # tokens a rank dispatches per chunk, after it
    gather: bool  # tokens all-gathered over data
    psum_axes: tuple


def ep_plan(cfg: LMConfig, mesh, batch_axes: tuple, B: int, S: int, *,
            model_axis: str = "model", data_axis: str = "data") -> EPPlan:
    """JAX's ``moe_ffn_ep`` arithmetic: tokens are gathered over data when
    the batch is sharded on it; the chunk is ``MOE_CHUNK_TOKENS`` gathered
    tokens, cut to a divisor of the rank's tokens; C = max(ceil(T_g k / E
    capacity_factor), 8)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    mode = ep_mode(cfg, mesh, model_axis=model_axis, data_axis=data_axis)
    msz = mesh.shape.get(model_axis, 1)
    dsz = mesh.shape.get(data_axis, 1)
    batch_shards = math.prod(mesh.shape[a] for a in batch_axes)
    do_gather = data_axis in batch_axes and dsz > 1
    gsz = dsz if do_gather else 1
    T_loc = (B // max(batch_shards, 1)) * S  # tokens per rank before gather
    tc_loc = max(1, min(T_loc, max(MOE_CHUNK_TOKENS // gsz, 1)))
    while T_loc % tc_loc:
        tc_loc -= 1
    T_g = tc_loc * gsz  # gathered tokens per chunk
    E_loc = E // (msz * dsz) if mode == "2d" else E // msz
    C = max(int(math.ceil(T_g * k / E * cfg.capacity_factor)), 8)
    psum_axes = ((model_axis, data_axis) if (mode in ("2d", "fslice") and dsz > 1)
                 else (model_axis,))
    return EPPlan(mode=mode, ranks=math.prod(mesh.shape.values()), E_loc=E_loc, C=C,
                  chunks=T_loc // tc_loc, tc_loc=tc_loc, T_g=T_g, gather=do_gather,
                  psum_axes=psum_axes)


def _dispatch_local(xg, pg, wg, wu, wd, cfg: LMConfig, eo: int, E_loc: int, C: int):
    """One rank's share of a chunk: top-k of the (T, E) probabilities, its
    experts' slots (``_slot_maps`` from offset ``eo``, capacity C), the
    expert FFNs over the gathered (E_loc, C, d) rows and the weighted
    scatter-add into (T, d)."""
    T, d = xg.shape
    top_w, top_i = topk_weights(pg, cfg)
    # slot-map dispatch: scatter token INDICES (not d-wide rows) so nothing
    # of size (T*k, d) materialises
    slot_tok, slot_w = _slot_maps(top_i, top_w, eo, E_loc, C, T, cfg.num_experts_per_tok,
                                  xg.dtype)
    xg_pad = torch.cat([xg, xg.new_zeros((1, d))])
    tok = slot_tok.long()
    hbuf = _expert_ffn(xg_pad[tok], wg, wu, wd, cfg.activation)
    contrib = hbuf * slot_w[..., None]
    out = xg.new_zeros((T + 1, d)).index_add(0, tok.reshape(-1), contrib.reshape(-1, d))
    return out[:T]


def moe_ffn_ep(
    x: torch.Tensor,
    probs: torch.Tensor,
    p: dict,
    cfg: LMConfig,
    *,
    mesh,
    batch_axes: tuple[str, ...],
    model_axis: str = "model",
    data_axis: str = "data",
) -> torch.Tensor:
    """Gathered-token expert parallelism under ``shard_map``: x (B, S, d)
    and probs (B, S, E) sharded over ``batch_axes``; per chunk every rank
    all-gathers the tokens over data, dispatches them to the experts it
    owns (2d: model-major, data-minor), and one psum over ``psum_axes``
    folds the expert groups and d_ff slices; each rank keeps its own
    tokens' rows."""
    E = cfg.num_experts
    B, S, d = x.shape
    plan = ep_plan(cfg, mesh, batch_axes, B, S, model_axis=model_axis, data_axis=data_axis)
    dsz = mesh.shape.get(data_axis, 1)
    tc_loc, E_loc = plan.tc_loc, plan.E_loc

    def local_moe(x_loc, probs_loc, wg, wu, wd):
        Bl = x_loc.shape[0]
        xf_l = x_loc.reshape(-1, d)
        pf_l = probs_loc.reshape(-1, E)
        if plan.mode == "2d":
            eo = (sharding.axis_index(model_axis) * dsz
                  + sharding.axis_index(data_axis)) * E_loc
        else:
            eo = sharding.axis_index(model_axis) * E_loc
        outs = []
        for c in range(plan.chunks):
            xc = xf_l[c * tc_loc:(c + 1) * tc_loc]
            pc = pf_l[c * tc_loc:(c + 1) * tc_loc]
            if plan.gather:
                xg = sharding.all_gather(xc, data_axis, axis=0, tiled=True)
                pg = sharding.all_gather(pc, data_axis, axis=0, tiled=True)
            else:
                xg, pg = xc, pc
            out = _dispatch_local(xg, pg, wg, wu, wd, cfg, eo, E_loc, plan.C)
            # one psum folds expert groups (model[, data]) + f-slice partials
            out = sharding.psum(out, plan.psum_axes)
            if plan.gather:
                out = out.narrow(0, sharding.axis_index(data_axis) * tc_loc, tc_loc)
            outs.append(out)
        return torch.cat(outs).reshape(Bl, S, d)

    bspec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    x_spec = P(bspec, None, None)
    _, wspecs = expert_weight_specs(cfg, mesh, model_axis=model_axis, data_axis=data_axis)
    fn = sharding.shard_map(
        local_moe,
        mesh=mesh,
        in_specs=(x_spec, x_spec, wspecs["wg"], wspecs["wu"], wspecs["wd"]),
        out_specs=x_spec,
    )
    return fn(x, probs, p["wg"], p["wu"], p["wd"])


def moe_ffn_ep_zero3(
    x: torch.Tensor,
    probs: torch.Tensor,
    p: dict,
    cfg: LMConfig,
    *,
    mesh,
    batch_axes: tuple[str, ...],
    model_axis: str = "model",
) -> torch.Tensor:
    """JAX's original formulation: experts sharded over 'model' only (in
    JAX the expert weights are ZeRO-3 over 'data', gathered whole per
    layer; on one device each rank reads its experts whole).  Local
    dispatch of the rank's own tokens, no gather, psum over model."""
    E = cfg.num_experts
    k = cfg.num_experts_per_tok
    model_size = mesh.shape[model_axis]
    if E % model_size:
        raise ValueError(f"{E} experts do not split over {model_size} model ranks")
    E_loc = E // model_size
    batch_shards = math.prod(mesh.shape[a] for a in batch_axes)
    B, S, d = x.shape
    T_loc = (B // batch_shards) * S
    C = max(int(math.ceil(T_loc * k / E * cfg.capacity_factor)), 8)

    def local_moe(x_loc, probs_loc, wg, wu, wd):
        Bl = x_loc.shape[0]
        eo = sharding.axis_index(model_axis) * E_loc
        out = _dispatch_local(x_loc.reshape(-1, d), probs_loc.reshape(-1, E), wg, wu, wd,
                              cfg, eo, E_loc, C)
        return sharding.psum(out, model_axis).reshape(Bl, S, d)

    bspec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    x_spec = P(bspec, None, None)
    e_spec = P(model_axis, None, None)
    fn = sharding.shard_map(
        local_moe,
        mesh=mesh,
        in_specs=(x_spec, x_spec, e_spec, e_spec, e_spec),
        out_specs=x_spec,
    )
    return fn(x, probs, p["wg"], p["wu"], p["wd"])
