"""Dry-run cell builders — port of ``repro/launch/cells.py``: (architecture
x input shape x mesh) -> a step with abstract arguments.

Every assigned cell resolves here, as in JAX:
  LM:     train_4k -> train_step;  prefill_32k -> prefill;
          decode_32k / long_500k -> one decode step against a full KV cache
  GNN:    full/sampled/batched -> train_step
  RecSys: train_batch -> train_step; serve_* -> forward; retrieval_cand ->
          query-vs-1M top-k scoring

JAX lowers each step under ``jax.jit`` over ``ShapeDtypeStruct``s.  The
port has no HLO, so a ``BuiltCell`` holds, in place of ``lowered``: the
step callable; its abstract arguments (meta tensors: ``params.
abstract_params`` and the optimizer's ``init`` run on them); the in / out
``P`` trees JAX passes to ``jit``; and ``meta`` with JAX's keys and
values.  ``launch/dryrun`` runs the step once on the abstract arguments
over a mesh of meta ranks; ``BuiltCell.materialize`` builds real
arguments on a device from a ``torch.Generator``, which is how the card
runs a cell (the mesh's ranks then share that device).

Port-only arguments of ``build_lm_cell`` cut a cell to one card:
``reduce_cfg`` (``LMConfig`` fields, e.g. the depth), ``batch`` and
``seq_len``; they are applied after JAX's rules, which read the published
config and shape, and are recorded in ``meta["reduced"]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import (
    GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, GNNShape, LMShape, RecsysShape,
)
from repro_torch.dist import sharding as shard_lib
from repro_torch.dist.sharding import P
from repro_torch.models import params as plib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as steps

# per-arch training knobs (microbatching keeps live activations bounded;
# adafactor for multi-B-param models; bf16 params >= 100B — DESIGN.md §6)
LM_TRAIN_OPTS = {
    "smollm-135m": dict(microbatches=1, opt="adamw"),
    "deepseek-coder-33b": dict(microbatches=16, opt="adafactor"),
    "gemma-2b": dict(microbatches=4, opt="adamw"),
    "qwen3-moe-235b-a22b": dict(microbatches=16, opt="adafactor", param_dtype="bfloat16"),
    "deepseek-v3-671b": dict(microbatches=16, opt="adafactor", param_dtype="bfloat16"),
}

#: materialize(device, generator) -> the step's arguments on ``device``
Materializer = Callable[[torch.device, torch.Generator], tuple]


@dataclasses.dataclass
class BuiltCell:
    arch: str
    shape: str
    step_name: str
    step: Callable
    args: tuple  # abstract: meta tensors
    in_specs: tuple  # a P tree per argument
    out_specs: Any  # a P tree of the outputs (None: replicated)
    meta: dict
    cfg: Any
    dctx: shard_lib.DistCtx
    batch_per_call: int  # sequences (rows) one model call sees
    _materialize: Materializer

    def materialize(self, device, generator: torch.Generator) -> tuple:
        """The step's arguments drawn on ``device`` from ``generator``
        (which lives there): parameters as ``params.init_params`` draws
        them, optimizer state from ``init``, a batch of random ids."""
        return self._materialize(torch.device(device), generator)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _adafactor_spec_tree(decls, dctx):
    def leaf(_, p):
        spec = tuple(dctx.w_rules.get(n) for n in p.logical)
        if len(p.shape) >= 2:
            return {"vr": P(*spec[:-1]), "vc": P(*(spec[:-2] + spec[-1:]))}
        return {"v": P(*spec)}

    return opt_lib.AdafactorState(step=P(), stats=plib.map_decls(leaf, decls))


def _batch_spec(dctx, *extra):
    b = dctx.a_rules.get("batch")
    return P(b, *extra)


def _model_flops_lm(cfg, *, tokens: int, kind: str, kv_len: float = 0) -> float:
    """6·N_active·D for training, 2·N_active per token for inference, plus
    attention score/value flops."""
    n_active = _lm_active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention scores+values: 4 flops per (token, ctx position, head, dim);
    # causal halves the train/prefill context, bwd triples training.
    H, Dh = cfg.num_heads, cfg.head_dim
    if cfg.attention == "mla":
        Dh = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    per_tok_ctx = kv_len / 2 if kind in ("train", "prefill") else kv_len
    flops += (3.0 if kind == "train" else 1.0) * 4.0 * tokens * per_tok_ctx * H * Dh
    return flops


def _lm_active_params(cfg) -> float:
    from repro_torch.models.transformer import lm_decls

    total = 0.0
    for path, p in plib.leaves(lm_decls(cfg)):
        size = float(math.prod(p.shape))
        key = path.split(".")
        if key[0] == "moe_blocks" and key[1] == "mlp" and key[2] in ("wg", "wu", "wd"):
            size *= cfg.num_experts_per_tok / cfg.num_experts
        total += size
    return total


def _tokens(B: int, S: int, vocab: int) -> Materializer:
    return lambda dev, g: torch.randint(0, vocab, (B, S), generator=g, device=dev,
                                        dtype=torch.int32)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def build_lm_cell(arch: str, shape: LMShape, mesh, *, mla_absorb: bool = False,
                  overrides: Optional[dict] = None, reduce_cfg: Optional[dict] = None,
                  batch: Optional[int] = None, seq_len: Optional[int] = None) -> BuiltCell:
    from repro_torch.models import transformer

    cfg = configs.get(arch)
    opts = dict(LM_TRAIN_OPTS[arch])
    if overrides:
        opts.update(overrides)
    if shape.kind != "train" and plib.param_count(transformer.lm_decls(cfg)) > 2e9:
        # serving holds no optimizer state: bf16 weights halve HBM
        opts.setdefault("param_dtype", "bfloat16")
    if "param_dtype" in opts:
        cfg = dataclasses.replace(cfg, param_dtype=opts["param_dtype"])
    reduced = {}
    if reduce_cfg:
        cfg = dataclasses.replace(cfg, **reduce_cfg)
        reduced.update(reduce_cfg)
    B = batch or shape.global_batch
    S = seq_len or shape.seq_len
    if batch:
        reduced["batch"] = B
    if seq_len:
        reduced["seq_len"] = S
    dctx = shard_lib.lm_policy(
        cfg, mesh, kind=shape.kind, batch=B,
        moe_impl=opts.get("moe_impl", "gathered"),
    )
    decls = transformer.lm_decls(cfg)
    params_abs = plib.abstract_params(decls)
    pspecs = dctx.shard_w(decls)
    meta = {
        "arch": arch, "shape": shape.name, "family": "lm",
        "params": plib.param_count(decls),
        "active_params": _lm_active_params(cfg),
        "mesh": dict(mesh.shape),
    }
    if reduced:
        meta["reduced"] = reduced

    def params_of(dev, g):
        return plib.init_params(decls, generator=g, device=dev)

    def cell(step_name, step, args, in_specs, out_specs, per_call, make):
        return BuiltCell(arch, shape.name, step_name, step, args, in_specs, out_specs,
                         meta, cfg, dctx, per_call, make)

    if shape.kind == "train":
        opt = opt_lib.OPTIMIZERS[opts["opt"]](1e-4)
        ostate_abs = opt.init(params_abs)
        ospecs = (
            _adafactor_spec_tree(decls, dctx)
            if opts["opt"] == "adafactor"
            else opt_lib.AdamWState(step=P(), mu=pspecs, nu=pspecs)
        )
        # per-microbatch batch must stay divisible by the batch shards, or
        # the MoE EP path degrades to the dense fallback
        shards = 1
        for a in dctx.batch_axes:
            shards *= mesh.shape[a]
        mb = min(opts.get("microbatches", 1), max(1, B // max(shards, 1)))
        while mb > 1 and (B % mb or (B // mb) % max(shards, 1)):
            mb -= 1
        opts["microbatches"] = mb
        step = steps.make_train_step(cfg, "lm", opt, dctx, microbatches=mb)
        batch_abs = {"tokens": _meta((B, S), torch.int32)}
        bspecs = {"tokens": _batch_spec(dctx, None)}
        meta["model_flops"] = _model_flops_lm(cfg, tokens=B * S, kind="train", kv_len=S)
        meta["microbatches"] = opts.get("microbatches", 1)
        tokens = _tokens(B, S, cfg.vocab_size)

        def make(dev, g):
            params = params_of(dev, g)
            return params, opt.init(params), {"tokens": tokens(dev, g)}

        return cell("train_step", step, (params_abs, ostate_abs, batch_abs),
                    (pspecs, ospecs, bspecs), (pspecs, ospecs, None), B // mb, make)

    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(cfg, dctx, max_len=S)
        tokens = _tokens(B, S, cfg.vocab_size)
        meta["model_flops"] = _model_flops_lm(cfg, tokens=B * S, kind="prefill", kv_len=S / 2)
        # JAX leaves prefill's out_shardings to XLA; the cache takes its specs
        return cell("prefill", prefill, (params_abs, _meta((B, S), torch.int32)),
                    (pspecs, _batch_spec(dctx, None)), (P(), _cache_specs(cfg, dctx)), B,
                    lambda dev, g: (params_of(dev, g), tokens(dev, g)))

    # decode
    decode = steps.make_decode_step(cfg, dctx, mla_absorb=mla_absorb)
    cache_abs = transformer.init_cache(cfg, B, S, None, device="meta")
    cspecs = _cache_specs(cfg, dctx)
    tokens = _tokens(B, 1, cfg.vocab_size)
    meta["model_flops"] = _model_flops_lm(cfg, tokens=B, kind="decode", kv_len=S)
    meta["mla_absorb"] = mla_absorb

    def make(dev, g):
        return (params_of(dev, g), transformer.init_cache(cfg, B, S, None, device=dev),
                tokens(dev, g), torch.tensor(S - 1, dtype=torch.int32, device=dev))

    return cell("decode_step", decode,
                (params_abs, cache_abs, _meta((B, 1), torch.int32), _meta((), torch.int32)),
                (pspecs, cspecs, _batch_spec(dctx, None), P()), (None, cspecs), B, make)


def _cache_specs(cfg, dctx):
    a = dctx.a_rules
    batch = a.get("batch")
    kv_seq = a.get("kv_seq")
    out = {}
    if cfg.attention == "mla":
        def mk():
            return {"ckv": P(None, batch, kv_seq, None), "krope": P(None, batch, kv_seq, None)}
    else:
        kvh = a.get("kv_heads")

        def mk():
            return {"k": P(None, batch, kv_seq, kvh, None), "v": P(None, batch, kv_seq, kvh, None)}
    if cfg.num_dense_layers > 0:
        out["dense"] = mk()
    if cfg.num_moe_layers > 0:
        out["moe"] = mk()
    return out


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad_to(n: int, mult: int) -> int:
    return n + (-n) % mult


def build_gnn_cell(arch: str, shape: GNNShape, mesh) -> BuiltCell:
    from repro_torch.models import gnn

    cfg = configs.get(arch)
    dctx = shard_lib.gnn_policy(cfg, mesh)
    n_dev = math.prod(mesh.shape.values())
    meta = {"arch": arch, "shape": shape.name, "family": "gnn", "mesh": dict(mesh.shape)}

    if shape.kind == "sampled":
        # fanout-tree static sizes (models/sampler.py)
        f = shape.fanout
        n_nodes = shape.batch_nodes * math.prod(x + 1 for x in f)
        n_edges = shape.batch_nodes * sum(math.prod(f[: i + 1]) for i in range(len(f)))
        d_feat = shape.d_feat
    elif shape.kind == "batched":
        n_nodes = shape.n_nodes * shape.n_graphs
        n_edges = shape.n_edges * shape.n_graphs
        d_feat = shape.d_feat
    else:
        n_nodes, n_edges, d_feat = shape.n_nodes, shape.n_edges, shape.d_feat

    e_pad = _pad_to(n_edges, 2 * n_dev)
    decls = gnn.gcn_decls(cfg, d_feat)
    params_abs = plib.abstract_params(decls)
    pspecs = dctx.shard_w(decls)
    opt = opt_lib.adamw(1e-2)
    ostate_abs = opt.init(params_abs)
    ospecs = opt_lib.AdamWState(step=P(), mu=pspecs, nu=pspecs)
    step = steps.make_train_step(cfg, "gnn", opt, dctx)
    edge_axes = dctx.a_rules.get("edges")
    batch_abs = {
        "x": _meta((n_nodes, d_feat), torch.float32),
        "edges": _meta((2, e_pad), torch.int32),
        "labels": _meta((n_nodes,), torch.int32),
        "label_mask": _meta((n_nodes,), torch.float32),
    }
    bspecs = {
        "x": P(None, None),
        "edges": P(None, edge_axes),
        "labels": P(None),
        "label_mask": P(None),
    }
    # GCN flops: 2 * E * d_out per conv (messages) + 2 * n * d_in * d_out (xW)
    dims = [d_feat] + [cfg.d_hidden] * (cfg.num_layers - 1) + [cfg.num_classes]
    fl = 0.0
    for i in range(cfg.num_layers):
        fl += 2.0 * n_nodes * dims[i] * dims[i + 1] + 2.0 * n_edges * dims[i + 1]
    meta["model_flops"] = 3.0 * fl  # fwd + bwd(2x)
    meta["n_nodes"], meta["n_edges"] = n_nodes, e_pad

    def make(dev, g):
        params = plib.init_params(decls, generator=g, device=dev)
        edges = torch.full((2, e_pad), -1, dtype=torch.int32, device=dev)
        edges[:, :n_edges] = torch.randint(0, n_nodes, (2, n_edges), generator=g, device=dev,
                                           dtype=torch.int32)
        batch = {
            "x": torch.randn((n_nodes, d_feat), generator=g, device=dev),
            "edges": edges,
            "labels": torch.randint(0, cfg.num_classes, (n_nodes,), generator=g, device=dev,
                                    dtype=torch.int32),
            "label_mask": torch.ones((n_nodes,), device=dev),
        }
        return params, opt.init(params), batch

    return BuiltCell(arch, shape.name, "train_step", step, (params_abs, ostate_abs, batch_abs),
                     (pspecs, ospecs, bspecs), (pspecs, ospecs, None), meta, cfg, dctx,
                     n_nodes, make)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_ids(cfg, B: int) -> Materializer:
    """(B, F) per-field ids, each field's uniform over its vocabulary."""
    def make(dev, g):
        vocab = torch.tensor(cfg.vocabs[: cfg.n_sparse], dtype=torch.float64, device=dev)
        u = torch.rand((B, cfg.n_sparse), generator=g, device=dev, dtype=torch.float64)
        return (u * vocab).to(torch.int32)
    return make


def build_recsys_cell(arch: str, shape: RecsysShape, mesh) -> BuiltCell:
    from repro_torch.models import recsys

    cfg = configs.get(arch)
    dctx = shard_lib.recsys_policy(cfg, mesh, batch=shape.batch)
    decls = recsys.recsys_decls(cfg)
    params_abs = plib.abstract_params(decls)
    pspecs = dctx.shard_w(decls)
    B, F = shape.batch, cfg.n_sparse
    meta = {
        "arch": arch, "shape": shape.name, "family": "recsys",
        "params": plib.param_count(decls), "mesh": dict(mesh.shape),
    }
    # dense-compute flops per example (interaction + mlp), embedding ignored
    dense_flops = _recsys_dense_flops(cfg)
    ids = _recsys_ids(cfg, B)

    def params_of(dev, g):
        return plib.init_params(decls, generator=g, device=dev)

    def cell(step_name, step, args, in_specs, out_specs, make):
        return BuiltCell(arch, shape.name, step_name, step, args, in_specs, out_specs, meta,
                         cfg, dctx, B, make)

    if shape.kind == "train":
        opt = opt_lib.adamw(1e-3)
        ostate_abs = opt.init(params_abs)
        ospecs = opt_lib.AdamWState(step=P(), mu=pspecs, nu=pspecs)
        step = steps.make_train_step(cfg, "recsys", opt, dctx)
        batch_abs = {"ids": _meta((B, F), torch.int32), "labels": _meta((B,), torch.float32)}
        bspecs = {"ids": _batch_spec(dctx, None), "labels": _batch_spec(dctx)}
        meta["model_flops"] = 3.0 * B * dense_flops

        def make(dev, g):
            params = params_of(dev, g)
            labels = (torch.rand((B,), generator=g, device=dev) < 0.5).float()
            return params, opt.init(params), {"ids": ids(dev, g), "labels": labels}

        return cell("train_step", step, (params_abs, ostate_abs, batch_abs),
                    (pspecs, ospecs, bspecs), (pspecs, ospecs, None), make)

    if shape.kind == "serve":
        serve = steps.make_serve_step(cfg, "recsys", dctx)
        meta["model_flops"] = 1.0 * B * dense_flops
        return cell("serve", serve, (params_abs, {"ids": _meta((B, F), torch.int32)}),
                    (pspecs, {"ids": _batch_spec(dctx, None)}), _batch_spec(dctx),
                    lambda dev, g: (params_of(dev, g), {"ids": ids(dev, g)}))

    # retrieval: 1 query vs n_candidates (padded to a 512-divisible power)
    N = _pad_to(shape.n_candidates, 512 * 2048)
    retrieve = steps.make_retrieval_step(cfg, dctx, k=100)
    batch_abs = {"ids": _meta((B, F), torch.int32),
                 "candidates": _meta((N, cfg.embed_dim), torch.float32)}
    cand_axes = dctx.a_rules.get("cand")
    bspecs = {"ids": P(None, None), "candidates": P(cand_axes, None)}
    meta["model_flops"] = 2.0 * B * N * cfg.embed_dim
    meta["n_candidates_padded"] = N

    def make(dev, g):
        return params_of(dev, g), {
            "ids": ids(dev, g),
            "candidates": torch.randn((N, cfg.embed_dim), generator=g, device=dev)}

    return cell("retrieval", retrieve, (params_abs, batch_abs), (pspecs, bspecs), None, make)


def _recsys_dense_flops(cfg) -> float:
    F, D = cfg.n_sparse, cfg.embed_dim
    fl = 2.0 * F * D  # FM sum-square trick
    dims = (F * D,) + tuple(cfg.mlp) + ((1,) if cfg.mlp else ())
    for a, b in zip(dims[:-1], dims[1:]):
        fl += 2.0 * a * b
    if cfg.interaction == "cin":
        hs = (F,) + tuple(cfg.cin_layers)
        for hprev, hnext in zip(hs[:-1], hs[1:]):
            fl += 2.0 * hprev * F * D + 2.0 * hnext * hprev * F * D
    if cfg.interaction == "self-attn":
        d_in = D
        for _ in range(cfg.n_attn_layers):
            dh = cfg.n_heads * cfg.d_attn
            fl += 3 * 2.0 * F * d_in * dh + 2 * 2.0 * F * F * dh + 2.0 * F * d_in * dh
            d_in = dh
    return fl


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in ["smollm-135m", "deepseek-coder-33b", "gemma-2b",
                 "qwen3-moe-235b-a22b", "deepseek-v3-671b"]:
        for sh in LM_SHAPES:
            out.append((arch, sh.name))
    for sh in GNN_SHAPES:
        out.append(("gcn-cora", sh.name))
    for arch in ["deepfm", "xdeepfm", "fm", "autoint"]:
        for sh in RECSYS_SHAPES:
            out.append((arch, sh.name))
    return out


def build(arch: str, shape_name: str, mesh, **kw) -> BuiltCell:
    fam = configs.family(arch)
    if fam == "lm":
        shape = next(s for s in LM_SHAPES if s.name == shape_name)
        return build_lm_cell(arch, shape, mesh, **kw)
    if fam == "gnn":
        shape = next(s for s in GNN_SHAPES if s.name == shape_name)
        return build_gnn_cell(arch, shape, mesh)
    if fam == "recsys":
        shape = next(s for s in RECSYS_SHAPES if s.name == shape_name)
        return build_recsys_cell(arch, shape, mesh)
    raise KeyError(arch)
