"""The mesh, ``shard_map`` and the sharding policies — port of
``repro/dist/sharding.py``.

Models never name mesh axes.  They declare parameters with *logical* axis
names (``models/params.py``) and wrap activations in ``act(dctx, x,
*names)``; a per-(arch, mesh, input-shape) policy maps those names to mesh
axes:

* ``w_rules`` — logical weight axis -> mesh axis (None = replicated); the
  derived ``DistCtx.shard_w(decls)`` tree of ``P`` specs says how each
  rank's block of a weight is cut;
* ``a_rules`` — activation axis name -> mesh axis.

``lm_policy`` encodes JAX's decision tree word for word: tensor-parallel
attention over heads when the head count divides the model axis (else
sequence-parallel attention), FSDP over the data axis above a parameter
threshold, expert sharding per ``models.moe.ep_mode``, and decode-time
KV-cache sequence sharding that absorbs whichever axes the (tiny) decode
batch cannot use.

The port's mesh holds its ranks on ONE device (``Mesh.device``, the card
or the CPU): JAX's counterpart is a mesh of forced host devices in one
process.  ``shard_map`` runs ``f`` once per rank, each rank on its
contiguous block of every input; inside ``f`` the collectives
``axis_index``, ``all_gather`` and ``psum`` are exact.  The ranks are
threads of the calling process, and one runs at a time: the baton passes
in rank order at every collective, so the device holds one rank's
temporaries at a time and a run is deterministic.  ``act`` returns its
input: every rank shares one device, so a layout constraint moves nothing
(the port has no GSPMD).  Serving only: ``shard_map`` refuses inputs that
require grad while autograd records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.models import params as plib

# FSDP pays one weight all-gather per layer; below ~1B parameters the
# weights fit replicated and the gather is pure overhead.
FSDP_PARAM_THRESHOLD = 1_000_000_000

AxisNames = Union[None, str, tuple]


# ---------------------------------------------------------------------------
# mesh and partition specs
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over ranks that share one ``torch.device``.

    ``shape`` is an ordered name -> size mapping (JAX's ``Mesh.shape``);
    rank r has the row-major coordinates of r over ``axis_names``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)}")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh shape {tuple(shape)}: every axis needs a rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: int) -> dict[str, int]:
        """Rank -> {axis: index}, row-major (the last axis minor)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): one entry per dimension,
    each None (replicated), an axis name, or a tuple of names (split over
    their product, the first name major).  A one-name tuple is that name,
    as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _names(entry: AxisNames) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _linear(mesh: Mesh, coords: dict, names: tuple) -> int:
    """The block index of a rank along a split over ``names`` (first
    major)."""
    idx = 0
    for name in names:
        idx = idx * mesh.shape[name] + coords[name]
    return idx


def _block(x: torch.Tensor, spec: P, mesh: Mesh, coords: dict) -> torch.Tensor:
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the input's {x.dim()} dims")
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        parts = math.prod(mesh.shape[n] for n in names)
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split "
                             f"{parts} ways over {names}")
        size = x.shape[dim] // parts
        x = x.narrow(dim, _linear(mesh, coords, names) * size, size)
    return x


def _spec_axes(spec: P, mesh: Mesh) -> set:
    """The mesh axes ``spec`` names; each must be an axis of ``mesh``."""
    used = {n for e in spec for n in _names(e)}
    for name in used:
        if name not in mesh.shape:
            raise ValueError(f"spec {spec} names {name!r}, not an axis of {mesh}")
    return used


def local_blocks(x: torch.Tensor, spec: P, mesh: Mesh) -> list[torch.Tensor]:
    """Each rank's contiguous block of the global ``x`` under ``spec``, in
    rank order: views, nothing copied.  What ``shard_map`` hands ``f``, and
    how a rank slices a weight tree (``DistCtx.shard_w``)."""
    _spec_axes(spec, mesh)
    return [_block(x, spec, mesh, mesh.coords(r)) for r in range(mesh.size)]


def _assemble(outs: list, spec: P, mesh: Mesh) -> torch.Tensor:
    """The global output from the ranks' blocks: the axes ``spec`` names
    lay the blocks out; along an axis it does not name, rank 0's block is
    taken (JAX with the replication check off)."""
    used = _spec_axes(spec, mesh)
    if not used:
        return outs[0]
    shape = list(outs[0].shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= math.prod(mesh.shape[n] for n in _names(entry))
    out = outs[0].new_empty(shape)
    for r, part in enumerate(outs):
        coords = mesh.coords(r)
        if any(coords[a] for a in mesh.axis_names if a not in used):
            continue
        if part.shape != outs[0].shape:
            raise ValueError(f"rank {r} returned {tuple(part.shape)}, rank 0 "
                             f"{tuple(outs[0].shape)}")
        _block(out, spec, mesh, coords).copy_(part)
    return out


# ---------------------------------------------------------------------------
# shard_map: one thread per rank, one rank running at a time
# ---------------------------------------------------------------------------

class _Aborted(Exception):
    """Another rank failed: this one stops at its next collective."""


_RANK = threading.local()


class _Run:
    """The baton and the collectives of one ``shard_map`` call.

    Rank r runs while it holds its baton (a semaphore of its own).  At a
    collective it posts its operand and hands the baton to r + 1; the last
    rank completes the round (every group's result, once) and hands it
    back to rank 0, so the ranks resume in order, each with its group's
    result.  Only the baton's holder touches the shared state.  A rank
    that raises sets ``error`` and wakes every rank, which then aborts."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.coords = [mesh.coords(r) for r in range(self.n)]
        self.batons = [threading.Semaphore(0) for _ in range(self.n)]
        self.error: Optional[BaseException] = None
        self.posted: list = [None] * self.n
        self.results: list = [None] * self.n

    def wait(self, r: int) -> None:
        """Block until rank r holds the baton."""
        self.batons[r].acquire()
        if self.error is not None:
            raise _Aborted

    def collective(self, r: int, op: tuple, x: torch.Tensor):
        self.posted[r] = (op, x)
        if r + 1 < self.n:
            self.batons[r + 1].release()
        else:
            self._complete()
            self.batons[0].release()
        self.wait(r)
        out, self.results[r] = self.results[r], None
        return out

    def finish(self, r: int) -> None:
        if r + 1 < self.n:
            self.batons[r + 1].release()
        elif any(p is not None for p in self.posted):
            raise RuntimeError("shard_map: a rank returned while others wait at a "
                               "collective (the ranks called different collectives)")

    def fail(self, e: BaseException) -> None:
        if self.error is None:
            self.error = e
        for baton in self.batons:
            baton.release()

    def _complete(self) -> None:
        posted, self.posted = self.posted, [None] * self.n
        if any(p is None for p in posted) or len({p[0] for p in posted}) != 1:
            raise RuntimeError("shard_map: the ranks called different collectives: "
                               f"{[None if p is None else p[0] for p in posted]}")
        (kind, names, *args), mesh = posted[0][0], self.mesh
        groups: dict = {}
        for r, c in enumerate(self.coords):
            key = tuple(c[a] for a in mesh.axis_names if a not in names)
            groups.setdefault(key, []).append(r)
        for members in groups.values():
            xs = [posted[r][1] for r in members]
            if len({tuple(x.shape) for x in xs}) != 1:
                raise ValueError(f"shard_map: {kind} over {names}: the ranks' operands "
                                 f"differ in shape {[tuple(x.shape) for x in xs]}")
            if kind == "psum":
                out = xs[0].clone()
                for x in xs[1:]:
                    out += x
            else:
                axis, tiled = args
                order = sorted(members, key=lambda r: _linear(mesh, self.coords[r], names))
                parts = [posted[r][1] for r in order]
                out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
            for r in members:
                self.results[r] = out

    def rank_main(self, r: int, f: Callable, args: list, outs: list, modes: tuple) -> None:
        grad, inference, stream = modes
        try:
            self.wait(r)
            _RANK.run, _RANK.rank = self, r
            on_stream = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
            with torch.inference_mode(inference), torch.set_grad_enabled(grad), on_stream:
                outs[r] = f(*args)
            self.finish(r)
        except _Aborted:
            pass
        except BaseException as e:  # re-raised by shard_map in the caller
            self.fail(e)
        finally:
            _RANK.run = None


def _current() -> tuple[_Run, int]:
    run = getattr(_RANK, "run", None)
    if run is None:
        raise RuntimeError("collectives run only inside a shard_map rank")
    return run, _RANK.rank


def _axes(run: _Run, names) -> tuple:
    names = _names(names)
    for name in names:
        if name not in run.mesh.shape:
            raise ValueError(f"{name!r} is not an axis of {run.mesh}")
    return names


def axis_index(name: str) -> int:
    """This rank's index along mesh axis ``name``."""
    run, r = _current()
    return run.coords[r][_axes(run, name)[0]]


def all_gather(x: torch.Tensor, name, *, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The operands of every rank along ``name`` (an axis or a tuple of
    axes), in axis-index order: concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``.  The ranks of a group share the result."""
    run, r = _current()
    return run.collective(r, ("all_gather", _axes(run, name), axis, tiled), x)


def psum(x: torch.Tensor, names) -> torch.Tensor:
    """The sum of the operands of every rank along ``names`` (an axis or
    a tuple of axes), added in rank order.  The ranks of a group share the
    result."""
    run, r = _current()
    return run.collective(r, ("psum", _axes(run, names)), x)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``f`` mapped over the ranks of ``mesh`` (``jax.shard_map`` with the
    replication check off): each positional input is cut into its
    rank's block by its ``in_specs`` entry, ``f`` runs once per rank, and
    the outputs (one tensor, or a tuple matching a tuple of specs) are
    assembled by ``out_specs``.  Every input must live on ``mesh.device``.
    A rank's exception is re-raised here after every rank has stopped."""
    in_specs = tuple(in_specs)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} inputs, {len(in_specs)} in_specs")
        for a in args:
            if a.device != mesh.device:
                raise ValueError(f"shard_map: an input on {a.device}, the mesh on "
                                 f"{mesh.device}")
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            raise NotImplementedError("shard_map: no gradient through the port's "
                                      "shard_map yet (serving only)")
        blocks = [local_blocks(a, s, mesh) for a, s in zip(args, in_specs)]
        run = _Run(mesh)
        outs: list = [None] * mesh.size
        stream = (torch.cuda.current_stream(mesh.device) if mesh.device.type == "cuda"
                  else None)
        modes = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(), stream)
        threads = [threading.Thread(target=run.rank_main, name=f"shard_map rank {r}",
                                    args=(r, f, [b[r] for b in blocks], outs, modes),
                                    daemon=True)
                   for r in range(mesh.size)]
        for t in threads:
            t.start()
        run.batons[0].release()
        for t in threads:
            t.join()
        if run.error is not None:
            raise run.error
        if isinstance(out_specs, P) or not isinstance(out_specs, (tuple, list)):
            return _assemble(outs, out_specs, mesh)
        return tuple(_assemble([o[i] for o in outs], s, mesh)
                     for i, s in enumerate(out_specs))

    return mapped


# ---------------------------------------------------------------------------
# the distribution context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistCtx:
    """Mesh + resolved rules for one (arch, mesh, shape) cell."""

    mesh: Any
    w_rules: dict[str, Any]
    a_rules: dict[str, Any]
    options: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        b = self.a_rules.get("batch")
        if b is None:
            return ()
        return tuple(b) if isinstance(b, (tuple, list)) else (b,)

    def opt(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)

    def shard_w(self, decls) -> Any:
        """Param declarations -> ``P`` tree via w_rules."""
        return plib.map_decls(lambda _, p: P(*(self.w_rules.get(n) for n in p.logical)),
                              decls)


def act(dctx: Optional[DistCtx], x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """JAX constrains activation ``x`` so dim i lives on
    ``a_rules[names[i]]``.  Every rank of the port's mesh shares one
    device, so the layout moves nothing: ``x`` is returned as it is."""
    return x


# ---------------------------------------------------------------------------
# policy helpers
# ---------------------------------------------------------------------------

def _axis(mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def _batch_rule(mesh, batch: int):
    """Shard the batch over (pod, data) — largest prefix that divides it."""
    axes = [a for a in ("pod", "data") if _axis(mesh, a) > 1]
    while axes:
        shards = math.prod(_axis(mesh, a) for a in axes)
        if batch % shards == 0 and batch >= shards:
            return tuple(axes) if len(axes) > 1 else axes[0]
        axes.pop(0)  # drop pod first, then give up
    return None


# ---------------------------------------------------------------------------
# LM policy
# ---------------------------------------------------------------------------

def lm_policy(
    cfg,
    mesh,
    *,
    kind: str = "train",
    batch: int = 1,
    fsdp: Optional[bool] = None,
    moe_impl: str = "gathered",
) -> DistCtx:
    msz = _axis(mesh, "model")
    tp_heads = msz > 1 and cfg.num_heads % msz == 0
    if fsdp is None:
        from repro_torch.models.transformer import lm_decls

        fsdp = plib.param_count(lm_decls(cfg)) >= FSDP_PARAM_THRESHOLD
    fsdp_axis = "data" if (fsdp and _axis(mesh, "data") > 1) else None

    w_rules: dict[str, Any] = {
        "layers": None,
        # embedding table: vocab rows over model, d_model over the FSDP axis
        "vocab_in": "model" if (msz > 1 and cfg.vocab_size % msz == 0) else None,
        "embed_tbl": fsdp_axis,
        "vocab": "model" if (msz > 1 and cfg.vocab_size % msz == 0) else None,
        "embed": fsdp_axis,
        "embed2": None,
        # attention: TP over heads when divisible, else replicated weights
        "q_heads": "model" if tp_heads else None,
        "kv_heads": "model" if (tp_heads and cfg.num_kv_heads % msz == 0) else None,
        "head_dim": None,
        "q_lora": None,
        "kv_lora": None,
        # dense MLP: megatron column/row split over model
        "mlp": "model" if (msz > 1 and cfg.d_ff % msz == 0) else None,
        "experts_r": None,
    }
    if cfg.moe:
        from repro_torch.models.moe import ep_mode

        if moe_impl == "zero3":
            w_rules.update(experts="model", embed_x="data", expert_mlp=None)
        else:
            mode = ep_mode(cfg, mesh)
            if mode == "2d":
                w_rules.update(experts=("model", "data"), embed_x=None, expert_mlp=None)
            elif mode == "fslice":
                w_rules.update(experts="model", embed_x=None, expert_mlp="data")
            else:
                w_rules.update(experts="model", embed_x=None, expert_mlp=None)

    batch_rule = _batch_rule(mesh, batch)
    a_rules: dict[str, Any] = {
        "batch": batch_rule,
        "seq": None,
        # no TP over heads -> shard the attention inputs over sequence instead
        "attn_seq": None if tp_heads else ("model" if msz > 1 else None),
        "embed_act": None,
        "vocab": w_rules["vocab"],
        "layers": None,
        "kv_heads": w_rules["kv_heads"],
        "head_dim": None,
        "kv_lora": None,
        "rope": None,
        "kv_seq": None,
    }
    if kind == "decode":
        # decode batches are small: the KV-cache sequence axis absorbs the
        # model axis, plus the data axis when the batch can't use it.
        a_rules["kv_seq"] = "model" if batch_rule is not None else ("data", "model")
    elif kind == "prefill":
        a_rules["kv_seq"] = "model" if tp_heads else None
    return DistCtx(
        mesh=mesh, w_rules=w_rules, a_rules=a_rules,
        options={"moe_impl": moe_impl, "kind": kind, "fsdp": bool(fsdp)},
    )


# ---------------------------------------------------------------------------
# GNN / RecSys / search policies
# ---------------------------------------------------------------------------

def gnn_policy(cfg, mesh) -> DistCtx:
    """Full-graph GCN: tiny weights stay replicated; the edge list (the only
    O(E) tensor) shards over every mesh axis."""
    edge_axes = tuple(a for a in ("pod", "data", "model") if _axis(mesh, a) > 1)
    w_rules = {"feat": None, "hidden": None}
    a_rules = {
        "batch": None,
        "edges": edge_axes if len(edge_axes) != 1 else edge_axes[0],
    }
    return DistCtx(mesh=mesh, w_rules=w_rules, a_rules=a_rules)


def search_policy(mesh) -> DistCtx:
    """Sharded vector search (``core/index.ShardedIndex``): the corpus —
    and every per-shard index array stacked on its leading shard axis —
    lives on "data"; query batches are replicated (every shard answers
    every query) and results meet in the running merge."""
    return DistCtx(
        mesh=mesh,
        w_rules={"corpus": "data"},
        a_rules={"batch": None, "corpus": "data"},
    )


def recsys_policy(cfg, mesh, *, batch: int = 1) -> DistCtx:
    """CTR models: the ~38M-row embedding table is row-sharded over every
    axis (dist.embedlookup gathers hit rows); dense tower replicated."""
    all_axes = tuple(a for a in ("pod", "data", "model") if _axis(mesh, a) > 1)
    table_rule = all_axes if len(all_axes) != 1 else (all_axes[0] if all_axes else None)
    w_rules = {
        "table": table_rule,
        "edim": None,
        "hidden": None,  # appears on both dims of MLP weights — keep replicated
        "cin": None,
        "fields": None,
        "heads": None,
        "attn": None,
    }
    a_rules = {
        "batch": _batch_rule(mesh, batch),
        "fields": None,
        "edim": None,
        "cand": table_rule,  # retrieval candidates: sharded like the table
    }
    return DistCtx(mesh=mesh, w_rules=w_rules, a_rules=a_rules)
