"""The port's distribution layer (``dist/sharding.py``, ``launch/mesh.py``)
on the CPU.

The policies are pure functions of a config and a mesh's shape: JAX's and
the port's are held equal on meshes that need no devices (JAX's FakeMesh
way, ``tests/test_dist.py``), a ``PartitionSpec`` read as the tuple of its
entries.  The mesh, ``local_blocks`` and the collectives inside
``shard_map`` are held to numpy; a rank's failure must surface as its own
exception within a timeout, never hang; two runs are bit-equal.
"""
import itertools
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

LM_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.family(a) == "lm"]
RECSYS_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.family(a) == "recsys"]
MOE_ARCHS = [a for a in LM_ARCHS if tconfigs.get(a).moe]
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "3x4": ((3, 4), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
}
KINDS = ["train", "prefill", "decode"]
BATCHES = [1, 4, 128, 256]
TIMEOUT_S = 60


class FakeMesh:
    def __init__(self, name):
        shape, axes = MESHES[name]
        self.shape = dict(zip(axes, shape))


def _jspec_tree(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


def _tspec_tree(tree):
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tspec_tree(v) for k, v in tree.items()}
    return [_tspec_tree(v) for v in tree]


def _same_ctx(t, j):
    assert t.w_rules == j.w_rules
    assert t.a_rules == j.a_rules
    assert t.options == j.options
    assert t.batch_axes == j.batch_axes


# ---------------------------------------------------------------- policies

@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_policy_matches_jax(arch, mesh, kind, batch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    j = jsharding.lm_policy(jcfg, FakeMesh(mesh), kind=kind, batch=batch)
    t = sharding.lm_policy(tcfg, FakeMesh(mesh), kind=kind, batch=batch)
    _same_ctx(t, j)
    assert _tspec_tree(t.shard_w(ttf.lm_decls(tcfg))) == _jspec_tree(
        j.shard_w(jtf.lm_decls(jcfg)))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", ["16x16", "2x4"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_policy_zero3_and_fsdp_match_jax(arch, mesh, fsdp):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    j = jsharding.lm_policy(jcfg, FakeMesh(mesh), batch=4, fsdp=fsdp, moe_impl="zero3")
    t = sharding.lm_policy(tcfg, FakeMesh(mesh), batch=4, fsdp=fsdp, moe_impl="zero3")
    _same_ctx(t, j)
    assert _tspec_tree(t.shard_w(ttf.lm_decls(tcfg))) == _jspec_tree(
        j.shard_w(jtf.lm_decls(jcfg)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gnn_and_search_policies_match_jax(mesh):
    cfg = "gcn-cora"
    _same_ctx(sharding.gnn_policy(tconfigs.get(cfg), FakeMesh(mesh)),
              jsharding.gnn_policy(jconfigs.get(cfg), FakeMesh(mesh)))
    _same_ctx(sharding.search_policy(FakeMesh(mesh)), jsharding.search_policy(FakeMesh(mesh)))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_policy_matches_jax(arch, mesh, batch):
    _same_ctx(sharding.recsys_policy(tconfigs.get(arch), FakeMesh(mesh), batch=batch),
              jsharding.recsys_policy(jconfigs.get(arch), FakeMesh(mesh), batch=batch))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_mode_and_expert_specs_match_jax(arch, mesh, reduced):
    get_t = tconfigs.get_reduced if reduced else tconfigs.get
    get_j = jconfigs.get_reduced if reduced else jconfigs.get
    tcfg, jcfg = get_t(arch), get_j(arch)
    assert tmoe.ep_mode(tcfg, FakeMesh(mesh)) == jmoe.ep_mode(jcfg, FakeMesh(mesh))
    tmode, tspecs = tmoe.expert_weight_specs(tcfg, FakeMesh(mesh))
    jmode, jspecs = jmoe.expert_weight_specs(jcfg, FakeMesh(mesh))
    assert tmode == jmode
    assert _tspec_tree(tspecs) == _jspec_tree(jspecs)


def test_ep_modes_at_published_widths():
    """JAX's own cases (``tests/test_dist.py``) and the smoke's meshes."""
    cases = {("deepseek-v3-671b", "16x16"): "2d", ("qwen3-moe-235b-a22b", "16x16"): "fslice",
             ("deepseek-v3-671b", "2x4"): "2d", ("deepseek-v3-671b", "3x4"): "model",
             ("qwen3-moe-235b-a22b", "3x4"): "fslice"}
    for (arch, mesh), mode in cases.items():
        assert tmoe.ep_mode(tconfigs.get(arch), FakeMesh(mesh)) == mode, (arch, mesh)


def test_partition_spec_reads_as_jax():
    for parts in [(None, "a", ("b", "c")), (("a",), None), (), ("a",)]:
        assert tuple(P(*parts)) == tuple(JP(*parts))


# ---------------------------------------------------------------- the meshes

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_as_jax(multi_pod):
    with pytest.raises(RuntimeError) as jerr:
        jmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError) as terr:
        tmesh.make_production_mesh(multi_pod=multi_pod)
    head = lambda e: str(e.value).split(", have")[0]  # noqa: E731
    assert head(terr) == head(jerr)
    assert "forces 512 host devices" in str(terr.value)


def test_test_mesh_holds_every_rank_on_one_device():
    mesh = tmesh.make_test_mesh((2, 3, 4), ("pod", "data", "model"), device="cpu")
    assert list(mesh.shape.items()) == [("pod", 2), ("data", 3), ("model", 4)]
    assert mesh.axis_names == ("pod", "data", "model") and mesh.size == 24
    assert mesh.device == torch.device("cpu")
    coords = [tuple(mesh.coords(r).values()) for r in range(mesh.size)]
    assert coords == list(itertools.product(range(2), range(3), range(4)))
    with pytest.raises(ValueError):
        sharding.Mesh((2, 2), ("data", "data"), "cpu")


@pytest.mark.parametrize("spec", [P(("model", "data")), P("model", None, "data"),
                                  P(None, "data"), P("data", "model"), P(),
                                  P(("data", "model"), None, None)])
def test_local_blocks_are_contiguous_views(spec):
    """Rank (i, j) of a (2, 4) mesh takes block i of a split over data, j
    over model, i * 4 + j over (data, model) and j * 2 + i over (model,
    data): the first name major, as JAX's tuple entries."""
    mesh = tmesh.make_test_mesh((2, 4), device="cpu")
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    blocks = sharding.local_blocks(x, spec, mesh)
    xn = x.numpy()
    for r, b in enumerate(blocks):
        c = mesh.coords(r)
        want = xn
        for dim, entry in enumerate(spec):
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            if not names:
                continue
            parts, idx = 1, 0
            for n in names:
                parts *= mesh.shape[n]
                idx = idx * mesh.shape[n] + c[n]
            size = want.shape[dim] // parts
            want = np.take(want, range(idx * size, (idx + 1) * size), axis=dim)
        np.testing.assert_array_equal(b.numpy(), want)
        assert b.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # a view
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_blocks(torch.zeros(3, 4), P("model"), mesh)
    with pytest.raises(ValueError, match="not an axis"):
        sharding.local_blocks(x, P("pod"), mesh)


# ---------------------------------------------------------------- collectives

def _mesh(shape=(2, 3), axes=("data", "model")):
    return tmesh.make_test_mesh(shape, axes, device="cpu")


def _per_rank(mesh):
    """The spec that gives rank r row r of a (size, ...) input."""
    return P(tuple(mesh.axis_names))


def test_axis_index_matches_the_coordinates():
    mesh = _mesh()

    def f(_):
        return torch.tensor([[sharding.axis_index("data"), sharding.axis_index("model")]])

    spec = _per_rank(mesh)
    out = sharding.shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec)(
        torch.zeros(mesh.size, 1))
    want = [[c["data"], c["model"]] for c in map(mesh.coords, range(mesh.size))]
    assert out.tolist() == want


@pytest.mark.parametrize("names", ["data", "model", ("data", "model"), ("model", "data")])
def test_all_gather_and_psum_match_numpy(names):
    mesh = _mesh()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(mesh.size, 4, 5)).astype(np.float32)
    spec = _per_rank(mesh)
    names_t = names if isinstance(names, tuple) else (names,)

    def f(xl):
        return (sharding.all_gather(xl, names, axis=1, tiled=True),
                sharding.all_gather(xl[0], names, axis=0, tiled=False),
                sharding.psum(xl, names))

    gat, stk, tot = sharding.shard_map(f, mesh=mesh, in_specs=(spec,),
                                       out_specs=(spec, spec, spec))(torch.as_tensor(x))
    coords = [mesh.coords(r) for r in range(mesh.size)]
    for r, c in enumerate(coords):
        group = [q for q, cq in enumerate(coords)
                 if all(cq[a] == c[a] for a in mesh.axis_names if a not in names_t)]
        order = sorted(group, key=lambda q: [coords[q][n] for n in names_t])
        n = len(order)
        np.testing.assert_array_equal(gat[r].numpy(), np.concatenate([x[q] for q in order], 0))
        np.testing.assert_array_equal(stk[r * n:(r + 1) * n].numpy(),
                                      np.stack([x[q] for q in order]))
        acc = x[group[0]].copy()
        for q in group[1:]:
            acc += x[q]  # rank order, as the port adds
        np.testing.assert_array_equal(tot[r].numpy(), acc)


def test_outputs_take_rank_zero_along_unnamed_axes():
    mesh = _mesh()

    def f(xl):
        return xl + 100 * sharding.axis_index("model")

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = sharding.shard_map(f, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))(x)
    assert torch.equal(out, x)  # model index 0 of each data block
    rep = sharding.shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P())(x)
    assert torch.equal(rep, x)


def test_shard_map_refuses_grad_and_wrong_arity():
    """Gradients now flow through ``shard_map`` (an identity map hands
    back the cotangent); the wrong arity and a collective outside a rank
    are still refused."""
    mesh = _mesh()
    fn = sharding.shard_map(lambda x: x, mesh=mesh, in_specs=(P(),), out_specs=P())
    w = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad((fn(w) * torch.arange(3.0)).sum(), [w])
    assert torch.equal(g, torch.arange(3.0))
    with torch.no_grad():
        assert torch.equal(fn(w), w.detach())
    with pytest.raises(TypeError):
        fn(w, w)
    with pytest.raises(RuntimeError, match="inside a shard_map"):
        sharding.psum(w, "data")


def _bounded(fn):
    """Run ``fn`` in a thread joined with a timeout: returns its exception
    (None when it returned); a hang fails the test."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), "shard_map hung"
    return box.get("error")


class RankError(ValueError):
    pass


@pytest.mark.parametrize("where", ["before", "between", "last"])
def test_a_failing_rank_surfaces_its_exception(where):
    mesh = _mesh((2, 4))
    bad = {"before": 3, "between": 5, "last": 7}[where]

    def f(xl):
        r = sharding.axis_index("data") * 4 + sharding.axis_index("model")
        if where == "before" and r == bad:
            raise RankError(r)
        y = sharding.psum(xl, "model")
        if where != "before" and r == bad:
            raise RankError(r)
        return sharding.psum(y, "data")

    fn = sharding.shard_map(f, mesh=mesh, in_specs=(P(("data", "model")),),
                            out_specs=P(("data", "model")))
    err = _bounded(lambda: fn(torch.ones(8, 2)))
    assert isinstance(err, RankError) and err.args == (bad,)
    assert threading.active_count() < 50  # every rank thread has ended


@pytest.mark.parametrize("fault", ["other collective", "returns early"])
def test_ranks_that_disagree_raise(fault):
    mesh = _mesh((2, 2))

    def f(xl):
        odd = sharding.axis_index("model") == 1
        if fault == "returns early" and odd:
            return xl
        if fault == "other collective" and odd:
            return sharding.all_gather(xl, "data")
        return sharding.psum(xl, "data")

    fn = sharding.shard_map(f, mesh=mesh, in_specs=(P(("data", "model")),),
                            out_specs=P(("data", "model")))
    err = _bounded(lambda: fn(torch.ones(4, 2)))
    assert isinstance(err, RuntimeError) and "different collectives" in str(err)


def test_two_runs_are_bit_equal():
    import dataclasses

    mesh = _mesh((2, 4))
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen3-moe-235b-a22b"), capacity_factor=1.25)
    g = torch.Generator().manual_seed(0)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {k: torch.randn(shape, generator=g) * 0.05
         for k, shape in (("wg", (E, d, f)), ("wu", (E, d, f)), ("wd", (E, f, d)))}
    x = torch.randn(4, 16, d, generator=g)
    probs = torch.softmax(torch.randn(4, 16, E, generator=g), -1)
    runs = [tmoe.moe_ffn_ep(x, probs, p, cfg, mesh=mesh, batch_axes=("data",))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    xs = torch.randn(8, 1000, generator=g)
    fn = sharding.shard_map(lambda xl: sharding.psum(xl, ("data", "model")), mesh=mesh,
                            in_specs=(P(("data", "model")),), out_specs=P(("data", "model")))
    assert torch.equal(fn(xs), fn(xs))


def test_many_ranks_under_fast_thread_switching():
    """32 ranks, more than the cores, 40 rounds of psum and all_gather
    with the interpreter switching threads every microsecond: every round
    must see every rank's operand exactly once."""
    mesh = _mesh((4, 8))
    rounds = 40

    def f(xl):
        acc = xl
        for _ in range(rounds):
            acc = sharding.psum(acc, "model") / 8 + sharding.all_gather(acc, "data")[:1]
        return acc

    x = torch.arange(32, dtype=torch.float64).reshape(32, 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        box = {}
        err = _bounded(lambda: box.setdefault("out", sharding.shard_map(
            f, mesh=mesh, in_specs=(P(("data", "model")),),
            out_specs=P(("data", "model")))(x)))
    finally:
        sys.setswitchinterval(old)
    assert err is None
    want = x.numpy().reshape(4, 8, 1)
    for _ in range(rounds):
        want = want.mean(1, keepdims=True).repeat(8, 1) + want[:1]
    np.testing.assert_allclose(box["out"].numpy().reshape(4, 8, 1), want, rtol=1e-12)


@pytest.mark.parametrize("family", ["recsys", "gnn"])
def test_steps_under_their_policies_change_nothing(family):
    """The recsys serve, retrieval and train steps under ``recsys_policy``
    and the GCN's under ``gnn_policy`` on a (2, 4) mesh: ``act`` moves
    nothing, so each answer equals the step's without a context."""
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models import gnn, recsys
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as steps

    mesh = tmesh.make_test_mesh((2, 4), device="cpu")
    g = torch.Generator().manual_seed(0)
    if family == "recsys":
        cfg = tconfigs.get_reduced("deepfm")
        model = recsys.RecsysModel.build(cfg, device="cpu", generator=g)
        raw = recsys_batch(0, 8, cfg.vocabs)
        batch = {"ids": torch.as_tensor(raw["ids"]), "labels": torch.as_tensor(raw["labels"])}
        ctx = sharding.recsys_policy(cfg, mesh, batch=8)
        cand = torch.randn(50, cfg.embed_dim, generator=g)
        runs = [(steps.make_serve_step(cfg, family, c)(model, batch),
                 steps.make_retrieval_step(cfg, c, k=5)(model, {**batch, "candidates": cand}))
                for c in (None, ctx)]
    else:
        cfg = tconfigs.get_reduced("gcn-cora")
        model = gnn.GCNModel.build(cfg, 6, device="cpu", generator=g)
        batch = {"x": torch.randn(20, 6, generator=g),
                 "edges": torch.randint(0, 20, (2, 60), generator=g),
                 "labels": torch.randint(0, cfg.num_classes, (20,), generator=g)}
        ctx = sharding.gnn_policy(cfg, mesh)
        runs = [(steps.make_serve_step(cfg, family, c)(model, batch),) for c in (None, ctx)]
    for a, b in zip(*runs):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    opt = opt_lib.adamw(1e-3)
    params = model.tree()
    losses = [float(steps.make_train_step(cfg, family, opt, c)(
        params, opt.init(params), batch)[2]["loss"]) for c in (None, ctx)]
    assert losses[0] == losses[1]
