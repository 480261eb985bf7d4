"""Port parity: the recsys serving slice (``repro_torch.configs``,
``data/tokens``, ``models/params``, ``models/recsys``,
``train/train_step``, ``convert.recsys_params_from_jax``) against the JAX
package, on the CPU at the ``REDUCED`` configs.

Weights are JAX's ``init_params`` (and, to give the interactions O(1)
inputs, the same tree with unit-normal tables) loaded through
``convert.recsys_params_from_jax``.  Tolerance: rtol 1e-5 / atol 1e-5 on
logits, probabilities, losses and user embeddings for every arch — the two
frameworks sum the same f32 products in other orders (AutoInt's softmax
included).  Retrieval ids must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data.tokens import recsys_batch as jrecsys_batch  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train.train_step import make_retrieval_step as jmake_retrieval_step  # noqa: E402
from repro.train.train_step import make_serve_step as jmake_serve_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data.tokens import recsys_batch  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train.train_step import make_retrieval_step, make_serve_step  # noqa: E402

ARCHS = ["fm", "deepfm", "xdeepfm", "autoint"]
RTOL = ATOL = 1e-5


def _jax_leaves(decls, path=""):
    """(dotted path, Param) in the order of ``models.params.leaves``."""
    if isinstance(decls, jparams.Param):
        return [(path, decls)]
    if isinstance(decls, dict):
        return [leaf for key in sorted(decls)
                for leaf in _jax_leaves(decls[key], f"{path}.{key}" if path else key)]
    return [leaf for i, child in enumerate(decls)
            for leaf in _jax_leaves(child, f"{path}.{i}")]


def _setup(arch, unit_tables=False, seed=0):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    params = jparams.init_params(jax.random.PRNGKey(seed), jrecsys.recsys_decls(jcfg))
    if unit_tables:
        rng = np.random.default_rng(seed)
        for name in ("table", "linear"):
            params[name] = jnp.asarray(
                rng.normal(size=params[name].shape).astype(np.float32))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = convert.recsys_params_from_jax(params_np, tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_package(arch):
    for getter in ("get", "get_reduced"):
        jcfg = getattr(jconfigs, getter)(arch)
        tcfg = getattr(tconfigs, getter)(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.total_vocab == jcfg.total_vocab
    assert tconfigs.family(arch) == jconfigs.family(arch) == "recsys"


def test_shapes_and_vocabularies_equal_the_jax_package():
    assert [dataclasses.asdict(s) for s in tbase.RECSYS_SHAPES] == [
        dataclasses.asdict(s) for s in jbase.RECSYS_SHAPES]
    assert tbase.RECSYS_VOCABS == jbase.RECSYS_VOCABS
    full = tconfigs.get("deepfm")
    assert full.total_vocab == 30_226_200  # the port's comment states it
    assert trecsys._padded_vocab(full) == jrecsys._padded_vocab(full) == 30_226_432


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_decls_names_shapes_and_counts(arch, reduced):
    getter = "get_reduced" if reduced else "get"
    jcfg, tcfg = getattr(jconfigs, getter)(arch), getattr(tconfigs, getter)(arch)
    jdecls, tdecls = jrecsys.recsys_decls(jcfg), trecsys.recsys_decls(tcfg)
    jl, tl = _jax_leaves(jdecls), tparams.leaves(tdecls)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (_, t), (_, j) in zip(tl, jl):
        assert (t.shape, t.logical, t.init, t.scale) == (j.shape, j.logical, j.init, j.scale)
    assert tparams.param_count(tdecls) == jparams.param_count(jdecls)
    assert tparams.param_bytes(tdecls) == jparams.param_bytes(jdecls)
    np.testing.assert_array_equal(trecsys.field_offsets(tcfg).numpy(),
                                  np.asarray(jrecsys.field_offsets(jcfg)))


@pytest.mark.parametrize("case", [(0, 64, 0, 0, 1), (3, 64, 7, 0, 1), (2, 64, 1, 1, 2)])
def test_recsys_batch_identical_arrays(case):
    step, batch, seed, host, hosts = case
    vocabs = jconfigs.get_reduced("deepfm").vocabs
    t = recsys_batch(step, batch, vocabs, seed=seed, host_id=host, num_hosts=hosts)
    j = jrecsys_batch(step, batch, vocabs, seed=seed, host_id=host, num_hosts=hosts)
    assert t.keys() == j.keys()
    for key in t:
        assert t[key].dtype == j[key].dtype
        np.testing.assert_array_equal(t[key], j[key])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("unit_tables", [False, True])
def test_forward_loss_serve_and_user_embedding_match_jax(arch, unit_tables):
    jcfg, params, tcfg, model = _setup(arch, unit_tables)
    batch = recsys_batch(0, 48, jcfg.vocabs[: jcfg.n_sparse], seed=2)
    ids, tids = jnp.asarray(batch["ids"]), torch.as_tensor(batch["ids"])
    tbatch = {"ids": tids, "labels": torch.as_tensor(batch["labels"])}
    jbatch = {"ids": ids, "labels": jnp.asarray(batch["labels"])}

    logits = trecsys.recsys_forward(model, tids, tcfg)
    assert logits.shape == (48,) and logits.dtype == torch.float32
    _close(logits, jrecsys.recsys_forward(params, ids, jcfg))
    _close(model(tids), jrecsys.recsys_forward(params, ids, jcfg))

    loss, metrics = trecsys.recsys_loss(model, tbatch, tcfg)
    jloss, jmetrics = jrecsys.recsys_loss(params, jbatch, jcfg)
    _close(loss, jloss)
    assert float(metrics["acc"]) == pytest.approx(float(jmetrics["acc"]), abs=1e-7)

    probs = make_serve_step(tcfg, "recsys")(model, {"ids": tids})
    _close(probs, jmake_serve_step(jcfg, "recsys")(params, {"ids": ids}))

    user = trecsys.user_embedding(model, tids, tcfg)
    assert user.shape == (48, tcfg.embed_dim)
    _close(user, jrecsys.user_embedding(params, ids, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_tree_and_module_give_the_same_logits(arch):
    _, _, tcfg, model = _setup(arch)
    tree = tparams.map_decls(
        lambda path, _: model.get_parameter(path), trecsys.recsys_decls(tcfg))
    ids = torch.as_tensor(recsys_batch(1, 16, tcfg.vocabs, seed=0)["ids"])
    assert torch.equal(trecsys.recsys_forward(tree, ids, tcfg),
                       trecsys.recsys_forward(model, ids, tcfg))


def _retrieval_inputs(dim, n=300, dup=False, seed=0):
    rng = np.random.default_rng(seed)
    cand = rng.normal(size=(n, dim)).astype(np.float32)
    if dup:
        # every row three times over: each score ties with two others
        cand = np.concatenate([cand[: n // 3]] * 3)
    return cand


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dup", [False, True])
def test_retrieval_ids_identical_to_jax(arch, dup):
    jcfg, params, tcfg, model = _setup(arch, unit_tables=True)
    ids = recsys_batch(4, 5, jcfg.vocabs[: jcfg.n_sparse], seed=3)["ids"]
    cand = _retrieval_inputs(jcfg.embed_dim, dup=dup)
    ts, ti = make_retrieval_step(tcfg, k=40)(
        model, {"ids": torch.as_tensor(ids), "candidates": torch.as_tensor(cand)})
    js, ji = jmake_retrieval_step(jcfg, k=40)(
        params, {"ids": jnp.asarray(ids), "candidates": jnp.asarray(cand)})
    assert ti.dtype == torch.int32 and ti.shape == (5, 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts, js)
    if dup:
        # ties go to the lowest index: each triple appears in index order
        row = ti[0].tolist()
        for a, b in zip(row[0::3], row[1::3]):
            assert b == a + 100


def test_retrieval_score_breaks_exact_ties_like_lax_top_k():
    user = torch.tensor([[1.0, 0.0]])
    cand = torch.tensor([[1.0, 5.0], [2.0, 0.0], [1.0, -3.0], [2.0, 1.0], [0.0, 0.0]])
    s, i = trecsys.retrieval_score(user, cand, k=4)
    js, ji = jax.lax.top_k(jnp.asarray([[1.0, 2.0, 1.0, 2.0, 0.0]]), 4)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 3, 0, 2]]
    assert s.tolist() == np.asarray(js).tolist()


def test_init_params_follows_the_declarations():
    cfg = tconfigs.get_reduced("xdeepfm")
    decls = trecsys.recsys_decls(cfg)
    make = lambda seed: tparams.init_params(  # noqa: E731
        decls, generator=torch.Generator().manual_seed(seed), device=torch.device("cpu"))
    a, b, c = make(0), make(0), make(1)
    for path, p in tparams.leaves(decls):
        ta, tb, tc = (_at(tree, path) for tree in (a, b, c))
        assert tuple(ta.shape) == p.shape and ta.dtype == torch.float32
        assert torch.equal(ta, tb)
        if p.init == "zeros":
            assert not ta.any()
        else:
            assert not torch.equal(ta, tc)
    # the table's declared scale (0.01) and the MLP's 1/sqrt(fan-in)
    assert float(a["table"].std()) == pytest.approx(0.01, rel=0.1)
    w0 = a["mlp"][0]["w"]
    assert float(w0.std()) == pytest.approx(1 / np.sqrt(w0.shape[0]), rel=0.2)


def _at(tree, path):
    node = tree
    for key in path.split("."):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


@pytest.mark.parametrize("arch", ARCHS)
def test_model_build_names_its_parameters_as_declared(arch):
    cfg = tconfigs.get_reduced(arch)
    model = trecsys.RecsysModel.build(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(5))
    again = trecsys.RecsysModel.build(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(trecsys.RecsysModel.build(cfg, device="cpu").table,
                       trecsys.RecsysModel.build(cfg, device="cpu").table)
    names = [path for path, _ in tparams.leaves(trecsys.recsys_decls(cfg))]
    assert sorted(dict(model.named_parameters())) == sorted(names)
    for name, p in model.named_parameters():
        assert torch.equal(p, again.get_parameter(name))
    ids = torch.as_tensor(recsys_batch(0, 8, cfg.vocabs, seed=0)["ids"])
    assert torch.isfinite(model(ids)).all()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_reduced("fm")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trecsys.RecsysModel.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.recsys_params_from_jax({}, cfg)
    with pytest.raises(KeyError):
        make_serve_step(cfg, "lm")
