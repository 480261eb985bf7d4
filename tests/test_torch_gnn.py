"""Port parity: the GNN (``models/gnn``, ``models/sampler``, the ``gnn``
family of ``make_train_step`` / ``make_serve_step``, ``convert.
gcn_params_from_jax`` and ``launch.train --arch gcn-cora``) against the JAX
package, on the CPU.

The same numpy inputs go to both: JAX's ``init_params`` weights converted
for the port, random graphs from numpy.  Tolerances, each with its reason:

* ``gcn_conv``, forward, loss and accuracy: rtol 1e-5 / atol 1e-6 (the same
  f32 products; ``index_add`` and ``segment_sum`` add a node's messages in
  another order);
* 3 AdamW steps, plain and int8: per-step loss rtol 1e-5 and every
  parameter and moment rtol 1e-5 / atol 1e-6, as the recsys train steps
  (tests/test_torch_train.py);
* the sampler and the CSR graph: equal, array for array (numpy in both).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import sampler as jsampler  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import sampler as tsampler  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402
from repro_torch.train import tree as tree_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
N, D, E = 200, 16, 800


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(port, ref, rtol=RTOL, atol=ATOL):
    p, r = tree_lib.paths(port), jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in p] == ["/".join(str(x) for x in path) for path, _ in r]
    for (key, a), (_, b) in zip(p, r):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=key)


def _graph(seed, n=N, d=D, e=E, pad=0, classes=7):
    """x (n, d), edges (2, e + pad) with ``pad`` -1 columns, labels, and a
    label mask over about half the nodes."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, d)).astype(np.float32)
    edges = np.concatenate([g.integers(0, n, size=(2, e)),
                            np.full((2, pad), -1)], axis=1).astype(np.int32)
    labels = g.integers(0, classes, size=n).astype(np.int32)
    mask = (g.random(n) < 0.5).astype(np.float32)
    return {"x": x, "edges": edges, "labels": labels, "label_mask": mask}


def _setup(reduced, d=D, seed=0):
    jcfg = jconfigs.get_reduced("gcn-cora") if reduced else jconfigs.get("gcn-cora")
    tcfg = tconfigs.get_reduced("gcn-cora") if reduced else tconfigs.get("gcn-cora")
    jp = jparams.init_params(jax.random.PRNGKey(seed), jgnn.gcn_decls(jcfg, d))
    model = convert.gcn_params_from_jax(_np_tree(jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, model


@pytest.mark.parametrize("norm,aggregator", [("sym", "mean"), ("none", "mean"),
                                             ("none", "sum")])
def test_gcn_conv_with_padded_edges(norm, aggregator):
    """-1 padding columns are masked out of the degrees and the messages
    (the sampler's static shapes), as in JAX."""
    _, jp, _, model = _setup(True)
    b = _graph(1, pad=37)
    w, bias = jp["layers"][0]["w"], jp["layers"][0]["b"]
    ref = jgnn.gcn_conv(jnp.asarray(b["x"]), jnp.asarray(b["edges"]), w, bias,
                        n_nodes=N, norm=norm, aggregator=aggregator)
    with torch.no_grad():
        out = tgnn.gcn_conv(torch.as_tensor(b["x"]), torch.as_tensor(b["edges"]),
                            model["layers"][0]["w"], model["layers"][0]["b"],
                            n_nodes=N, norm=norm, aggregator=aggregator)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    unpadded = _graph(1)
    with torch.no_grad():
        again = tgnn.gcn_conv(torch.as_tensor(unpadded["x"]),
                              torch.as_tensor(unpadded["edges"]),
                              model["layers"][0]["w"], model["layers"][0]["b"],
                              n_nodes=N, norm=norm, aggregator=aggregator)
    assert torch.equal(out, again)


def test_gcn_matches_dense_adjacency():
    """The twin of tests/test_models.py's: index_add message passing equals
    the dense normalised adjacency product."""
    cfg = tconfigs.get_reduced("gcn-cora")
    n, d, e = 30, 12, 90
    rng = np.random.default_rng(0)
    edges = rng.integers(0, n, size=(2, e)).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    p = tparams.init_params(tgnn.gcn_decls(cfg, d),
                            generator=torch.Generator().manual_seed(0), device="cpu")
    w, b = p["layers"][0]["w"], p["layers"][0]["b"]
    out = tgnn.gcn_conv(torch.as_tensor(x), torch.as_tensor(edges), w, b, n_nodes=n)
    deg = np.maximum(np.bincount(edges[1], minlength=n), 1.0)
    A = np.zeros((n, n), np.float32)
    for s, t in edges.T:
        A[t, s] += 1.0 / np.sqrt(deg[s] * deg[t])
    ref = A @ (x @ w.numpy() + b.numpy())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reduced", [True, False], ids=["REDUCED", "CONFIG"])
@pytest.mark.parametrize("masked", [False, True])
def test_gcn_forward_loss_and_acc_match_jax(reduced, masked):
    jcfg, jp, tcfg, model = _setup(reduced)
    b = _graph(2, pad=11, classes=jcfg.num_classes)
    if not masked:
        del b["label_mask"]
    ref = jgnn.gcn_forward(jp, jnp.asarray(b["x"]), jnp.asarray(b["edges"]), jcfg)
    jloss, jm = jgnn.gcn_loss(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    with torch.no_grad():
        out = model(torch.as_tensor(b["x"]), torch.as_tensor(b["edges"]))
        tloss, tm = tgnn.gcn_loss(model, {k: torch.as_tensor(v) for k, v in b.items()},
                                  tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert float(tloss) == pytest.approx(float(jloss), rel=RTOL)
    assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-7)
    serve = tsteps.make_serve_step(tcfg, "gnn")(model, {k: torch.as_tensor(v)
                                                       for k, v in b.items()})
    assert torch.equal(serve, out)


def test_dropout_runs_only_with_a_generator():
    _, _, tcfg, model = _setup(False)
    b = {k: torch.as_tensor(v) for k, v in _graph(3).items()}
    with torch.no_grad():
        plain = tgnn.gcn_forward(model, b["x"], b["edges"], tcfg)
        no_gen = tgnn.gcn_forward(model, b["x"], b["edges"], tcfg, train=True)
        one = tgnn.gcn_forward(model, b["x"], b["edges"], tcfg, train=True,
                               generator=torch.Generator().manual_seed(5))
        two = tgnn.gcn_forward(model, b["x"], b["edges"], tcfg, train=True,
                               generator=torch.Generator().manual_seed(5))
    assert torch.equal(plain, no_gen)
    assert torch.equal(one, two) and not torch.equal(one, plain)
    loss, _ = tgnn.gcn_loss(model, b, tcfg, generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("reduced", [True, False], ids=["REDUCED", "CONFIG"])
@pytest.mark.parametrize("mode", ["plain", "int8"])
def test_train_step_matches_jax(reduced, mode):
    """3 AdamW(1e-2) steps of ``make_train_step(cfg, "gnn")`` from the same
    converted weights and state as JAX's jitted step, on one graph with a
    label mask and padded edges."""
    kw = {"grad_compression": "int8"} if mode == "int8" else {}
    jcfg, jp, tcfg, model = _setup(reduced)
    tp = model.tree()
    jo, to = jopt.adamw(1e-2), topt.adamw(1e-2)
    js = jo.init(jp)
    ts = convert.opt_state_from_jax(_np_tree(js), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, "gnn", jo, **kw))
    tstep = tsteps.make_train_step(tcfg, "gnn", to, **kw)
    b = _graph(4, pad=9, classes=jcfg.num_classes)
    for _ in range(STEPS):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-7)
    assert ts.step == int(js.step) == STEPS
    _assert_trees((tp, ts), (jp, js))


def test_gcn_model_names_and_build():
    cfg = tconfigs.get("gcn-cora")
    model = tgnn.GCNModel.build(cfg, 1433, device="cpu")
    names = [path for path, _ in tparams.leaves(tgnn.gcn_decls(cfg, 1433))]
    assert sorted(dict(model.named_parameters())) == sorted(names)
    again = tgnn.GCNModel.build(cfg, 1433, device="cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p, again.get_parameter(name))
    with pytest.raises(ValueError, match="layers.0.w"):
        convert.gcn_params_from_jax(
            {"layers": [{"w": np.zeros((3, 5)), "b": np.zeros(16)},
                        {"w": np.zeros((16, 7)), "b": np.zeros(7)}]}, cfg, device="cpu")


@pytest.mark.parametrize("n,deg,seed", [(50, 3, 0), (300, 7, 4), (1000, 12, 9)])
def test_random_graph_and_csr_match_jax(n, deg, seed):
    jg, tg = jsampler.random_graph(n, deg, seed=seed), tsampler.random_graph(n, deg, seed=seed)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.indices.dtype == jg.indices.dtype and tg.num_nodes == jg.num_nodes == n
    for v in (0, n // 2, n - 1):
        np.testing.assert_array_equal(tg.neighbors(v), jg.neighbors(v))


@pytest.mark.parametrize("seeds,fanout", [(16, (5, 3)), (40, (15, 10)), (7, (2,))])
def test_sample_subgraph_matches_jax(seeds, fanout):
    """The same graph, seeds and rng draw the same padded subgraph."""
    graph = tsampler.random_graph(500, 6, seed=1)
    chosen = np.random.default_rng(2).choice(500, size=seeds, replace=False)
    jout = jsampler.sample_subgraph(jsampler.random_graph(500, 6, seed=1), chosen, fanout,
                                    rng=np.random.default_rng(3))
    tout = tsampler.sample_subgraph(graph, chosen, fanout, rng=np.random.default_rng(3))
    assert sorted(tout) == sorted(jout)
    for key, value in jout.items():
        np.testing.assert_array_equal(np.asarray(tout[key]), np.asarray(value), err_msg=key)
        assert np.asarray(tout[key]).dtype == np.asarray(value).dtype
    edges = tout["edges"]
    assert ((edges >= -1) & (edges < tout["num_nodes"])).all()


def test_sampled_subgraph_forward_matches_jax():
    """A sampled subgraph (-1 padded to the fanout tree's static sizes)
    through both packages' forward and masked loss."""
    jcfg, jp, tcfg, model = _setup(False, d=12)
    graph = tsampler.random_graph(400, 5, seed=6)
    seeds = np.arange(0, 400, 25)
    sub = tsampler.sample_subgraph(graph, seeds, (4, 3), rng=np.random.default_rng(7))
    feats = np.random.default_rng(8).normal(size=(400, 12)).astype(np.float32)
    mask = np.zeros(sub["num_nodes"], np.float32)
    mask[sub["seed_local"]] = 1.0
    b = {"x": feats[sub["node_index"]], "edges": sub["edges"],
         "labels": np.random.default_rng(9).integers(0, 7, sub["num_nodes"]).astype(np.int32),
         "label_mask": mask}
    jloss, _ = jgnn.gcn_loss(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    with torch.no_grad():
        tloss, _ = tgnn.gcn_loss(model, {k: torch.as_tensor(v) for k, v in b.items()}, tcfg)
    assert float(tloss) == pytest.approx(float(jloss), rel=RTOL)


def test_launcher_build_gcn_matches_the_jax_loop():
    """``build("gcn-cora")``: JAX's tree structure and fixed graph, and a
    step that learns."""
    jparams_, jstate, _, jb = jtrain.build("gcn-cora")
    tparams_, tstate, step, tb = ttrain.build("gcn-cora", device="cpu")
    want = ["/".join(str(k) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path((jparams_, jstate))[0]]
    assert [k for k, _ in tree_lib.paths((tparams_, tstate))] == want
    for key in ("x", "edges", "labels"):
        np.testing.assert_array_equal(tb(3)[key].numpy(), np.asarray(jb(3)[key]))
    losses = []
    for t in range(20):
        tparams_, tstate, m = step(tparams_, tstate, tb(t))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_launcher_cli_trains_gcn_and_checkpoints(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    ck = str(tmp_path / "ck")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "gcn-cora", "--device", "cpu", "--steps", "5", "--ckpt-every",
                          "2", "--ckpt-dir", ck], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("step 0: loss=") and lines[-2].startswith("step 4: loss=")
    assert lines[-1] == "done"
    assert sorted(os.listdir(ck)) == ["LATEST", "step_00000002", "step_00000004"]
