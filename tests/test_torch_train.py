"""Port parity: recsys training (``train/optimizer``, ``dist/compression``,
``train/train_step.make_train_step``, ``convert.opt_state_from_jax`` /
``opt_state_to_jax``, the chunked CIN of the serve step and the launcher
``repro_torch.launch.train``, whose default arch is an LM's) against the
JAX package, on the CPU at the ``REDUCED`` configs.

The same numpy inputs go to both: JAX's ``init_params`` weights and
optimizer state converted for the port, ``recsys_batch`` batches, numpy
gradients for the optimizers.  Tolerances, each with its reason:

* optimizers and schedules: rtol 1e-5 / atol 1e-6 on parameters and state
  after 3 updates (the same f32 formulas; reductions in another order);
* train steps, plain, ``microbatches=2`` and ``grad_compression="int8"``:
  per-step loss rtol 1e-5 and every parameter and moment after 3 AdamW
  steps rtol 1e-5 / atol 1e-6 (the losses' sums and the dense table
  gradients are summed in another order; Adam's m / sqrt(v) is near +-1
  wherever a gradient is, so a last ulp of g moves the update by about an
  ulp; the largest difference read 1.4e-7, AutoInt with microbatches);
* the int8 round trip: codes equal to JAX's except where x / scale sits on
  a rounding boundary (one step of ``scale``, in under 0.1 % of entries).
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
from repro.data.tokens import recsys_batch as jrecsys_batch  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402
from repro_torch.train import tree as tree_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["deepfm", "fm", "xdeepfm", "autoint"]
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree_np):
    return tree_lib.tree_map(lambda a: torch.tensor(np.asarray(a)), tree_np)


def _assert_trees(port, ref, rtol=RTOL, atol=ATOL):
    p, r = tree_lib.paths(port), jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in p] == ["/".join(str(x) for x in path) for path, _ in r]
    for (key, a), (_, b) in zip(p, r):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=key)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "layers": [{"k": rng.normal(size=(4, 4)).astype(np.float32),
                        "s": rng.normal(size=(1,)).astype(np.float32)}]}


OPTS = [
    ("adamw", dict(lr=LR)),
    ("adamw", dict(lr=("cosine", 0.01, 2, 6), weight_decay=0.01, max_grad_norm=0.5)),
    ("adamw", dict(lr=LR, max_grad_norm=None)),
    ("adafactor", dict()),
    ("adafactor", dict(lr=("cosine", 0.05, 1, 4), weight_decay=0.01, clip_threshold=0.5)),
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9)),
]


def _make(lib, name, kw):
    kw = dict(kw)
    lr = kw.pop("lr", None)
    if isinstance(lr, tuple):
        lr = lib.cosine_schedule(*lr[1:])
    if lr is not None:
        kw["lr"] = lr
    return lib.OPTIMIZERS[name](**kw)


@pytest.mark.parametrize("case", range(len(OPTS)))
def test_optimizers_match_jax(case):
    name, kw = OPTS[case]
    params = _opt_tree(case)
    jo, to = _make(jopt, name, kw), _make(topt, name, kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _t_tree(params)
    js, ts = jo.init(jp), to.init(tp)
    for t in range(STEPS):
        grads = _opt_tree(100 + 10 * case + t)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp, ts = to.update(_t_tree(grads), ts, tp)
    _assert_trees(tp, jp)
    assert ts[0] == int(js[0]) == STEPS
    back = convert.opt_state_to_jax(ts, type(js) if hasattr(js, "_fields") else None)
    _assert_trees((tp, convert.opt_state_from_jax(back, device="cpu")), (jp, js))


@pytest.mark.parametrize("sched", [("cosine", 3e-3, 5, 40), ("cosine", 1e-2, 0, 10),
                                   ("cosine", 1e-3, 10, 10), ("constant", 3e-4)])
def test_schedules_match_jax(sched):
    jf = getattr(jopt, f"{sched[0]}_schedule")(*sched[1:])
    tf = getattr(topt, f"{sched[0]}_schedule")(*sched[1:])
    for step in (0, 1, 2, 4, 5, 6, 9, 10, 11, 25, 40, 41, 100):
        ref = float(jf(jnp.asarray(step, jnp.int32)))
        assert tf(step) == pytest.approx(ref, rel=1e-6, abs=1e-12), step


def _codes_agree(port, ref):
    """Dequantized values equal but where a boundary rounds the other way."""
    p, r = np.asarray(port), np.asarray(ref)
    scale = np.abs(r).max() / 127 if r.size else 0
    diff = np.abs(p - r)
    assert (diff <= scale * (1 + 1e-5) + 1e-12).all()
    assert (diff > 1e-7 * max(scale, 1e-30)).mean() <= 1e-3


def test_int8_roundtrip_and_error_feedback_match_jax():
    tree = _opt_tree(5)
    tree["tiny"] = np.zeros((3,), np.float32)
    out = tcomp.fake_int8_roundtrip(_t_tree(tree))
    ref = jcomp.fake_int8_roundtrip(jax.tree_util.tree_map(jnp.asarray, tree))
    for (k, a), (_, b) in zip(tree_lib.paths(out),
                              jax.tree_util.tree_flatten_with_path(ref)[0]):
        _codes_agree(a.numpy(), b)
        assert a.dtype == torch.float32
    # error feedback over 4 steps (each entry within about one code step of
    # JAX's); the residual carries what was not sent: sent + residual sums
    # to the gradients
    jr, tr = jcomp.ErrorFeedback.init(jax.tree_util.tree_map(jnp.asarray, tree)), \
        tcomp.ErrorFeedback.init(_t_tree(tree))
    sent_sum = given = tree_lib.tree_map(torch.zeros_like, tr)
    for t in range(4):
        g = _opt_tree(40 + t)
        g["tiny"] = np.zeros((3,), np.float32)
        js, jr = jcomp.ErrorFeedback.apply(jax.tree_util.tree_map(jnp.asarray, g), jr)
        ts, tr = tcomp.ErrorFeedback.apply(_t_tree(g), tr)
        _assert_trees(ts, js, rtol=0, atol=np.abs(g["w"]).max() / 60)
        sent_sum = tree_lib.tree_map(torch.add, sent_sum, ts)
        given = tree_lib.tree_map(torch.add, given, _t_tree(g))
    _assert_trees(tr, jr, rtol=0, atol=np.abs(g["w"]).max() / 60)
    for (_, a), (_, r), (_, b) in zip(tree_lib.paths(sent_sum), tree_lib.paths(tr),
                                      tree_lib.paths(given)):
        np.testing.assert_allclose((a + r).numpy(), b.numpy(), atol=1e-5)


def _setup(arch, seed=0):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    params = jparams.init_params(jax.random.PRNGKey(seed), jrecsys.recsys_decls(jcfg))
    model = convert.recsys_params_from_jax(_np_tree(params), tcfg, device="cpu")
    return jcfg, params, tcfg, model.tree()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["plain", "microbatches", "int8"])
def test_train_step_matches_jax(arch, mode):
    """3 AdamW steps of ``make_train_step`` from the same weights and state
    (JAX's, converted) on the same ``recsys_batch`` batches of 16."""
    kw = {"plain": {}, "microbatches": {"microbatches": 2},
          "int8": {"grad_compression": "int8"}}[mode]
    jcfg, jp, tcfg, tp = _setup(arch)
    jo, to = jopt.adamw(LR), topt.adamw(LR)
    js = jo.init(jp)
    ts = convert.opt_state_from_jax(_np_tree(js), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, "recsys", jo, **kw))
    tstep = tsteps.make_train_step(tcfg, "recsys", to, **kw)
    for t in range(STEPS):
        b = jrecsys_batch(t, 16, jcfg.vocabs[: jcfg.n_sparse])
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["acc"]) == float(jm["acc"])
    assert ts.step == int(js.step) == STEPS
    _assert_trees((tp, ts), (jp, js))


def test_train_step_refuses_inference_params_and_unported_families():
    _, _, tcfg, tp = _setup("fm")
    opt = topt.adamw(LR)
    with torch.inference_mode():
        frozen = tree_lib.tree_map(torch.clone, tp)
    step = tsteps.make_train_step(tcfg, "recsys", opt)
    b = {k: torch.as_tensor(v) for k, v in jrecsys_batch(0, 8, tcfg.vocabs).items()}
    with pytest.raises(ValueError, match="inference_mode"):
        step(frozen, opt.init(tp), b)
    with pytest.raises(KeyError, match="nope"):
        tsteps.make_train_step(tcfg, "nope", opt)
    with pytest.raises(ValueError, match="grad_compression"):
        tsteps.make_train_step(tcfg, "recsys", opt, grad_compression="fp8")


def test_tree_paths_are_jax_paths():
    _, jp, _, tp = _setup("xdeepfm")
    for jo, to in ((jopt.adamw(), topt.adamw()), (jopt.adafactor(), topt.adafactor()),
                   (jopt.sgd(momentum=0.9), topt.sgd(momentum=0.9)),
                   (jopt.sgd(), topt.sgd())):
        want = ["/".join(str(k) for k in path) for path, _ in
                jax.tree_util.tree_flatten_with_path((jp, jo.init(jp)))[0]]
        assert [k for k, _ in tree_lib.paths((tp, to.init(tp)))] == want
        flat, spec = tree_lib.flatten((tp, to.init(tp)))
        again = tree_lib.unflatten(spec, flat)
        assert [k for k, _ in tree_lib.paths(again)] == want


def test_chunked_cin_serving_equals_unchunked(monkeypatch):
    """The serve step's CIN in chunks of 5 rows against the whole batch of
    23 and against JAX's serve step (rtol 1e-5 / atol 1e-6: a batched
    product rounds with its batch size)."""
    jcfg, jp, tcfg, tp = _setup("xdeepfm", seed=3)
    ids = jrecsys_batch(0, 23, jcfg.vocabs)["ids"]
    serve = tsteps.make_serve_step(tcfg, "recsys")
    x0 = torch.as_tensor(np.random.default_rng(1).normal(size=(23, 6, 4)).astype(np.float32))
    with torch.no_grad():
        whole = torch.sigmoid(trecsys.recsys_forward(tp, torch.as_tensor(ids), tcfg))
        whole_cin = trecsys._cin(tp["cin"], x0)
    monkeypatch.setattr(trecsys, "CIN_CHUNK", 5)
    chunked = serve(tp, {"ids": torch.as_tensor(ids)})
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
    ref = jsteps.make_serve_step(jcfg, "recsys")(jp, {"ids": jnp.asarray(ids)})
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(trecsys, "CIN_CHUNK", 4)
    with torch.no_grad():
        np.testing.assert_allclose(trecsys._cin(tp["cin"], x0).numpy(), whole_cin.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_field_offsets_cached_per_config_and_device():
    cfg = tconfigs.get_reduced("deepfm")
    a = trecsys.field_offsets(cfg)
    assert trecsys.field_offsets(cfg, "cpu") is a
    with torch.inference_mode():
        assert trecsys.field_offsets(cfg) is a
    assert not a.is_inference()
    assert trecsys.field_offsets(tconfigs.get_reduced("fm")) is not a
    np.testing.assert_array_equal(a.numpy(), np.asarray(jrecsys.field_offsets(cfg)))


def _launch(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_cli_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _launch("--arch", "deepfm", "--steps", "12", "--ckpt-every", "5",
                    "--device", "cpu", "--ckpt-dir", ck, cwd=tmp_path)
    assert first.returncode == 0, first.stderr
    lines = first.stdout.splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step 0: loss=")
    assert sorted(os.listdir(ck)) == ["LATEST", "step_00000005", "step_00000010"]
    again = _launch("--arch", "deepfm", "--steps", "12", "--device", "cpu",
                    "--ckpt-dir", ck, "--resume", cwd=tmp_path)
    assert again.returncode == 0, again.stderr
    assert again.stdout.splitlines()[0] == "resumed from step 10"
    assert again.stdout.splitlines()[-2].startswith("step 11: loss=")
    lm = _launch("--steps", "1", "--device", "cpu", "--ckpt-every", "0", "--ckpt-dir",
                 str(tmp_path / "lm"), cwd=tmp_path)  # the default arch, smollm-135m
    assert lm.returncode == 0, lm.stderr
    assert lm.stdout.splitlines()[0].startswith("step 0: loss=")


def test_launcher_build_matches_the_jax_loop_shape():
    """``build`` gives a tree in JAX's structure and a step that learns."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    jparams_, jstate, _, jb = jtrain.build("fm", batch=32)
    tparams_, tstate, step, tb = ttrain.build("fm", batch=32, device="cpu")
    want = ["/".join(str(k) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path((jparams_, jstate))[0]]
    assert [k for k, _ in tree_lib.paths((tparams_, tstate))] == want
    for key in ("ids", "labels"):
        np.testing.assert_array_equal(tb(3)[key].numpy(), np.asarray(jb(3)[key]))
    losses = []
    for t in range(30):
        tparams_, tstate, m = step(tparams_, tstate, tb(t % 2))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # the LM archs build as JAX's: the same tree and TokenStream batches
    jparams_, jstate, _, jb = jtrain.build("smollm-135m", seq_len=16, batch=4)
    tparams_, tstate, _, tb = ttrain.build("smollm-135m", seq_len=16, batch=4, device="cpu")
    want = ["/".join(str(k) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path((jparams_, jstate))[0]]
    assert [k for k, _ in tree_lib.paths((tparams_, tstate))] == want
    np.testing.assert_array_equal(tb(2)["tokens"].numpy(), np.asarray(jb(2)["tokens"]))


def _scripted_step(calls):
    """A step that records the params object it is given and returns a new
    one, with a NaN loss at step 1."""
    def step(params, state, batch):
        calls.append(params)
        loss = float("nan") if len(calls) == 2 else 0.5
        return {"v": len(calls)}, state, {"loss": torch.tensor(loss)}
    return step


def test_nan_guard_drops_the_update_jax_adopts_it(monkeypatch, tmp_path, capsys):
    """The launchers' NaN guard on one scripted step whose loss is NaN at
    step 1: JAX's loop has already taken the step's output
    (``repro/launch/train.py:103-106``), so step 2 runs on it; the port's
    keeps the tree step 1 was given (ROADMAP Queue 3)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    for mod, argv in ((jtrain, ["train", "--arch", "fm", "--steps", "3", "--ckpt-every", "0",
                                "--ckpt-dir", str(tmp_path / "j")]),
                      (ttrain, None)):
        calls = []
        monkeypatch.setattr(mod, "build", lambda *a, _c=calls, **k: (
            {"v": 0}, (), _scripted_step(_c), lambda t: {}))
        if argv is None:
            mod.main(["--arch", "fm", "--steps", "3", "--ckpt-every", "0", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "t")])
            assert calls[2] == calls[1] == {"v": 1}  # the port: step 1's update dropped
        else:
            monkeypatch.setattr(sys, "argv", argv)
            mod.main()
            assert calls[2] == {"v": 2} != calls[1]  # JAX: step 1's output kept
        assert "non-finite loss, update skipped" in capsys.readouterr().out
