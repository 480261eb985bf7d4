"""Port parity: LM training (``transformer.lm_loss``, the ``lm`` family of
``make_train_step``, per-layer remat, the chunked attention's backward and
``launch.train``'s LM archs) against the JAX package, on the CPU at the
``REDUCED`` configs (f32).

The same numpy inputs go to both: JAX's ``init_params`` weights and AdamW
state converted for the port, ``TokenStream``-shaped random tokens.
Tolerances, each with its reason:

* the loss and its metrics (``ce``, ``moe_aux``, ``mtp_ce``, ``loss``):
  rtol 1e-5 (the same f32 sums in another order);
* gradients against ``jax.grad``: every leaf within rtol 1e-4 plus 1e-5
  of its largest magnitude (a gradient sums over the batch, the positions
  and, for the experts, the routed tokens in another order than JAX's;
  an entry near zero is a difference of such sums; the largest
  difference read was 2.4e-6, 1.9e-6 of its leaf's largest entry);
* ``_chunked_causal``'s q / k / v gradients: rtol / atol 1e-5;
* 3 AdamW(3e-4) steps, plain and ``microbatches=2``: per-step losses rtol
  1e-5; every parameter and moment rtol 1e-5 / atol 1e-6, but for at most
  10 entries of the tree, which must lie within 5e-5 (a sixth of the
  learning rate).  Adam moves a weight by about lr * m / sqrt(v), which
  for a gradient near zero turns on its last bits: a gradient of 1e-9
  here and -1e-9 there moves the weight by +-0.1 lr.  The LM trees have
  such entries (the largest difference read was 1.5e-5, smollm's ``wo``;
  at most 4 entries of a tree were past 1e-6); the recsys trees held to
  1e-6 have none.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402
from repro_torch.train import tree as tree_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ["smollm-135m", "gemma-2b", "deepseek-coder-33b", "qwen3-moe-235b-a22b",
            "deepseek-v3-671b"]
RTOL = 1e-5
GRAD_RTOL, GRAD_SCALE = 1e-4, 1e-5
LR = 3e-4
STEPS = 3
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
NEAR_ZERO_ATOL, NEAR_ZERO_ENTRIES = 5e-5, 10


def _setup(arch, seed=0, b=2, s=12):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jparams.init_params(jax.random.PRNGKey(seed), jtf.lm_decls(jcfg))
    model = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                       device="cpu")
    toks = np.random.default_rng(seed + 20).integers(0, jcfg.vocab_size, (b, s)).astype(
        np.int32)
    return jcfg, tcfg, jp, model.tree(), toks


def _jpaths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _jax_value_and_grad(jcfg, jp, toks):
    """JAX's ((loss, metrics), grads) of ``lm_loss``, jitted (its trace
    and compile take less than an eager call's op-by-op dispatch)."""
    fn = jax.value_and_grad(lambda p: jtf.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg),
                            has_aux=True)
    return jax.jit(fn)(jp)


def _same_grads(port, ref):
    got, want = tree_lib.paths(port), _jpaths(ref)
    assert [k for k, _ in got] == ["/".join(str(x) for x in path) for path, _ in want]
    for (key, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * max(float(np.abs(b).max()), 1e-12),
                                   err_msg=key)


def _same_metrics(tm, jm, cfg):
    want = ["ce", "moe_aux"] + (["mtp_ce"] if cfg.mtp else []) + ["loss"]
    assert list(tm) == want and sorted(jm) == sorted(want)
    for key in want:
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=RTOL, abs=1e-7), key


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """``lm_loss``'s metrics (CE with the last position masked, the MoE aux
    loss, deepseek-v3's MTP CE, the total) and the gradient of every leaf
    against ``jax.value_and_grad`` of JAX's."""
    jcfg, tcfg, jp, tp, toks = _setup(arch)
    (_, jm), jg = _jax_value_and_grad(jcfg, jp, toks)
    tg, tm = tsteps.value_and_grad(ttf.lm_loss, tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    _same_metrics(tm, jm, tcfg)
    _same_grads(tg, jg)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b"])
def test_lm_loss_with_a_batch_mask_matches_jax(arch):
    jcfg, tcfg, jp, tp, toks = _setup(arch, seed=1)
    batch = {"tokens": toks,
             "mask": (np.random.default_rng(3).random(toks.shape) < 0.7).astype(np.int32)}
    _, jm = jax.jit(lambda p, b: jtf.lm_loss(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, tm = ttf.lm_loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    _same_metrics(tm, jm, tcfg)
    assert tm["loss"] is loss


def test_lm_grads_through_the_chunked_attention_match_jax(monkeypatch):
    """CHUNK_THRESHOLD / CHUNK_SIZE at 16 / 8 in both packages: deepseek-v3's
    32-token loss takes the online-softmax loop (MLA's K/V expanded per
    chunk, in the stacks and the MTP block) forward and backward.  GQA's
    view of the loop is held alone below."""
    arch = "deepseek-v3-671b"
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "CHUNK_SIZE", 8)
    jcfg, tcfg, jp, tp, toks = _setup(arch, seed=2, s=32)
    calls = []
    inner = tattn._chunked_causal
    monkeypatch.setattr(tattn, "_chunked_causal",
                        lambda *a, **k: calls.append(a[2]) or inner(*a, **k))
    (_, jm), jg = _jax_value_and_grad(jcfg, jp, toks)
    tg, tm = tsteps.value_and_grad(ttf.lm_loss, tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert calls == [4] * (tcfg.num_layers + tcfg.mtp)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    _same_grads(tg, jg)


@pytest.mark.parametrize("order", ["ascending", "shuffled"])
def test_chunked_causal_gradient_matches_jax(order):
    """``_chunked_causal`` alone under autograd: the gradients of a random
    projection of its output with respect to q, k and v against
    ``jax.grad`` through JAX's scan (ascending positions skip the rows
    wholly before a chunk; shuffled ones compute every row)."""
    rng = np.random.default_rng(12)
    Bq, Sq, KV, G, Dh, Dv, C = 2, 24, 2, 3, 8, 6, 8
    q = rng.normal(size=(Bq, Sq, KV, G, Dh)).astype(np.float32) * 0.5
    k = rng.normal(size=(Bq, Sq, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, KV, Dv)).astype(np.float32)
    w = rng.normal(size=(Bq, Sq, KV, G, Dv)).astype(np.float32)
    pos = np.arange(Sq) if order == "ascending" else rng.permutation(Sq)

    def jloss(q, k, v):
        out = jattn._chunked_causal(
            q, lambda c: (jax.lax.dynamic_slice_in_dim(k, c * C, C, 1),
                          jax.lax.dynamic_slice_in_dim(v, c * C, C, 1)),
            Sq // C, C, jnp.asarray(pos), jnp.float32, v_dim=Dv)
        return jnp.sum(out * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tattn._chunked_causal(tq, lambda c: (tk[:, c * C:(c + 1) * C],
                                               tv[:, c * C:(c + 1) * C]),
                                Sq // C, C, torch.as_tensor(pos), torch.float32, v_dim=Dv)
    (out * torch.as_tensor(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _t_state(state):
    return convert.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, state), device="cpu")


@pytest.mark.parametrize("arch,mb", [(a, 1) for a in LM_ARCHS]
                         + [("smollm-135m", 2), ("deepseek-v3-671b", 2)])
def test_lm_train_step_matches_jax(arch, mb):
    """3 AdamW(3e-4) steps of ``make_train_step(cfg, "lm", opt)`` from the
    same weights and state (JAX's, converted) on the same batches of 4
    against JAX's jitted step; ``microbatches=2`` on a dense and the MLA +
    MoE + MTP arch."""
    jcfg, tcfg, jp, tp, _ = _setup(arch, seed=3)
    jo, to = jopt.adamw(LR), topt.adamw(LR)
    js = jo.init(jp)
    ts = _t_state(js)
    jstep = jax.jit(jsteps.make_train_step(jcfg, "lm", jo, microbatches=mb))
    tstep = tsteps.make_train_step(tcfg, "lm", to, microbatches=mb)
    rng = np.random.default_rng(30)
    for t in range(STEPS):
        toks = rng.integers(0, jcfg.vocab_size, (4, 10)).astype(np.int32)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.as_tensor(toks)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL), t
    assert ts.step == int(js.step) == STEPS
    got, want = tree_lib.paths((tp, ts)), _jpaths((jp, js))
    assert [k for k, _ in got] == ["/".join(str(x) for x in path) for path, _ in want]
    outside = 0
    for (key, a), (_, b) in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        diff = np.abs(a - np.asarray(b))
        outside += int((diff > STEP_ATOL + STEP_RTOL * np.abs(np.asarray(b))).sum())
        np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL, atol=NEAR_ZERO_ATOL,
                                   err_msg=key)
    assert outside <= NEAR_ZERO_ENTRIES


def test_remat_checkpoints_each_layer_and_changes_no_value(monkeypatch):
    """``cfg.remat`` (set by every published config) runs each layer of the
    stacks and the MTP block under ``torch.utils.checkpoint`` when
    gradients flow, and nowhere else; the loss and every gradient equal
    the unrematerialised ones bit for bit."""
    import dataclasses

    _, tcfg, _, tp, toks = _setup("deepseek-v3-671b", seed=4)
    calls = []
    inner = ttf.checkpoint
    monkeypatch.setattr(ttf, "checkpoint", lambda *a, **k: calls.append(1) or inner(*a, **k))
    batch = {"tokens": torch.as_tensor(toks)}
    plain, pm = tsteps.value_and_grad(ttf.lm_loss, tp, batch, tcfg)
    assert calls == []
    remat = dataclasses.replace(tcfg, remat=True)
    grads, rm = tsteps.value_and_grad(ttf.lm_loss, tp, batch, remat)
    assert len(calls) == tcfg.num_layers + 1  # the stacks, then the MTP block
    assert torch.equal(rm["loss"], pm["loss"])
    for (key, a), (_, b) in zip(tree_lib.paths(grads), tree_lib.paths(plain)):
        assert torch.equal(a, b), key
    with torch.no_grad():
        ttf.lm_forward(tp, batch["tokens"], remat)
    assert len(calls) == tcfg.num_layers + 1  # no checkpoint without gradients


def test_launcher_trains_smollm_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train`` with its default arch
    (smollm-135m, reduced), 30 AdamW(3e-4) steps on ``TokenStream``
    batches: it runs, checkpoints, and its loss falls."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "30",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", out.stdout)]
    assert out.stdout.splitlines()[-1] == "done" and len(losses) == 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.05
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_00000020"]
