"""Training under a mesh: gradients through the port's ``shard_map``, held
to JAX's sharded LM train step, on the CPU; and ``restore(shardings=)``.

One module-scoped JAX child with 8 forced host devices (``OMP_NUM_THREADS
=1``) runs ``tests/test_dist.py::test_lm_train_step_shards_on_small_mesh_
subprocess``'s setting: a (2, 4) data x model mesh, ``REDUCED`` qwen3-moe
with JAX's replacements (4 heads of 4 KV, d_model 64, moe_d_ff 64,
capacity 8: nothing drops, so expert parallelism is the dense function),
``lm_policy(fsdp=True)``, AdamW(1e-3), one step at microbatches 1 and one
at 2, from ``init_params(PRNGKey(0))`` weights it saves for the port and
numpy tokens this module writes.  The port runs the same steps on a (2, 4)
mesh of ranks on the CPU, every MoE layer through the EP ``shard_map``
with gradients.

Tolerances: the port's mesh loss against JAX's mesh loss, rtol 1e-5 (JAX's
own test holds its mesh loss to its unsharded loss within 0.05 absolute);
the port's mesh gradients against its unsharded gradients, rtol / atol
1e-5 (f32; the ranks' partial sums are added in another order); with
``remat`` on against off, bit for bit.  ``psum`` and ``all_gather``
(tiled and stacked, over one axis and two) pass ``torch.autograd.
gradcheck`` in f64.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402
from repro_torch.train import tree as tree_lib  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BASE = "qwen3-moe-235b-a22b"
#: JAX's test's replacements of the REDUCED config
REPLACE = dict(num_heads=4, num_kv_heads=4, d_model=64, moe_d_ff=64, capacity_factor=8.0)
MESH = (2, 4)
TOKENS = (4, 16)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
MICROBATCHES = (1, 2)

_CHILD = r"""
import dataclasses as dc, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist.sharding import lm_policy
from repro.launch.mesh import make_test_mesh
from repro.models import params as plib, transformer
from repro.train import optimizer as opt_lib, train_step as steps

root = sys.argv[1]
with open(os.path.join(root, "spec.json")) as fh:
    spec = json.load(fh)
toks = np.load(os.path.join(root, "tokens.npy"))
mesh = make_test_mesh(tuple(spec["mesh"]), ("data", "model"))
cfg = dc.replace(configs.get_reduced(spec["base"]), **spec["replace"])
dctx = lm_policy(cfg, mesh, batch=toks.shape[0], fsdp=True)
decls = transformer.lm_decls(cfg)
params = plib.init_params(jax.random.PRNGKey(0), decls)
out = {f"param/{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(params))}
pspecs = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), dctx.shard_w(decls),
                                is_leaf=lambda x: isinstance(x, P))
params = jax.device_put(params, pspecs)
opt = opt_lib.adamw(1e-3)
state = opt.init(params)
for mb in spec["microbatches"]:
    step = steps.make_train_step(cfg, "lm", opt, dctx, microbatches=mb)
    with mesh:
        _, _, m = jax.jit(step)(params, state, {"tokens": jnp.asarray(toks)})
    out[f"loss/{mb}"] = np.asarray(m["loss"])
loss_ref, _ = transformer.lm_loss(jax.device_get(params), {"tokens": jnp.asarray(toks)}, cfg)
out["loss_ref"] = np.asarray(loss_ref)
np.savez(os.path.join(root, "jax_out.npz"), **out)
print("OK")
"""


def _cfg(**extra):
    return dataclasses.replace(tconfigs.get_reduced(BASE), **REPLACE, **extra)


def _tokens():
    return np.random.default_rng(1).integers(0, _cfg().vocab_size, size=TOKENS).astype(np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's outputs of the one 8-device child."""
    root = tmp_path_factory.mktemp("mesh_train")
    np.save(root / "tokens.npy", _tokens())
    (root / "spec.json").write_text(json.dumps(
        {"mesh": MESH, "base": BASE, "replace": REPLACE, "microbatches": MICROBATCHES}))
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD), str(root)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(root / "jax_out.npz") as z:
        return {k: z[k] for k in z.files}


def _params(jax_out, cfg):
    decls = ttf.lm_decls(cfg)
    by_path = {path: jax_out[f"param/{i}"] for i, (path, _) in enumerate(tparams.leaves(decls))}
    tree = tparams.map_decls(lambda path, _: by_path[path], decls)
    return convert.lm_params_from_jax(tree, cfg, device="cpu").tree()


def _dctx(cfg, shape=MESH):
    return sharding.lm_policy(cfg, make_test_mesh(shape, device="cpu"), batch=TOKENS[0],
                              fsdp=True)


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_mesh_train_step_matches_jax(run, microbatches):
    cfg = _cfg()
    params = _params(run, cfg)
    dctx = _dctx(cfg)
    assert dctx.batch_axes == ("data",) and ttf.moe_takes_ep(cfg, dctx, TOKENS[0] // microbatches)
    opt = opt_lib.adamw(1e-3)
    step = tsteps.make_train_step(cfg, "lm", opt, dctx, microbatches=microbatches)
    new, state, m = step(params, opt.init(params), {"tokens": torch.as_tensor(_tokens())})
    loss = float(m["loss"])
    assert loss == pytest.approx(float(run[f"loss/{microbatches}"]), rel=LOSS_RTOL)
    assert all(torch.isfinite(t).all() for t in tree_lib.leaves(new))
    if microbatches == 1:
        assert abs(loss - float(run["loss_ref"])) < 0.05  # JAX's own bound


@pytest.mark.parametrize("remat", [False, True])
def test_mesh_gradients_match_unsharded(run, remat):
    cfg = _cfg(remat=remat)
    params = _params(run, cfg)
    batch = {"tokens": torch.as_tensor(_tokens())}
    g_mesh, m_mesh = tsteps.value_and_grad(ttf.lm_loss, params, batch, cfg, _dctx(cfg))
    g_one, m_one = tsteps.value_and_grad(ttf.lm_loss, params, batch, cfg, None)
    assert float(m_mesh["loss"]) == pytest.approx(float(m_one["loss"]), rel=GRAD_TOL)
    for (path, a), b in zip(tree_lib.paths(g_mesh), tree_lib.leaves(g_one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


def test_remat_changes_no_mesh_gradient(run):
    """Under remat the rank threads keep their activations (the
    checkpoint's hooks are thread-local); the gradients are the same
    bits."""
    batch = {"tokens": torch.as_tensor(_tokens())}
    grads = []
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        grads.append(tsteps.value_and_grad(ttf.lm_loss, _params(run, cfg), batch, cfg,
                                           _dctx(cfg))[0])
    for a, b in zip(*(tree_lib.leaves(g) for g in grads)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- gradcheck

#: (collective, axes, all_gather's axis, tiled)
GRADCHECKS = [("psum", "data", None, None), ("psum", ("data", "model"), None, None),
              ("all_gather", "model", 0, True), ("all_gather", "model", 1, False),
              ("all_gather", ("data", "model"), 1, True),
              ("all_gather", ("data", "model"), 0, False)]


@pytest.mark.parametrize("kind,axes,axis,tiled", GRADCHECKS,
                         ids=[f"{k}-{a}-{x}-{t}" for k, a, x, t in GRADCHECKS])
def test_collective_gradcheck(kind, axes, axis, tiled):
    """A nonlinear map around the collective, so every member's cotangent
    differs; ``shard_map`` over (2, 2) ranks, f64."""
    mesh = make_test_mesh((2, 2), device="cpu")

    def f(x, w):
        y = torch.tanh(x * w)
        if kind == "psum":
            z = sharding.psum(y, axes)
        else:
            z = sharding.all_gather(y, axes, axis=axis, tiled=tiled)
        return torch.sin(z) * (1.0 + sharding.axis_index("model"))

    spec = P("data", "model")
    out_spec = P("data", "model") if kind == "psum" else P("data")
    fn = sharding.shard_map(f, mesh=mesh, in_specs=(spec, spec), out_specs=out_spec)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(4, 6, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(fn, (x, w))


# ---------------------------------------------------------------- re-mesh

def test_restore_under_another_mesh_is_bit_equal(tmp_path):
    """(params, AdamW state) saved under the (2, 4) policy, restored under
    the (4, 2) and (1, 8) policies' ``shard_w`` specs."""
    cfg = tconfigs.get_reduced(BASE)
    decls = ttf.lm_decls(cfg)
    params = ttf.LMModel.build(cfg, device="cpu").tree()
    opt = opt_lib.adamw(1e-3)
    state = opt.init(params)
    step = tsteps.make_train_step(cfg, "lm", opt)
    params, state, _ = step(params, state, {"tokens": torch.as_tensor(_tokens() % cfg.vocab_size)})
    ckpt.save(str(tmp_path), 3, (params, state))
    for shape in ((4, 2), (1, 8)):
        mesh = make_test_mesh(shape, device="cpu")
        pspecs = sharding.lm_policy(cfg, mesh, fsdp=True).shard_w(decls)
        specs = (pspecs, opt_lib.AdamWState(step=P(), mu=pspecs, nu=pspecs))
        got, at = ckpt.restore(str(tmp_path), (params, state), shardings=specs, mesh=mesh)
        assert at == 3 and got[1].step == state.step
        for a, b in zip(tree_lib.leaves(got), tree_lib.leaves((params, state))):
            assert (a == b) if isinstance(a, int) else (a.device == mesh.device
                                                        and torch.equal(a, b))


def test_restore_refuses_a_spec_that_does_not_divide(tmp_path):
    cfg = tconfigs.get_reduced(BASE)
    params = ttf.LMModel.build(cfg, device="cpu").tree()
    ckpt.save(str(tmp_path), 1, params)
    mesh = make_test_mesh((3, 4), device="cpu")
    pspecs = sharding.lm_policy(cfg, mesh, fsdp=True).shard_w(ttf.lm_decls(cfg))
    with pytest.raises(ValueError, match="does not split 3 ways"):
        ckpt.restore(str(tmp_path), params, shardings=pspecs, mesh=mesh)
    with pytest.raises(ValueError, match="mesh="):
        ckpt.restore(str(tmp_path), params, shardings=pspecs)
