"""Expert-parallel MoE and the LM under a mesh: the port against JAX's
8-device run, on the CPU.

One module-scoped JAX child with 8 forced host devices (a (2, 4) data x
model mesh, ``OMP_NUM_THREADS=1``) computes, from the numpy inputs this
module writes: ``moe_ffn_ep`` in its three modes and
``moe_ffn_ep_zero3``, each at ``capacity_factor`` 1.25 (slots drop) and
8.0 (none do), and 2d once more in chunks; ``embedding_lookup`` under a
batch rule; the ``REDUCED`` qwen3-moe and deepseek-v3 prefill and two
decode steps under ``lm_policy`` on (2, 4), its ``init_params`` weights
saved for the port (``convert.lm_params_from_jax``); and the blocks
``jax.device_put`` gives each device for three specs.  The port runs the
same on a (2, 4) mesh of ranks on the CPU.  Modes come from
``dataclasses.replace`` on the ``REDUCED`` qwen3-moe config: E = 8 -> 2d,
E = 4 -> fslice, E = 4 with an odd ``moe_d_ff`` -> model.  Tolerance
rtol / atol 1e-5 (f32; each token's k expert outputs and the ranks'
partials are added in another order); block contents and slot drops
equal.
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
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.embedlookup import embedding_lookup  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = ATOL = 1e-5
CPU = "cpu"
MESH = (2, 4)
BASE = "qwen3-moe-235b-a22b"
#: case -> (num_experts, moe_d_ff, impl)
MODES = {"2d": (8, 64, "gathered"), "fslice": (4, 64, "gathered"),
         "model": (4, 63, "gathered"), "zero3": (8, 64, "zero3")}
CAPACITY = (1.25, 8.0)
CHUNK = 16  # MOE_CHUNK_TOKENS of the chunked case: 8 tokens a rank, 4 chunks
EP_SHAPE = (4, 16)  # (B, S): 32 tokens a data rank, 64 gathered
#: (case, mode, capacity_factor, MOE_CHUNK_TOKENS)
EP_CASES = [(f"{m}/{cf}", m, cf, 32768) for m in MODES for cf in CAPACITY] + [
    ("2d/1.25/chunked", "2d", 1.25, CHUNK)]
LM_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v3-671b"]
LM_SHAPE = (2, 12, 2)  # batch, prompt, decode steps
BLOCK_SPECS = {"experts 2d": (("model", "data"), None, None),
               "fslice": ("model", None, "data"), "batch": ("data",)}

_CHILD = r"""
import dataclasses as dc, json, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist.embedlookup import embedding_lookup
from repro.dist.sharding import DistCtx, lm_policy
from repro.launch.mesh import make_test_mesh
from repro.models import moe as moe_lib, params as plib, transformer as tf

root = sys.argv[1]
with open(os.path.join(root, "spec.json")) as fh:
    spec = json.load(fh)
inp = dict(np.load(os.path.join(root, "inputs.npz")))
mesh = make_test_mesh(tuple(spec["mesh"]), ("data", "model"))
out = {}
base = configs.get_reduced(spec["base"])
for case, mode, cf, chunk in spec["ep"]:
    E, f, impl = spec["modes"][mode]
    cfg = dc.replace(base, num_experts=E, moe_d_ff=f, capacity_factor=cf)
    fn = moe_lib.moe_ffn_ep_zero3 if impl == "zero3" else moe_lib.moe_ffn_ep
    p = {w: inp[f"{mode}/{w}"] for w in ("wg", "wu", "wd")}
    moe_lib.MOE_CHUNK_TOKENS = chunk
    with mesh:
        y = jax.jit(lambda x, pr, p: fn(x, pr, p, cfg, mesh=mesh, batch_axes=("data",)))(
            inp[f"{mode}/x"], inp[f"{mode}/probs"], p)
    out[f"ep/{case}"] = np.asarray(y)
moe_lib.MOE_CHUNK_TOKENS = 32768
ctx = DistCtx(mesh=mesh, w_rules={}, a_rules={"batch": "data"})
with mesh:
    out["embed"] = np.asarray(jax.jit(lambda t, i: embedding_lookup(t, i, ctx))(
        inp["embed/table"], inp["embed/ids"]))
B, S, n = spec["lm_shape"]
for arch in spec["lm_archs"]:
    cfg = configs.get_reduced(arch)
    params = plib.init_params(jax.random.PRNGKey(0), tf.lm_decls(cfg))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"{arch}/param/{i}"] = np.asarray(leaf)
    toks = inp[f"{arch}/tokens"]
    pre = lm_policy(cfg, mesh, kind="prefill", batch=B)
    dec = lm_policy(cfg, mesh, kind="decode", batch=B)
    absorb = cfg.attention == "mla"
    with mesh:
        last, cache = jax.jit(lambda p, t: tf.lm_prefill(p, t, cfg, pre, max_len=S + n))(
            params, toks[:, :S])
        step = jax.jit(lambda p, c, t, pos: tf.lm_decode_step(p, c, t, pos, cfg, dec,
                                                              mla_absorb=absorb))
        logits = []
        for i in range(n):
            lg, cache = step(params, cache, toks[:, S + i:S + i + 1], jnp.int32(S + i))
            logits.append(np.asarray(lg))
    out[f"{arch}/prefill"] = np.asarray(last)
    out[f"{arch}/decode"] = np.concatenate(logits, 1)
pos = {d.id: r for r, d in enumerate(mesh.devices.reshape(-1))}
for name, parts in spec["blocks"].items():
    arr = jax.device_put(inp["blocks/x"], NamedSharding(mesh, P(*[
        tuple(p) if isinstance(p, list) else p for p in parts])))
    for shard in arr.addressable_shards:
        out[f"blocks/{name}/{pos[shard.device.id]}"] = np.asarray(shard.data)
np.savez(os.path.join(root, "jax_out.npz"), **out)
print("OK")
"""


def _ep_inputs(mode: str):
    """x (B, S, d), probs (B, S, E) skewed towards the low experts (so
    capacity 1.25 drops slots), and the expert weights."""
    E, f, _ = MODES[mode]
    d = tconfigs.get_reduced(BASE).d_model
    B, S = EP_SHAPE
    rng = np.random.default_rng(len(mode))
    logits = rng.normal(size=(B, S, E)) + np.linspace(1.5, 0.0, E)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"x": rng.normal(size=(B, S, d)), "probs": probs,
            "wg": rng.normal(size=(E, d, f)) * 0.05, "wu": rng.normal(size=(E, d, f)) * 0.05,
            "wd": rng.normal(size=(E, f, d)) * 0.05}


def _inputs() -> dict:
    out = {f"{m}/{k}": v.astype(np.float32) for m in MODES for k, v in _ep_inputs(m).items()}
    rng = np.random.default_rng(7)
    out["embed/table"] = rng.normal(size=(64, 8)).astype(np.float32)
    out["embed/ids"] = rng.integers(0, 64, size=(16, 5)).astype(np.int32)
    B, S, n = LM_SHAPE
    for i, arch in enumerate(LM_ARCHS):
        out[f"{arch}/tokens"] = np.random.default_rng(10 + i).integers(
            0, tconfigs.get_reduced(arch).vocab_size, size=(B, S + n)).astype(np.int32)
    out["blocks/x"] = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX's outputs) of the one 8-device child."""
    root = tmp_path_factory.mktemp("moe_ep")
    inputs = _inputs()
    np.savez(root / "inputs.npz", **inputs)
    spec = {"mesh": MESH, "base": BASE, "modes": MODES, "ep": EP_CASES,
            "lm_shape": LM_SHAPE, "lm_archs": LM_ARCHS,
            "blocks": {k: list(v) for k, v in BLOCK_SPECS.items()}}
    (root / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD), str(root)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(root / "jax_out.npz") as z:
        return inputs, {k: z[k] for k in z.files}


def _mesh(shape=MESH):
    return make_test_mesh(shape, device=CPU)


def _ep_cfg(mode: str, cf: float):
    E, f, _ = MODES[mode]
    return dataclasses.replace(tconfigs.get_reduced(BASE), num_experts=E, moe_d_ff=f,
                               capacity_factor=cf)


def _ep(mode, cfg, x, probs, p, mesh):
    fn = tmoe.moe_ffn_ep_zero3 if MODES[mode][2] == "zero3" else tmoe.moe_ffn_ep
    return fn(x, probs, p, cfg, mesh=mesh, batch_axes=("data",))


def _tensors(inputs, mode):
    t = {k: torch.as_tensor(inputs[f"{mode}/{k}"]) for k in ("x", "probs", "wg", "wu", "wd")}
    return t["x"], t["probs"], {k: t[k] for k in ("wg", "wu", "wd")}


def _close(port, ref, msg=""):
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=RTOL, atol=ATOL,
                               err_msg=msg)


@pytest.mark.parametrize("case,mode,cf,chunk", EP_CASES, ids=[c[0] for c in EP_CASES])
def test_moe_ep_matches_jax(run, monkeypatch, case, mode, cf, chunk):
    inputs, jax_out = run
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", chunk)
    cfg = _ep_cfg(mode, cf)
    mesh = _mesh()
    assert tmoe.ep_mode(cfg, mesh) == ("2d" if mode == "zero3" else mode)
    slots = []
    inner = tmoe._slot_maps

    def spy(top_i, top_w, eo, E_loc, C, T, k, dtype):
        local = (top_i >= eo) & (top_i < eo + E_loc)
        loads = torch.bincount((top_i - eo)[local], minlength=E_loc)
        slots.append(int((loads - C).clamp_min(0).sum()))
        return inner(top_i, top_w, eo, E_loc, C, T, k, dtype)

    monkeypatch.setattr(tmoe, "_slot_maps", spy)
    x, probs, p = _tensors(inputs, mode)
    _close(_ep(mode, cfg, x, probs, p, mesh), jax_out[f"ep/{case}"], case)
    if chunk == CHUNK:
        assert len(slots) == mesh.size * EP_SHAPE[0] * EP_SHAPE[1] // MESH[0] // (CHUNK // 2)
    if cf == CAPACITY[0]:
        assert sum(slots) > 0, "capacity 1.25 should drop slots"
    else:
        assert sum(slots) == 0


def test_embedding_lookup_under_a_batch_rule(run):
    inputs, jax_out = run
    ctx = sharding.DistCtx(mesh=_mesh(), w_rules={}, a_rules={"batch": "data"})
    out = embedding_lookup(torch.as_tensor(inputs["embed/table"]),
                           torch.as_tensor(inputs["embed/ids"]), ctx)
    np.testing.assert_array_equal(out.numpy(), jax_out["embed"])


@pytest.mark.parametrize("name", list(BLOCK_SPECS))
def test_local_blocks_are_jax_device_shards(run, name):
    """The port's per-rank blocks (``local_blocks``, what a rank takes of a
    weight tree) equal what ``jax.device_put`` places on each device."""
    inputs, jax_out = run
    blocks = sharding.local_blocks(torch.as_tensor(inputs["blocks/x"]),
                                   P(*BLOCK_SPECS[name]), _mesh())
    for r, b in enumerate(blocks):
        np.testing.assert_array_equal(b.numpy(), jax_out[f"blocks/{name}/{r}"])


def _lm(arch, jax_out):
    """The port's model on the CPU from the weights JAX's child drew."""
    cfg = tconfigs.get_reduced(arch)
    decls = ttf.lm_decls(cfg)
    by_path = {path: jax_out[f"{arch}/param/{i}"]
               for i, (path, _) in enumerate(tparams.leaves(decls))}
    tree = tparams.map_decls(lambda path, _: by_path[path], decls)
    return cfg, convert.lm_params_from_jax(tree, cfg, device=CPU)


def _serve(model, cfg, toks, dctx_pre, dctx_dec):
    B, S, n = LM_SHAPE
    absorb = cfg.attention == "mla"
    with torch.inference_mode():
        last, cache = ttf.lm_prefill(model, toks[:, :S], cfg, dctx_pre, max_len=S + n)
        steps = [ttf.lm_decode_step(model, cache, toks[:, S + i:S + i + 1], S + i, cfg,
                                    dctx_dec, mla_absorb=absorb)[0] for i in range(n)]
    return last, torch.cat(steps, 1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_under_lm_policy_matches_jax(run, arch):
    """Prefill and two decode steps of the ``REDUCED`` model under
    ``lm_policy`` on (2, 4): its MoE layers run ``moe_ffn_ep`` (2d, slots
    dropping at capacity 1.25) on the port's ranks as on JAX's devices."""
    inputs, jax_out = run
    cfg, model = _lm(arch, jax_out)
    B = LM_SHAPE[0]
    mesh = _mesh()
    pre = sharding.lm_policy(cfg, mesh, kind="prefill", batch=B)
    dec = sharding.lm_policy(cfg, mesh, kind="decode", batch=B)
    assert pre.batch_axes == ("data",) and tmoe.ep_mode(cfg, mesh) == "2d"
    toks = torch.as_tensor(inputs[f"{arch}/tokens"])
    last, steps = _serve(model, cfg, toks, pre, dec)
    _close(last, jax_out[f"{arch}/prefill"], "prefill")
    _close(steps, jax_out[f"{arch}/decode"], "decode")
    S = LM_SHAPE[1]
    got, _ = tsteps.make_prefill_step(cfg, pre, max_len=S + 1)(model, toks[:, :S])
    assert torch.equal(got, last)


# ---------------------------------------------------------------- port only

@pytest.mark.parametrize("mode", list(MODES))
def test_ep_without_drops_equals_dispatch(mode):
    cfg = _ep_cfg(mode, 8.0)
    x, probs, p = _tensors({f"{mode}/{k}": v.astype(np.float32)
                            for k, v in _ep_inputs(mode).items()}, mode)
    top_w, top_i = tmoe.topk_weights(probs, cfg)
    want = tmoe.moe_ffn_dispatch(x, top_w, top_i, p, cfg)
    _close(_ep(mode, cfg, x, probs, p, _mesh()), want.numpy(), mode)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_one_rank_mesh_changes_nothing(arch):
    """Under the ``lm_policy`` of a 1 x 1 mesh the model serves bit for
    bit as without a context."""
    cfg = tconfigs.get_reduced(arch)
    model = ttf.LMModel.build(cfg, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(LM_SHAPE[0], LM_SHAPE[1] + LM_SHAPE[2])))
    mesh = _mesh((1, 1))
    ctx = [sharding.lm_policy(cfg, mesh, kind=k, batch=LM_SHAPE[0])
           for k in ("prefill", "decode")]
    with_ctx = _serve(model, cfg, toks, *ctx)
    plain = _serve(model, cfg, toks, None, None)
    for a, b in zip(with_ctx, plain):
        assert torch.equal(a, b)


def test_lm_train_step_under_an_ep_mesh_raises():
    """No gradient through the port's ``shard_map`` yet."""
    cfg = tconfigs.get_reduced(BASE)
    model = ttf.LMModel.build(cfg, device=CPU)
    dctx = sharding.lm_policy(cfg, _mesh(), kind="train", batch=2)
    opt = opt_lib.adamw(1e-3)
    params = model.tree()
    step = tsteps.make_train_step(cfg, "lm", opt, dctx)
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    with pytest.raises(NotImplementedError, match="gradient"):
        step(params, opt.init(params), {"tokens": toks})


def _corpus():
    return np.random.default_rng(5).normal(size=(256, 16)).astype(np.float32)


def test_sharded_index_on_a_mesh_gives_the_same_ids():
    X = _corpus()
    Q = torch.as_tensor(X[:9] + 0.01)
    plain = tindex.build("sharded", X, {"engine": "brute", "shards": 2}, device=CPU)
    mesh = make_test_mesh((2,), ("data",), device=CPU)
    meshed = tindex.build("sharded", X, {"engine": "brute", "shards": 2, "mesh": mesh},
                          device=CPU)
    assert meshed.dctx.mesh is mesh and meshed.dctx.w_rules == {"corpus": "data"}
    a, b = plain.search(Q, k=7), meshed.search(Q, k=7)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)


def test_sharded_index_rejects_a_mesh_not_matching_shards():
    with pytest.raises(ValueError, match="mesh data axis"):
        tindex.ShardedIndex.build(_corpus(), shards=2,
                                  mesh=make_test_mesh((4,), ("data",), device=CPU))
