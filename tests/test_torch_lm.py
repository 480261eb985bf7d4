"""Port parity: LM serving (``models/layers``, ``models/attention``,
``models/moe``, ``models/transformer``, ``make_prefill_step`` /
``make_decode_step``, ``convert.lm_params_from_jax``,
``data/tokens.TokenStream``) and the config registry against the JAX
package, on the CPU.

The same numpy inputs go to both: JAX's ``init_params`` weights converted
for the port (nothing transposed; the MoE and MLA trees and deepseek-v3's
``mtp`` included), tokens from numpy.  JAX's side of the forward / prefill
/ decode comparisons is computed once per architecture (its decode steps
jitted; deepseek-v3's for both MLA decodes).  All five archs at
``REDUCED`` (f32).  Tolerances: logits, caches and layer outputs rtol
1e-5 / atol 1e-5 (the same f32 products, summed in another order by the
two frameworks' matmuls; the chunked path's online softmax in the same
order of chunks; the MoE dispatch adds each token's k expert outputs in
another order than JAX's dense sum over all experts); the smollm case at
published widths rtol 1e-5 / atol 1e-5 as well; greedy tokens, token
streams, samplers and parameter counts equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import train_step as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import train_step as tsteps  # noqa: E402

RTOL = ATOL = 1e-5
DENSE = ["smollm-135m", "gemma-2b", "deepseek-coder-33b"]
LM_ARCHS = DENSE + ["qwen3-moe-235b-a22b", "deepseek-v3-671b"]
B, S, DECODE = 2, 12, 8


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _reference(jcfg, jp, toks, steps=DECODE, mla_absorb=False):
    """JAX's forward logits and aux loss, prefill (last logits, cache of S
    + steps) and ``steps`` greedy decode steps (logits per step, the final
    cache)."""
    logits, _, aux = jtf.lm_forward(jp, jnp.asarray(toks), jcfg)
    last, cache = jtf.lm_prefill(jp, jnp.asarray(toks), jcfg, max_len=toks.shape[1] + steps)
    prefill = (np.asarray(last), jax.tree_util.tree_map(np.asarray, cache))
    decode = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(p, c, t, pos, jcfg,
                                                             mla_absorb=mla_absorb))
    tok = jnp.argmax(last[:, -1], -1).astype(jnp.int32)
    feed, steps_out = [], []
    for t in range(steps):
        feed.append(np.asarray(tok))
        lg, cache = decode(jp, cache, tok[:, None], jnp.int32(toks.shape[1] + t))
        steps_out.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    return {"logits": np.asarray(logits), "aux": float(aux), "prefill": prefill,
            "feed": feed, "decode": steps_out,
            "cache": jax.tree_util.tree_map(np.asarray, cache)}


def _leaves(tree):
    """(stack/name, array) of a cache tree, sorted."""
    return [(f"{a}/{b}", tree[a][b]) for a in sorted(tree) for b in sorted(tree[a])]


def _same_caches(got, want):
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, name)


@pytest.fixture(scope="module")
def models():
    """arch -> (port model, tokens, JAX's reference), computed once
    (deepseek-v3 also under "deepseek-v3-671b/absorb": JAX's absorbed
    decode)."""
    out = {}
    for i, arch in enumerate(LM_ARCHS):
        jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        jp = jparams.init_params(jax.random.PRNGKey(i), jtf.lm_decls(jcfg))
        model = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                           device="cpu")
        toks = _tokens(10 + i, jcfg.vocab_size)
        out[arch] = (model, toks, _reference(jcfg, jp, toks))
        if tcfg.attention == "mla":
            out[arch + "/absorb"] = (model, toks, _reference(jcfg, jp, toks,
                                                             mla_absorb=True))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_matches_jax(models, arch):
    model, toks, ref = models[arch]
    with torch.no_grad():
        logits, h, aux = ttf.lm_forward(model, torch.as_tensor(toks), model.cfg)
    _close(logits, ref["logits"])
    assert h.shape == (B, S, model.cfg.d_model)
    assert float(aux) == pytest.approx(ref["aux"], rel=RTOL)
    assert (float(aux) > 0) == model.cfg.moe
    with torch.no_grad():
        assert torch.equal(model(torch.as_tensor(toks)), logits)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_padded_cache_match_jax(models, arch):
    model, toks, ref = models[arch]
    last, cache = tsteps.make_prefill_step(model.cfg, max_len=S + DECODE)(
        model, torch.as_tensor(toks))
    _close(last, ref["prefill"][0])
    _same_caches(cache, ref["prefill"][1])
    for _, got in _leaves(cache):
        assert not got[:, :, S:].any()  # the padding is zeros


def _decode_matches(models, key, mla_absorb):
    """8 decode steps through the cache, each fed JAX's greedy token: the
    logits of every step and the final cache; ``make_decode_step``'s
    greedy tokens are JAX's."""
    model, toks, ref = models[key]
    _, cache = tsteps.make_prefill_step(model.cfg, max_len=S + DECODE)(
        model, torch.as_tensor(toks))
    decode = tsteps.make_decode_step(model.cfg, mla_absorb=mla_absorb)
    for t in range(DECODE):
        with torch.inference_mode():
            lg, _ = ttf.lm_decode_step(model, cache, torch.tensor(ref["feed"][t][:, None]),
                                       S + t, model.cfg, mla_absorb=mla_absorb)
        _close(lg, ref["decode"][t], f"step {t}")
        nxt = np.argmax(ref["decode"][t][:, -1], -1)
        if t + 1 < DECODE:
            np.testing.assert_array_equal(nxt, ref["feed"][t + 1])
    _same_caches(cache, ref["cache"])
    # the greedy step from a fresh prefill gives JAX's tokens
    _, cache = tsteps.make_prefill_step(model.cfg, max_len=S + DECODE)(
        model, torch.as_tensor(toks))
    tok = torch.tensor(ref["feed"][0])
    for t in range(DECODE - 1):
        tok, cache = decode(model, cache, tok[:, None], S + t)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), ref["feed"][t + 1])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_steps_match_jax(models, arch):
    _decode_matches(models, arch, mla_absorb=False)


def test_mla_absorbed_decode_matches_jax(models):
    """deepseek-v3's decode with ``mla_absorb=True`` (W_uk folded into the
    query, W_uv into the output) against JAX's absorbed decode."""
    _decode_matches(models, "deepseek-v3-671b/absorb", mla_absorb=True)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_is_prefill_then_greedy_decode(models, arch):
    model, toks, ref = models[arch]
    out = model.generate(torch.as_tensor(toks), DECODE - 1)
    assert out.shape == (B, DECODE) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.stack(ref["feed"], axis=1))
    if model.cfg.attention == "mla":
        _, _, ref = models[arch + "/absorb"]
        out = model.generate(torch.as_tensor(toks), DECODE - 1, mla_absorb=True)
        np.testing.assert_array_equal(out.numpy(), np.stack(ref["feed"], axis=1))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_chunked_attention_matches_jax_chunked(arch, monkeypatch):
    """CHUNK_THRESHOLD / CHUNK_SIZE at 16 / 8 in both packages: a 32-token
    forward and prefill take the online-softmax path (4 chunks)."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "CHUNK_SIZE", 8)
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jparams.init_params(jax.random.PRNGKey(7), jtf.lm_decls(jcfg))
    model = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                       device="cpu")
    toks = _tokens(3, jcfg.vocab_size, s=32)
    calls = []
    inner = tattn._chunked_causal
    monkeypatch.setattr(tattn, "_chunked_causal",
                        lambda *a, **k: calls.append(a[2]) or inner(*a, **k))
    with torch.no_grad():
        logits, _, _ = ttf.lm_forward(model, torch.as_tensor(toks), tcfg)
    assert calls == [4] * tcfg.num_layers
    _close(logits, jtf.lm_forward(jp, jnp.asarray(toks), jcfg)[0])
    jlast, jcache = jtf.lm_prefill(jp, jnp.asarray(toks), jcfg, max_len=40)
    last, cache = tsteps.make_prefill_step(tcfg, max_len=40)(model, torch.as_tensor(toks))
    _close(last, jlast)
    _same_caches(cache, jax.tree_util.tree_map(np.asarray, jcache))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["ascending", "shuffled"])
def test_chunked_causal_matches_jax(dtype, order):
    """``_chunked_causal`` alone on random q / k / v: ascending positions
    skip the query rows wholly before a chunk (an exact identity in JAX's
    scan), shuffled positions compute every row; bf16 tiles as JAX's."""
    rng = np.random.default_rng(11)
    Bq, Sq, KV, G, Dh, C = 2, 24, 2, 3, 8, 8
    q = rng.normal(size=(Bq, Sq, KV, G, Dh)).astype(np.float32) * 0.5
    k = rng.normal(size=(Bq, Sq, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, KV, Dh)).astype(np.float32)
    pos = np.arange(Sq) if order == "ascending" else rng.permutation(Sq)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    ref = jattn._chunked_causal(jq, lambda c: (jax.lax.dynamic_slice_in_dim(jk, c * C, C, 1),
                                               jax.lax.dynamic_slice_in_dim(jv, c * C, C, 1)),
                                Sq // C, C, jnp.asarray(pos), jdt)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    out = tattn._chunked_causal(tq, lambda c: (tk[:, c * C:(c + 1) * C], tv[:, c * C:(c + 1) * C]),
                                Sq // C, C, torch.as_tensor(pos), tdt)
    assert out.dtype == tdt
    tol = RTOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_smollm_published_widths_two_layers_match_jax():
    """smollm-135m at its published widths (d 576, 9 / 3 heads, vocab
    49 152) with 2 layers, f32 activations: forward, prefill and 2 decode
    steps, B = 1, S = 32."""
    jcfg = dataclasses.replace(jconfigs.get("smollm-135m"), num_layers=2, dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get("smollm-135m"), num_layers=2, dtype="float32")
    jp = jparams.init_params(jax.random.PRNGKey(5), jtf.lm_decls(jcfg))
    model = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                       device="cpu")
    toks = _tokens(6, jcfg.vocab_size, b=1, s=32)
    ref = _reference(jcfg, jp, toks, steps=2)
    with torch.no_grad():
        _close(ttf.lm_forward(model, torch.as_tensor(toks), tcfg)[0], ref["logits"])
    last, cache = tsteps.make_prefill_step(tcfg, max_len=34)(model, torch.as_tensor(toks))
    _close(last, ref["prefill"][0])
    for t in range(2):
        with torch.inference_mode():
            lg, cache = ttf.lm_decode_step(model, cache, torch.tensor(ref["feed"][t][:, None]),
                                           32 + t, tcfg)
        _close(lg, ref["decode"][t])


def test_decode_equals_forward_under_teacher_forcing():
    """The port's own twin of tests/test_models.py's decode == forward, at
    rtol / atol 1e-5 (f32, smollm REDUCED): every position's logits through
    the cache equal the full forward's."""
    cfg = tconfigs.get_reduced("smollm-135m")
    model = ttf.LMModel.build(cfg, device="cpu")
    toks = torch.as_tensor(_tokens(8, cfg.vocab_size, s=10))
    with torch.inference_mode():
        full = model(toks)
        cache = ttf.init_cache(cfg, 2, 10, device="cpu")
        steps = [ttf.lm_decode_step(model, cache, toks[:, t:t + 1], t, cfg)[0][:, 0]
                 for t in range(10)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_jax(arch):
    for get_j, get_t in ((jconfigs.get, tconfigs.get),
                         (jconfigs.get_reduced, tconfigs.get_reduced)):
        jd, td = jtf.lm_decls(get_j(arch)), ttf.lm_decls(get_t(arch))
        assert tparams.param_count(td) == jparams.param_count(jd)
        assert tparams.param_bytes(td) == jparams.param_bytes(jd)
        flat = jax.tree_util.tree_flatten_with_path(jd, is_leaf=jparams.is_param)[0]
        want = [(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                 p.shape) for path, p in flat]
        assert [(path, p.shape) for path, p in tparams.leaves(td)] == want


@pytest.mark.parametrize("vocab,seq,batch,hosts", [(512, 16, 4, 1), (49152, 64, 8, 2),
                                                   (256000, 33, 3, 3)])
def test_token_stream_matches_jax(vocab, seq, batch, hosts):
    for host in range(hosts):
        for seed in (0, 3):
            js = JTokenStream(vocab, seq, batch, seed=seed, host_id=host, num_hosts=hosts)
            ts = TokenStream(vocab, seq, batch, seed=seed, host_id=host, num_hosts=hosts)
            assert ts.local_batch == js.local_batch
            for step in (0, 1, 65):
                got, want = ts.batch(step)["tokens"], js.batch(step)["tokens"]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gemma", [False, True])
def test_norms_match_jax(gemma):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3
    w, b = rng.normal(size=24).astype(np.float32), rng.normal(size=24).astype(np.float32)
    _close(tlayers.rms_norm(torch.as_tensor(x), torch.as_tensor(w), eps=1e-5,
                            gemma_style=gemma),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5, gemma_style=gemma))
    _close(tlayers.layer_norm(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert tlayers.rms_norm(xb, torch.as_tensor(w), gemma_style=gemma).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rotary_matches_jax(theta):
    pos = np.array([0, 1, 5, 100, 4095], np.int32)
    s, c = tlayers.rotary_embedding(torch.as_tensor(pos), 16, theta=theta)
    js, jc = jlayers.rotary_embedding(jnp.asarray(pos), 16, theta=theta)
    _close(s, js)
    _close(c, jc)
    x = np.random.default_rng(2).normal(size=(2, 5, 3, 16)).astype(np.float32)
    _close(tlayers.apply_rotary(torch.as_tensor(x), s, c),
           jlayers.apply_rotary(jnp.asarray(x), js, jc))


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_glu_mlp_matches_jax(activation):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 40)).astype(np.float32) * 0.25 for _ in range(2))
    wd = rng.normal(size=(40, 16)).astype(np.float32) * 0.2
    _close(tlayers.glu_mlp(*(torch.as_tensor(a) for a in (x, wg, wu, wd)),
                           activation=activation),
           jlayers.glu_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                           activation=activation))
    with pytest.raises(ValueError):
        tlayers.glu_mlp(*(torch.as_tensor(a) for a in (x, wg, wu, wd)), activation="relu")


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    got = tlayers.softmax_cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                        None if mask is None else torch.as_tensor(mask))
    want = jlayers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                         None if mask is None else jnp.asarray(mask))
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def test_lm_model_names_and_converter_checks_shapes():
    cfg = tconfigs.get_reduced("gemma-2b")
    model = ttf.LMModel.build(cfg, device="cpu")
    names = [path for path, _ in tparams.leaves(ttf.lm_decls(cfg))]
    assert sorted(dict(model.named_parameters())) == sorted(names)
    tree = model.tree()
    assert tree["dense_blocks"]["attn"]["wq"].shape == (2, 64, 4, 32)
    bad = jax.tree_util.tree_map(np.asarray, jparams.init_params(
        jax.random.PRNGKey(0), jtf.lm_decls(jconfigs.get_reduced("gemma-2b"))))
    bad["dense_blocks"]["attn"]["wo"] = bad["dense_blocks"]["attn"]["wo"].transpose(0, 3, 1, 2)
    with pytest.raises(ValueError, match="dense_blocks.attn.wo"):
        convert.lm_params_from_jax(bad, cfg, device="cpu")


def test_serve_step_refuses_the_lm_family_as_jax():
    cfg = tconfigs.get_reduced("smollm-135m")
    with pytest.raises(KeyError):
        jsteps.make_serve_step(jconfigs.get_reduced("smollm-135m"), "lm")
    with pytest.raises(KeyError, match="no serve step"):
        tsteps.make_serve_step(cfg, "lm")


ALL_ARCHS = sorted(jconfigs.ARCHS)


def test_registry_matches_jax():
    assert sorted(tconfigs.ARCHS) == ALL_ARCHS
    assert tconfigs.FAMILY == jconfigs.FAMILY


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        out[f.name] = _fields(value) if dataclasses.is_dataclass(value) else value
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_jax(arch):
    """CONFIG and REDUCED field for field as JAX's (``infinity-search``'s
    are ``IndexConfig``s of ``repro_torch.core.search``: the twin of
    tests/test_models.py's registry test)."""
    for get_j, get_t in ((jconfigs.get, tconfigs.get),
                         (jconfigs.get_reduced, tconfigs.get_reduced)):
        jc, tc = get_j(arch), get_t(arch)
        want = _fields(jc)
        got = _fields(tc)
        if arch == "infinity-search":
            assert type(tc).__module__ == "repro_torch.core.search"
            want = {k: v for k, v in want.items() if k in got}
        assert got == want
    assert tconfigs.family(arch) == jconfigs.family(arch)
    if tconfigs.family(arch) == "lm":
        cfg = tconfigs.get(arch)
        assert cfg.act_dtype() == getattr(torch, cfg.dtype)
        assert cfg.pdtype() == torch.float32


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_converter_carries_the_moe_mla_and_mtp_trees(arch):
    """``convert.lm_params_from_jax`` on the MoE trees (router, stacked
    experts, the shared expert) and MLA's (deepseek-v3, with its ``mtp``
    projection and block): every leaf under JAX's path, equal."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jax.tree_util.tree_map(np.asarray, jparams.init_params(
        jax.random.PRNGKey(4), jtf.lm_decls(jcfg)))
    model = convert.lm_params_from_jax(jp, tcfg, device="cpu")
    got = dict(model.named_parameters())
    want = {".".join(str(k.key) for k in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(got) == sorted(want)
    assert ("mtp.proj" in got) == tcfg.mtp and ("moe_blocks.mlp.router" in got)
    for name, a in want.items():
        assert torch.equal(got[name].detach(), torch.tensor(a)), name
