"""Port parity: the MoE pieces (``models/moe.py``) and MLA attention
(``models/attention.mla_attention``) against the JAX package, on the CPU
at the ``REDUCED`` configs with f32 activations.

The same numpy inputs go to both: JAX's ``init_params`` weights for one
layer (converted for the port, nothing transposed), activations and
probabilities from numpy.  Tolerances: router probabilities, weights, aux
losses and the FFN / attention outputs rtol / atol 1e-5 (the same f32
products, summed in another order); expert choices, slot maps and
capacity drops equal.  The dispatch (``moe_ffn_dispatch``) is held to the
dense path at 1e-5 too: each token's k expert outputs are added in
another order than the dense path's sum over all E.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

RTOL = ATOL = 1e-5
MOE_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v3-671b"]


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _layers(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, port model) at REDUCED."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = jparams.init_params(jax.random.PRNGKey(seed), jtf.lm_decls(jcfg))
    model = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                       device="cpu")
    return jcfg, tcfg, jp, model


def _first(tree):
    """Layer 0 of a stacked block subtree, JAX (dict of arrays) or port."""
    if hasattr(tree, "keys"):
        return {k: _first(tree[k]) for k in tree.keys()}
    return tree[0]


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("ties", [False, True])
def test_router_topk_and_aux_match_jax(arch, ties):
    """softmax (qwen3) and sigmoid (deepseek-v3) routers: probabilities,
    the top-k weights and experts, and the load-balance loss.  With ties,
    the probabilities take four values, so most rows hold equal ones at
    the k-th place: both packages pick the lowest index first."""
    jcfg, tcfg, jp, model = _layers(arch)
    wr = np.array(jp["moe_blocks"]["mlp"]["router"][0])
    x = _x(1, (3, 7, tcfg.d_model))
    jprobs = jmoe.router_probs(jnp.asarray(x), jnp.asarray(wr), jcfg)
    tprobs = tmoe.router_probs(torch.as_tensor(x), torch.as_tensor(wr), tcfg)
    _close(tprobs, jprobs)
    probs = np.array(jprobs)
    if ties:
        probs = (np.random.default_rng(2).integers(1, 5, size=probs.shape) / 8).astype(
            np.float32)
    jw, ji = jmoe.topk_weights(jnp.asarray(probs), jcfg)
    tw, ti = tmoe.topk_weights(torch.as_tensor(probs), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _, jtop = jax.lax.top_k(jnp.asarray(probs), jcfg.num_experts_per_tok)
    aux = tmoe.load_balance_loss(torch.as_tensor(probs), ti, tcfg)
    assert float(aux) == pytest.approx(
        float(jmoe.load_balance_loss(jnp.asarray(probs), jtop, jcfg)), rel=RTOL)


@pytest.mark.parametrize("C,eo,E_loc", [(2, 0, 8), (3, 2, 4), (5, 4, 4), (40, 0, 8)])
def test_slot_maps_match_jax_where_capacity_drops(C, eo, E_loc):
    """``_slot_maps`` at capacities that drop assignments (C = 2, 3, 5 of
    24 tokens x 2 experts over 8) and one that keeps them all, over all
    experts and over a local slice (eo, E_loc): the source token and
    weight of every slot equal JAX's."""
    cfg = tconfigs.get_reduced("qwen3-moe-235b-a22b")
    T, k = 24, cfg.num_experts_per_tok
    probs = np.random.default_rng(3).random((T, cfg.num_experts)).astype(np.float32)
    jw, ji = jmoe.topk_weights(jnp.asarray(probs), jconfigs.get_reduced(
        "qwen3-moe-235b-a22b"))
    jtok, jslot = jmoe._slot_maps(ji, jw, eo, E_loc, C, T, k, jnp.float32)
    tw, ti = tmoe.topk_weights(torch.as_tensor(probs), cfg)
    ttok, tslot = tmoe._slot_maps(ti, tw, eo, E_loc, C, T, k, torch.float32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tslot, jslot)
    loads = np.bincount(ti.numpy().ravel(), minlength=cfg.num_experts)[eo:eo + E_loc]
    assert int((ttok < T).sum()) == int(np.minimum(loads, C).sum())
    assert (loads > C).any() == (C < 40)  # the small capacities drop


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_dense_matches_jax(arch):
    jcfg, tcfg, jp, model = _layers(arch)
    jl, tl = _first(jp["moe_blocks"]["mlp"]), _first(model["moe_blocks"]["mlp"])
    x = _x(4, (2, 9, tcfg.d_model))
    probs = np.array(jmoe.router_probs(jnp.asarray(x), jl["router"], jcfg))
    ref = jmoe.moe_ffn_dense(jnp.asarray(x), jnp.asarray(probs), jl, jcfg)
    with torch.no_grad():
        out = tmoe.moe_ffn_dense(torch.as_tensor(x), torch.as_tensor(probs), tl, tcfg)
    _close(out, ref)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("chunk,group", [(32768, 32), (5, 3)])
def test_dispatch_matches_dense(arch, chunk, group, monkeypatch):
    """``moe_ffn_dispatch`` against the dense path (the port's and JAX's)
    on one MoE layer, whole and in chunks of 5 tokens with experts in
    groups of 3; the ``_moe_ffn`` of the transformer (router, aux, shared
    expert) against JAX's."""
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", chunk)
    monkeypatch.setattr(tmoe, "EXPERT_GROUP", group)
    jcfg, tcfg, jp, model = _layers(arch, seed=1)
    jl, tl = _first(jp["moe_blocks"]["mlp"]), _first(model["moe_blocks"]["mlp"])
    x = _x(5, (3, 11, tcfg.d_model))
    tx = torch.as_tensor(x)
    with torch.no_grad():
        probs = tmoe.router_probs(tx, tl["router"], tcfg)
        top_w, top_i = tmoe.topk_weights(probs, tcfg)
        out = tmoe.moe_ffn_dispatch(tx, top_w, top_i, tl, tcfg)
        dense = tmoe.moe_ffn_dense(tx, probs, tl, tcfg)
        full, aux = ttf._moe_ffn(tl, tx, tcfg)
    _close(out, dense.numpy())
    _close(out, jmoe.moe_ffn_dense(jnp.asarray(x), jnp.asarray(probs.numpy()), jl, jcfg))
    jfull, jaux = jtf._moe_ffn(jl, jnp.asarray(x), jcfg, None)
    _close(full, jfull)
    assert float(aux) == pytest.approx(float(jaux), rel=RTOL)


def test_routed_scaling_is_one_in_both_packages():
    """Pins the reference finding (ROADMAP Queue 3): ``topk_weights`` reads
    ``getattr(cfg, "routed_scaling", 1.0)`` and ``LMConfig`` has no such
    field, so DeepSeek-V3's routing weights sum to 1 per token in JAX
    (its config's docstring promises a routed scaling of 2.5), and the
    port's equal them."""
    jcfg = jconfigs.get_reduced("deepseek-v3-671b")
    tcfg = tconfigs.get_reduced("deepseek-v3-671b")
    assert not hasattr(jcfg, "routed_scaling") and not hasattr(tcfg, "routed_scaling")
    probs = np.random.default_rng(6).random((4, 6, jcfg.num_experts)).astype(np.float32)
    jw, _ = jmoe.topk_weights(jnp.asarray(probs), jcfg)
    tw, _ = tmoe.topk_weights(torch.as_tensor(probs), tcfg)
    np.testing.assert_allclose(np.asarray(jw).sum(-1), 1.0, rtol=1e-6)
    _close(tw, jw)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla():
    jcfg, tcfg, jp, model = _layers("deepseek-v3-671b", seed=2)
    return jcfg, tcfg, _first(jp["dense_blocks"]["attn"]), _first(
        model["dense_blocks"]["attn"])


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_full_attention_matches_jax(chunked, monkeypatch):
    """The naive branch (S = 12) and the chunked one (CHUNK_THRESHOLD /
    CHUNK_SIZE 16 / 8 in both packages, S = 32: 4 chunks of expanded K/V):
    the output and the returned latent cache."""
    S = 32 if chunked else 12
    if chunked:
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 16)
            monkeypatch.setattr(mod, "CHUNK_SIZE", 8)
    jcfg, tcfg, jl, tl = _mla()
    x = _x(7, (2, S, tcfg.d_model))
    calls = []
    inner = tattn._chunked_causal
    monkeypatch.setattr(tattn, "_chunked_causal",
                        lambda *a, **k: calls.append(a[2]) or inner(*a, **k))
    ref, rcache = jattn.mla_attention(jl, jnp.asarray(x), jnp.arange(S), jcfg)
    with torch.no_grad():
        out, cache = tattn.mla_attention(tl, torch.as_tensor(x), torch.arange(S), tcfg)
    assert calls == ([4] if chunked else [])
    _close(out, ref)
    for name in ("ckv", "krope"):
        _close(cache[name], rcache[name], name)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(absorb):
    """Decode against a cache of T = 16 positions whose first 10 hold a
    prefilled latent: one step at position 10 (naive: K/V expanded from
    the latent; absorbed: W_uk folded into q, W_uv into the output), the
    cache written in place at that row."""
    jcfg, tcfg, jl, tl = _mla()
    m = tcfg.mla
    B, T, pos = 2, 16, 10
    ckv = np.zeros((B, T, m.kv_lora_rank), np.float32)
    kr = np.zeros((B, T, m.qk_rope_head_dim), np.float32)
    ckv[:, :pos] = _x(8, (B, pos, m.kv_lora_rank))
    kr[:, :pos] = _x(9, (B, pos, m.qk_rope_head_dim))
    x = _x(10, (B, 1, tcfg.d_model))
    ref, rcache = jattn.mla_attention(
        jl, jnp.asarray(x), jnp.asarray([pos]), jcfg,
        cache={"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)},
        cache_index=jnp.int32(pos), absorb=absorb)
    cache = {"ckv": torch.tensor(ckv), "krope": torch.tensor(kr)}
    with torch.inference_mode():
        out, got = tattn.mla_attention(tl, torch.as_tensor(x), torch.tensor([pos]), tcfg,
                                       cache=cache, cache_index=pos, absorb=absorb)
    _close(out, ref)
    for name in ("ckv", "krope"):
        assert got[name] is cache[name]  # written in place
        _close(got[name], rcache[name], name)
