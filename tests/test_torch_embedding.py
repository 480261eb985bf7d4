"""Port parity: ``core/embedding`` (Phi, losses, nanmedian) and
``train/optimizer`` (global-norm clipping + AdamW) against the JAX package,
on the CPU.  Phi with JAX parameters loaded agrees to 1e-5; the optimizer
step agrees to f32 rounding."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import embedding as jemb  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import phi_from_params  # noqa: E402
from repro_torch.core import embedding as temb  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from torch_parity import to_np  # noqa: E402

CPU = torch.device("cpu")


def _jax_params(in_dim=12, hidden=(16, 16), out_dim=4, seed=0, normalisers=True):
    cfg = jemb.EmbedConfig(in_dim=in_dim, out_dim=out_dim, hidden=hidden)
    params = jemb.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        layer["b"] = jnp.asarray(rng.normal(size=layer["b"].shape).astype(np.float32) * 0.1)
    if normalisers:
        params["x_mean"] = jnp.asarray(rng.normal(size=in_dim).astype(np.float32))
        params["x_std"] = jnp.asarray(rng.uniform(0.5, 2, size=in_dim).astype(np.float32))
        params["d_scale"] = jnp.float32(1.7)
    return params


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("normalisers", [True, False])
def test_apply_with_jax_params(normalisers):
    params = _jax_params(normalisers=normalisers)
    x = np.random.default_rng(1).normal(size=(30, 12)).astype(np.float32)
    phi = phi_from_params(_np_params(params), CPU)
    out = temb.apply(phi, torch.as_tensor(x))
    np.testing.assert_allclose(to_np(out), np.asarray(jemb.apply(params, jnp.asarray(x))),
                               atol=1e-5)
    assert phi.layers[0].weight.shape == (16, 12)  # (dout, din): JAX's w transposed


@pytest.mark.parametrize("normalisers", [True, False])
def test_params_tree_form_equals_the_module(normalisers):
    """The sharded engine runs Phi from its params tree (``params_of`` /
    ``apply_params``); the unsharded one runs the module.  Both must give
    the same bits, or sharded answers drift from unsharded ones."""
    params = _jax_params(normalisers=normalisers)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(30, 12)).astype(np.float32))
    phi = phi_from_params(_np_params(params), CPU)
    tree = temb.params_of(phi)
    assert ("x_mean" in tree) == normalisers
    assert tree["layers"][0]["w"].shape == (12, 16)  # JAX's (din, dout)
    assert torch.equal(temb.apply_params(tree, x), temb.apply(phi, x))


def test_gelu_is_the_tanh_form():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    out = torch.nn.functional.gelu(torch.as_tensor(x), approximate="tanh")
    np.testing.assert_allclose(to_np(out), ref, atol=1e-6)


@pytest.mark.parametrize("values", [
    [1.0, 2.0, 3.0, 4.0],
    [4.0, np.nan, 1.0, 3.0, 2.0, np.nan],
    [5.0, 1.0, 3.0],
    [np.nan, 2.0],
    [np.nan, np.nan],
    [7.0],
])
def test_nanmedian_averages_the_middle_pair(values):
    x = np.asarray(values, np.float32)
    ref = float(jnp.nanmedian(jnp.asarray(x)))
    out = float(temb.nanmedian(torch.as_tensor(x)))
    if math.isnan(ref):
        assert math.isnan(out)
    else:
        assert out == ref


def test_nanmedian_even_count_differs_from_torch_nanmedian():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(temb.nanmedian(x)) == 2.5 and float(torch.nanmedian(x)) == 2.0


@pytest.mark.parametrize("weight", ["none", "sammon"])
def test_stress_loss_matches_jax(weight):
    params = _jax_params(normalisers=False)
    rng = np.random.default_rng(2)
    xi = rng.normal(size=(64, 12)).astype(np.float32)
    xj = rng.normal(size=(64, 12)).astype(np.float32)
    dij = rng.uniform(0.1, 3, size=64).astype(np.float32)
    dij[::7] = np.inf
    ref = jemb.stress_loss(params, jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(dij),
                           weight=weight)
    phi = phi_from_params(_np_params(params), CPU)
    out = temb.stress_loss(phi, torch.as_tensor(xi), torch.as_tensor(xj),
                           torch.as_tensor(dij), weight=weight)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)


@pytest.mark.parametrize("q", [4.0, math.inf])
def test_triangle_loss_matches_jax(q):
    params = _jax_params(normalisers=False)
    rng = np.random.default_rng(3)
    x, y, z = (rng.normal(size=(32, 12)).astype(np.float32) for _ in range(3))
    ref = jemb.triangle_loss(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), q)
    phi = phi_from_params(_np_params(params), CPU)
    out = temb.triangle_loss(phi, torch.as_tensor(x), torch.as_tensor(y),
                             torch.as_tensor(z), q)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5, atol=1e-7)


def _grads(shapes, seed, scale):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("scale", [1e-3, 10.0])  # below / above the clip norm
def test_adamw_steps_match_jax(scale):
    shapes = [(5, 3), (3,), (4,)]
    p0 = _grads(shapes, 0, 1.0)
    jopt_ = jopt.adamw(1e-3, weight_decay=1e-5)
    topt_ = topt.adamw(1e-3, weight_decay=1e-5)
    jp, tp = list(map(jnp.asarray, p0)), [torch.as_tensor(p) for p in p0]
    js, ts = jopt_.init(jp), topt_.init(tp)
    for step in range(3):
        g = _grads(shapes, 10 + step, scale)
        jp, js = jopt_.update(list(map(jnp.asarray, g)), js, jp)
        tp, ts = topt_.update([torch.as_tensor(x) for x in g], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 3


def test_clip_by_global_norm_matches_jax():
    g = _grads([(6, 2), (7,)], 4, 3.0)
    tg, tn = topt.clip_by_global_norm([torch.as_tensor(x) for x in g], 1.0)
    jg, jn = jopt.clip_by_global_norm(list(map(jnp.asarray, g)), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6)
    assert abs(float(topt.global_norm(tg)) - 1.0) < 1e-5


def test_train_embedding_fits_and_attaches_normalisers():
    X = torch.as_tensor(synthetic.make("manifold", 200, seed=2))
    D = torch.cdist(X, X)
    D[torch.rand(200, 200, generator=torch.Generator().manual_seed(0)) < 0.05] = math.inf
    D.fill_diagonal_(0.0)
    cfg = temb.EmbedConfig(in_dim=X.shape[1], out_dim=8, hidden=(32,), steps=120,
                           batch_pairs=256, dropout=0.0)
    knn = torch.topk(torch.where(torch.isinf(D), 1e9, D) + torch.eye(200) * 1e9, 5,
                     largest=False).indices
    phi, hist = temb.train_embedding(X, D, cfg, knn_idx=knn, log_every=40)
    losses = [v for _, v in hist["loss"]]
    assert losses[-1] < 0.5 * losses[0]
    assert phi.x_mean is not None and phi.x_std is not None and phi.d_scale is not None
    finite = torch.isfinite(D) & ~torch.eye(200, dtype=torch.bool)
    ref_scale = float(jnp.nanmedian(jnp.asarray(np.where(to_np(finite), to_np(D), np.nan))))
    assert float(phi.d_scale) == pytest.approx(ref_scale, rel=1e-6)
    Z = temb.apply(phi, X)
    assert Z.shape == (200, 8) and torch.isfinite(Z).all()
