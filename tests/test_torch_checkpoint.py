"""Port parity: checkpoints (``repro_torch.train.checkpoint``) and the fault
supervisor (``repro_torch.train.fault``) against the JAX package, on the
CPU.

The port's twins of ``tests/test_substrate.py``'s checkpoint tests (round
trip, ``LATEST`` and GC, integrity, the async saver, shape mismatch), then
both directions between the packages: a JAX-written ``(params,
AdamWState / AdafactorState / sgd state)`` restored by the port and the
port's restored by JAX, every leaf equal bit for bit and every sha
verified on restore.  The supervisor, ``ElasticPlan`` and ``Heartbeat``
are driven with the same inputs as JAX's and must give the same verdicts.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import fault as tfault  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import tree as tree_lib  # noqa: E402


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)},
    }


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"note": "x"})
    restored, step = ckpt.restore(str(tmp_path), t, device="cpu")
    assert step == 7
    assert torch.equal(restored["w"], t["w"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])
    man = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert man["extra"] == {"note": "x"}
    assert [e["path"] for e in man["leaves"]] == ["['nested']/['b']", "['w']"]


def test_checkpoint_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.garbage_collect(str(tmp_path), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "nothing")) is None


def test_checkpoint_integrity_detection(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 1, t)
    leaf = os.path.join(path, "leaf_00000.npy")
    data = open(leaf, "rb").read()
    open(leaf, "wb").write(data[:-4] + b"\x00\x00\x00\x01")
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), t, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), t, device="cpu")


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30):
        saver.save(s, t)
        t = {"w": t["w"] + 1, "nested": t["nested"]}  # the next step's tree
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 30
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_00000020", "step_00000030"]
    restored, _ = ckpt.restore(str(tmp_path), t, step=20, device="cpu")
    assert torch.equal(restored["w"], torch.arange(12.0).reshape(3, 4) + 1)


def test_async_checkpointer_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker / "ck"))
    saver.save(1, _tree())
    with pytest.raises(OSError):
        saver.wait()


def test_restore_shape_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = {"w": torch.zeros((2, 2)), "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)}}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad, device="cpu")


def test_restore_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path), t)


def _jax_state(opt_name, seed=0):
    cfg = jconfigs.get_reduced("xdeepfm")
    params = jparams.init_params(jax.random.PRNGKey(seed), jrecsys.recsys_decls(cfg))
    params["table"] = params["table"] + 1.0  # no two leaves alike
    opt = {"adamw": jopt.adamw(), "adafactor": jopt.adafactor(),
           "sgd": jopt.sgd(momentum=0.9)}[opt_name]
    state = opt.init(params)
    # one update, so the moments and the step are not all zero
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    params, state = opt.update(grads, state, params)
    return cfg, params, state


def _port_target(opt_name):
    cfg = tconfigs.get_reduced("xdeepfm")
    params = tparams.map_decls(lambda _, p: torch.zeros(p.shape),
                               trecsys.recsys_decls(cfg))
    opt = {"adamw": topt.adamw(), "adafactor": topt.adafactor(),
           "sgd": topt.sgd(momentum=0.9)}[opt_name]
    return (params, opt.init(params))


def _leaves_equal(port_tree, jax_tree):
    p = tree_lib.paths(port_tree)
    j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [k for k, _ in p] == ["/".join(str(x) for x in path) for path, _ in j]
    for (key, a), (_, b) in zip(p, j):
        b = np.asarray(b)
        if isinstance(a, int):
            assert a == int(b) and b.dtype == np.int32, key
        else:
            assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b), key


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, opt_name):
    _, params, state = _jax_state(opt_name)
    jckpt.save(str(tmp_path), 3, (params, state))
    restored, step = ckpt.restore(str(tmp_path), _port_target(opt_name), device="cpu")
    assert step == 3
    _leaves_equal(restored, (params, state))
    assert restored[1][0] == 1  # the step, a host int


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt_name):
    _, params, state = _jax_state(opt_name, seed=1)
    tp = tree_lib.tree_map(lambda a: torch.tensor(np.asarray(a)),
                           jax.tree_util.tree_map(np.asarray, params))
    tstate = convert.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, state),
                                        device="cpu")
    ckpt.save(str(tmp_path), 9, (tp, tstate))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, (params, state))
    (jp, js), step = jckpt.restore(str(tmp_path), zeros)
    assert step == 9
    _leaves_equal((tp, tstate), (jp, js))
    # and the manifests of the two packages name the same files and shas
    jckpt.save(str(tmp_path / "jax"), 9, (params, state))
    mine = json.load(open(tmp_path / "step_00000009" / "manifest.json"))["leaves"]
    theirs = json.load(open(tmp_path / "jax" / "step_00000009" / "manifest.json"))["leaves"]
    assert mine == theirs


def test_bf16_leaves_cross_both_ways(tmp_path):
    j = {"w": jnp.linspace(-2, 2, 12, dtype=jnp.bfloat16).reshape(3, 4)}
    jckpt.save(str(tmp_path / "a"), 1, j)
    t, _ = ckpt.restore(str(tmp_path / "a"), {"w": torch.zeros((3, 4), dtype=torch.bfloat16)},
                        device="cpu")
    assert t["w"].dtype == torch.bfloat16
    assert np.array_equal(t["w"].view(torch.int16).numpy(),
                          np.asarray(j["w"]).view(np.int16))
    ckpt.save(str(tmp_path / "b"), 1, t)
    back, _ = jckpt.restore(str(tmp_path / "b"), j)
    assert back["w"].dtype == jnp.bfloat16 and np.array_equal(np.asarray(back["w"]),
                                                              np.asarray(j["w"]))


def test_supervisor_verdicts_match_jax():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.9, 1.1, size=40))
    times[12:16] = [5.0, 5.0, 5.0, 1.0]
    times[30] = 7.0
    losses = [0.5, np.nan, 0.4, np.inf, np.nan, np.nan, 0.3, np.nan, 0.2]
    for cfg in ({}, {"deadline_factor": 2.0, "window": 8, "max_stragglers": 2,
                     "max_nan_skips": 2}):
        js, ts = jfault.Supervisor(jfault.SupervisorConfig(**cfg)), \
            tfault.Supervisor(tfault.SupervisorConfig(**cfg))
        assert [ts.observe_step_time(t) for t in times] == \
            [js.observe_step_time(t) for t in times]
        assert [ts.observe_loss(x) for x in losses] == [js.observe_loss(x) for x in losses]
        assert (ts.restarts, ts.straggler_run, ts.nan_run) == \
            (js.restarts, js.straggler_run, js.nan_run)


def test_elastic_plan_and_heartbeat_match_jax(monkeypatch):
    jp, tp = jfault.ElasticPlan(), tfault.ElasticPlan()
    assert tp.current_shape() == jp.current_shape()
    assert tp.shrink() == jp.shrink()
    with pytest.raises(RuntimeError):
        tp.shrink()
    clock = [100.0]
    monkeypatch.setattr(tfault.time, "monotonic", lambda: clock[0])
    hb = tfault.Heartbeat(timeout_s=10.0)
    hb.ping("loader")
    hb.ping("ckpt")
    clock[0] = 105.0
    hb.ping("ckpt")
    assert hb.dead() == []
    clock[0] = 112.0
    assert hb.dead() == ["loader"]
