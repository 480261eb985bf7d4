"""Port parity: ``ShardedIndex`` — every shard on one device in the port,
one shard per forced host device in JAX, on the CPU.

The port's 2- and 4-shard brute answers equal its 1-shard answer.  JAX's
side runs in ONE module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the style of
``tests/test_index_registry.py``'s sharded tests, plus ``OMP_NUM_THREADS=1``
so the child does not take a thread per core under the tier-1 run).  The
child builds all five engines at S = 2 with an attribute store, saves them
through JAX's ``store`` and records their answers: plain, under a filter,
with an odd budget (the remainder split), with ``shard_alive`` masking
shard 0, and for brute and IVF-Flat with a quant store.  It also records
the budget-remainder scenario at S = 4, a live-over-sharded mutation script
whose compaction carries ``n % shards`` rows into the delta, and its
answers on the snapshots the port wrote before it started.  The port loads
JAX's snapshots and must give JAX's ids and comparisons exactly and its
distances within rtol 1e-5 / atol 5e-4 (``tests/torch_parity.py``).

Quantized brute is built with JAX's ``impl="pallas"`` (its int8 kernel in
interpret mode), whose function the port computes (``tests/test_torch_store.py``).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import chaos as tchaos  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from torch_parity import assert_close, to_np  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"
N, D, B, K = 512, 16, 64, 5
BUDGET = 301  # odd: 150 + 151 over two shards
INF_SMALL = {"proj_sample": 96, "knn_k": 8, "num_hops": 3, "embed_dim": 8,
             "hidden": (32,), "train_steps": 40, "batch_pairs": 128, "rerank": 16}
ENGINES = {
    "brute": ("brute", {}),
    "brute+quant": ("brute", {"impl": "pallas"}),
    "ivf_flat": ("ivf_flat", {"num_clusters": 8, "nprobe": 4}),
    "ivf_flat+quant": ("ivf_flat", {"num_clusters": 8, "nprobe": 4}),
    "ivf_pq": ("ivf_pq", {"num_clusters": 8, "M": 4, "ksub": 16, "nprobe": 4,
                          "rerank": 16}),
    "nsw": ("nsw", {"degree": 8, "ef": 24, "max_steps": 64}),
    "infinity": ("infinity", {"q": math.inf} | INF_SMALL),
}
QUANT = ("brute+quant", "ivf_flat+quant")
FILTER = {"score": {"range": [None, 0.5]}}
# tests/test_index_registry.py's remainder scenario (q = 1: weak pruning,
# so every shard spends its whole share)
REM_CFG = {"q": 1.0, "proj_sample": 120, "knn_k": 8, "num_hops": 4, "embed_dim": 8,
           "hidden": (32,), "train_steps": 60, "batch_pairs": 128, "rerank": 0}
REM_BUDGETS = (2, 21, 33, 50)
LIVE_CAP = 8
PORT_BUILT = ("brute", "ivf_flat", "nsw", "infinity")


def _attrs(n: int) -> dict:
    rng = np.random.default_rng(5)
    return {"score": rng.uniform(size=n).astype(np.float32),
            "cat": [f"c{i % 5}" for i in range(n)]}


def _data():
    X = synthetic.make("manifold", N + B, seed=0)[:, :D].astype(np.float32)
    return X[:N], X[N:]


def _rem_data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(240, 16)).astype(np.float32),
            rng.normal(size=(6, 16)).astype(np.float32))


def _live_script():
    """(op, argument) steps, the same in both packages: deletes, upserts
    and a compaction over 513 alive rows, which carries 1 row (513 % 2)
    into the new generation's delta."""
    rng = np.random.default_rng(9)
    ins = rng.normal(size=(5, D)).astype(np.float32)
    return [("delete", [3, 100, 257]), ("upsert", ins[:4]), ("search", None),
            ("compact", None), ("search", None), ("upsert", ins[4:]),
            ("delete", [1]), ("search", None)]


def _searches(eng, Q, name: str) -> dict:
    """Every recorded search of one engine: {case: (idx, dist, comps)}."""
    out = {"plain": eng.search(Q, k=K), "filter": eng.search(Q, k=K, filter=FILTER),
           "budget": eng.search(Q, k=K, budget=BUDGET),
           "alive": eng.search(Q, k=K, shard_alive=(False, True))}
    if name == "infinity":  # a batch under 64 takes best-first
        out["small"] = eng.search(Q[:16], k=K)
        out["small_budget"] = eng.search(Q[:16], k=K, budget=BUDGET)
    return out


# The JAX child: builds, saves, searches, and searches the port's
# snapshots; writes every answer into one npz.
_CHILD = r"""
import json, math, os, sys
import numpy as np
import jax
assert len(jax.devices()) >= 4, jax.devices()
from repro.core import attrs as jattrs, index as jindex, store as jstore
from repro.core import quant as jquant
sys.path.insert(0, {tests!r})
import test_torch_sharded as spec

root = {root!r}
X, Q = spec._data()
out = {{}}

def put(tag, res):
    out[tag + "/idx"] = np.asarray(res[0])
    out[tag + "/dist"] = np.asarray(res[1])
    out[tag + "/comps"] = np.asarray(res[2])

for name, (key, cfg) in spec.ENGINES.items():
    eng = jindex.build("sharded", X, {{"engine": key, "shards": 2, "engine_cfg": dict(cfg),
                                      "attrs": spec._attrs(spec.N)}})
    if name in spec.QUANT:
        jindex.attach_quant_store(eng, jquant.QuantStore.build(X))
    jstore.save(eng, os.path.join(root, "jax", name))
    for case, res in spec._searches(eng, Q, key).items():
        put(f"{{name}}/{{case}}", res)

Xr, Qr = spec._rem_data()
rem = jindex.build("sharded", Xr, {{"engine": "infinity", "shards": 4,
                                   "engine_cfg": spec.REM_CFG}})
jstore.save(rem, os.path.join(root, "jax", "remainder"))
for b in spec.REM_BUDGETS:
    put(f"rem/{{b}}", rem.search(Qr, k=1, budget=b))

live = jindex.build("live", X, {{"engine": "sharded", "delta_cap": spec.LIVE_CAP,
                               "engine_cfg": {{"engine": "brute", "shards": 2}}}})
jstore.save(live, os.path.join(root, "jax", "live"))
stats = []
for i, (op, arg) in enumerate(spec._live_script()):
    if op == "delete":
        live.delete(arg)
    elif op == "upsert":
        out[f"live/{{i}}/ids"] = np.asarray(live.upsert(arg))
    elif op == "compact":
        out[f"live/{{i}}/remap"] = np.asarray(live.compact())
    else:
        put(f"live/{{i}}", live.search(Q, k=spec.K))
    stats.append(live.stats())

for name in spec.PORT_BUILT:
    eng = jstore.load(os.path.join(root, "port", name))
    for case, res in spec._searches(eng, Q, name).items():
        put(f"port/{{name}}/{{case}}", res)
np.savez(os.path.join(root, "jax_answers.npz"), **out)
with open(os.path.join(root, "live_stats.json"), "w") as f:
    json.dump(stats, f)
print("OK")
"""


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def port_built(data, tmp_path_factory):
    """The port's own S = 2 builds of four engines, saved for JAX."""
    X, _ = data
    root = tmp_path_factory.mktemp("sharded")
    out = {}
    for name in PORT_BUILT:
        key, cfg = ENGINES[name]
        eng = tindex.build("sharded", X, {"engine": key, "shards": 2,
                                          "engine_cfg": dict(cfg),
                                          "attrs": _attrs(N)}, device=CPU)
        tstore.save(eng, str(root / "port" / name))
        out[name] = eng
    return root, out


@pytest.fixture(scope="module")
def jax_run(port_built):
    """Run the JAX child once; returns (root, answers, live stats)."""
    root, _ = port_built
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    script = textwrap.dedent(_CHILD.format(tests=os.path.dirname(__file__),
                                           root=str(root)))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       env=env, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(os.path.join(root, "jax_answers.npz")) as z:
        answers = {k: z[k] for k in z.files}
    with open(os.path.join(root, "live_stats.json")) as f:
        stats = json.load(f)
    return root, answers, stats


def _same(res, answers: dict, tag: str) -> None:
    """Ids and comparisons exactly JAX's, distances within tolerance."""
    np.testing.assert_array_equal(to_np(res[0]), answers[tag + "/idx"], err_msg=tag)
    np.testing.assert_array_equal(to_np(res[2]), answers[tag + "/comps"], err_msg=tag)
    assert_close(res[1], answers[tag + "/dist"])


# ---------------------------------------------------------------- port only

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_brute_equals_one_shard(data, shards):
    X, Q = data
    one = tindex.build("brute", X, {}, device=CPU).search(Q, k=7)
    sh = tindex.build("sharded", X, {"engine": "brute", "shards": shards}, device=CPU)
    res = sh.search(Q, k=7)
    assert torch.equal(res.idx, one.idx) and torch.equal(res.dist, one.dist)
    assert (res.comparisons == N).all()  # the work is summed over shards
    # k past a shard's rows: every shard keeps the scan contract, (+inf, -1)
    wide = sh.search(Q[:4], k=N // shards + 3)
    assert torch.equal(wide.idx, tindex.build("brute", X, {}, device=CPU)
                       .search(Q[:4], k=N // shards + 3).idx)


@pytest.fixture(scope="module")
def one_shard_infinity(data):
    """One infinity index and 1-shard sharded twins over the same rows
    (rerank 0 and 16: the shard takes its rerank from the build)."""
    X, _ = data
    cfg = {"q": math.inf} | INF_SMALL
    one = tindex.build("infinity", X, cfg | {"rerank": 0, "attrs": _attrs(N)}, device=CPU)
    sharded = {r: tindex.build("sharded", X, {"engine": "infinity", "shards": 1,
                                              "engine_cfg": cfg | {"rerank": r},
                                              "attrs": _attrs(N)}, device=CPU)
               for r in (0, 16)}
    return one, sharded


#: route -> (rerank, batch, k), from which auto mode picks that route
ROUTES = {"descend": (0, 8, 1), "beam": (16, B, K), "best_first": (16, 8, K)}


@pytest.mark.parametrize("budget", [None, BUDGET])
@pytest.mark.parametrize("route,filtered", [  # a filter rules descent out
    ("descend", False), ("beam", False), ("beam", True), ("best_first", False),
    ("best_first", True)])
def test_one_shard_infinity_equals_the_index(data, one_shard_infinity, route,
                                             filtered, budget):
    """``shard_search`` and ``search`` share one body: a 1-shard search
    gives the index's ids, distances and comparisons on every route, and
    records the same comparison counters and spans (inside its
    ``shard_dispatch``)."""
    from repro_torch.core import telemetry as telem

    _, Q = data
    rerank, batch, k = ROUTES[route]
    one, sharded = one_shard_infinity
    kw = {"budget": budget, "filter": FILTER if filtered else None}
    runs = []
    telem.reset()
    telem.enable()
    try:
        for search in (lambda: one.search(Q[:batch], k=k, rerank=rerank, **kw),
                       lambda: sharded[rerank].search(Q[:batch], k=k, **kw)):
            res = search()
            comps = telem.counter_series("comparisons_total")
            spans = sorted((e["name"], e["args"].get("mode", "")) for e in telem.trace_events())
            runs.append((res, comps, spans))
            telem.reset()
    finally:
        telem.disable()
        telem.reset()
    (a, ca, sa), (b, cb, sb) = runs
    assert torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)
    assert torch.equal(a.comparisons, b.comparisons)
    assert ca == cb and any(lbl["stage"] == "traversal" for lbl, _ in ca)
    assert sorted(sa + [("shard_dispatch", "")]) == sb
    assert ("traversal", route) in sa and (("rerank", "") in sa) == bool(rerank)


def test_sharded_rejects_what_jax_rejects(data):
    X, _ = data
    with pytest.raises(ValueError, match="divide evenly"):
        tindex.build("sharded", X[:511], {"engine": "brute", "shards": 2}, device=CPU)
    sh = tindex.build("sharded", X, {"engine": "nsw", "shards": 2,
                                     "engine_cfg": ENGINES["nsw"][1]}, device=CPU)
    with pytest.raises(TypeError, match="shard_supports_quant"):
        tindex.build("sharded", X, {"engine": "nsw", "shards": 2, "quant": True},
                      device=CPU)
    with pytest.raises(ValueError, match="at least one shard"):
        sh.search(X[:2], k=2, shard_alive=(False, False))
    with pytest.raises(ValueError, match="covers 3 shards"):
        sh.search(X[:2], k=2, shard_alive=(True, True, True))


def test_stacking_pads_as_jnp_pad():
    """Uneven leaves pad as ``jnp.pad`` does with -1 / +inf: -1 wraps to
    the maximum of an unsigned dtype, +inf casts to True for bool."""
    states = [{"u8": torch.zeros(2, dtype=torch.uint8), "i": torch.zeros(2, dtype=torch.int32),
               "f": torch.zeros(2), "b": torch.zeros(2, dtype=torch.bool)},
              {"u8": torch.zeros(3, dtype=torch.uint8), "i": torch.zeros(3, dtype=torch.int32),
               "f": torch.zeros(3), "b": torch.zeros(3, dtype=torch.bool)}]
    st = tindex._stack_shard_states(states, torch.device(CPU))
    assert st["u8"][0].tolist() == [0, 0, 255] and st["i"][0].tolist() == [0, 0, -1]
    assert st["f"][0].tolist() == [0.0, 0.0, math.inf]
    assert st["b"][0].tolist() == [False, False, True]
    assert all(t.shape == (2, 3) for t in st.values())


def test_shard_views_and_placed_stores_are_views(data):
    X, Q = data
    sh = tindex.build("sharded", X, {"engine": "brute", "shards": 2, "quant": True,
                                     "attrs": _attrs(N)}, device=CPU)
    v = sh.shard_views()[1]["X"]
    assert v.data_ptr() == sh.stacked["X"][1].data_ptr()
    codes, scales, sqn = sh.quant.device_view(shard=1)
    full = sh.quant.device_view()
    assert codes.data_ptr() == full[0][N // 2:].data_ptr() and scales is full[1]
    assert sqn.shape == (N // 2,)
    assert sh.attrs.layout == sh.quant.layout == (2, N // 2)


def test_shard_telemetry_keys_on_first_seen(data):
    from repro_torch.core import telemetry as telem

    X, Q = data
    sh = tindex.build("sharded", X, {"engine": "brute", "shards": 2}, device=CPU)
    telem.reset()
    telem.enable()
    try:
        sh.search(Q, k=3)
        sh.search(Q, k=3)
        sh.search(Q, k=3, shard_alive=(True, False))
        miss = telem.counter_total("jit_cache_misses_total", scope="shard")
        hit = telem.counter_total("jit_cache_hits_total", scope="shard")
        masked = telem.counter_total("shard_masked_total")
        spans = [e for e in telem.trace_events() if e["name"] == "shard_dispatch"]
    finally:
        telem.disable()
        telem.reset()
    # the port compiles nothing, so it keeps no compile-cache counters
    assert (miss, hit, masked) == (0, 0, 1)
    assert len(spans) == 3


def test_chaos_kills_a_shard_before_the_search(data):
    X, Q = data
    sh = tindex.build("sharded", X, {"engine": "brute", "shards": 2,
                                     "chaos": {"seed": 0, "rules": []}}, device=CPU)
    sh.chaos.kill_shard(1)
    with pytest.raises(tchaos.ShardFault) as ei:
        sh.search(Q, k=3)
    assert ei.value.shard == 1
    res = sh.search(Q, k=3, shard_alive=(True, False))  # excluded: answers
    assert (to_np(res.idx) < N // 2).all()


# ------------------------------------------------------------ JAX <-> port

@pytest.mark.parametrize("name", list(ENGINES))
def test_jax_snapshot_searches_as_jax(jax_run, data, name):
    root, answers, _ = jax_run
    _, Q = data
    eng = tstore.load(os.path.join(root, "jax", name), device=CPU)
    assert isinstance(eng, tindex.ShardedIndex) and eng.shards == 2
    assert (eng.quant is not None) == (name in QUANT)
    for case, res in _searches(eng, Q, ENGINES[name][0]).items():
        _same(res, answers, f"{name}/{case}")


def test_convert_takes_jax_stacked_state(jax_run, data):
    """``convert.sharded_from_jax_state`` on the arrays and statics of a
    JAX sharded snapshot gives the index ``store.load`` gives."""
    from repro_torch import convert

    root, answers, _ = jax_run
    _, Q = data
    path = os.path.join(root, "jax", "nsw")
    meta = tstore.peek(path)
    with np.load(os.path.join(path, meta["arrays"])) as z:
        tree = tstore.unflatten_arrays({k: z[k] for k in z.files})
    eng = convert.sharded_from_jax_state(tree["engine"], meta["statics"], device=CPU)
    _same(eng.search(Q, k=K), answers, "nsw/plain")


def test_budget_remainder_is_tight_as_jax(jax_run):
    root, answers, _ = jax_run
    _, Qr = _rem_data()
    eng = tstore.load(os.path.join(root, "jax", "remainder"), device=CPU)
    assert eng.shards == 4
    for b in REM_BUDGETS:
        res = eng.search(Qr, k=1, budget=b)
        _same(res, answers, f"rem/{b}")
        # the remainder goes to the first shards: the sum is the budget,
        # and below the shard count every shard still gets one
        assert (to_np(res.comparisons) == max(b, 4)).all()


@pytest.mark.parametrize("name", PORT_BUILT)
def test_port_snapshot_searches_in_jax_as_in_port(jax_run, port_built, data, name):
    _, answers, _ = jax_run
    _, built = port_built
    _, Q = data
    for case, res in _searches(built[name], Q, name).items():
        _same(res, answers, f"port/{name}/{case}")


def test_snapshots_share_one_layout(jax_run, port_built):
    """The same meta keys and statics keys, and the same npz member names
    and dtypes, whichever package wrote a sharded snapshot."""
    root, _, _ = jax_run
    for name in ("brute", "infinity"):
        metas, members = [], []
        for side in ("jax", "port"):
            path = os.path.join(root, side, name)
            meta = tstore.peek(path)
            metas.append(meta)
            with np.load(os.path.join(path, meta["arrays"])) as z:
                members.append({k: z[k].dtype for k in z.files})
        assert set(metas[0]) == set(metas[1])
        assert set(metas[0]["statics"]) == set(metas[1]["statics"])
        assert metas[0]["statics"]["static"] == metas[1]["statics"]["static"]
        assert members[0] == members[1], name


def test_live_over_sharded_carries_as_jax(jax_run, data):
    root, answers, stats = jax_run
    _, Q = data
    live = tstore.load(os.path.join(root, "jax", "live"), device=CPU)
    with pytest.raises(ValueError, match="delta_cap must be >= the shard count"):
        tindex.build("live", data[0], {"engine": "sharded", "delta_cap": 1,
                                       "engine_cfg": {"engine": "brute", "shards": 2}},
                     device=CPU)
    for i, (op, arg) in enumerate(_live_script()):
        if op == "delete":
            live.delete(arg)
        elif op == "upsert":
            np.testing.assert_array_equal(live.upsert(arg), answers[f"live/{i}/ids"])
        elif op == "compact":
            np.testing.assert_array_equal(live.compact(), answers[f"live/{i}/remap"])
        else:
            _same(live.search(Q, k=K), answers, f"live/{i}")
        got = live.stats()
        assert {k: got[k] for k in stats[i]} == stats[i], (i, op)
    # the compaction carried 513 % 2 = 1 row into the delta
    assert stats[3]["frozen_size"] == 512 and stats[3]["delta_fill"] == 1


# ------------------------------------------------------- degraded serving

def test_shard_kill_degraded_serving_and_revival():
    """tests/test_fault_serving.py's shard-kill scenario, on one device."""
    n, d, k = 600, 16, 10
    X = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    Q = X[:16] + 0.01
    plan = tchaos.FaultPlan(seed=0)
    srv = tserve.SearchServer(X, engine="ivf_flat", shards=2,
                              cfg={"num_clusters": 8, "nprobe": 8, "budget": 512},
                              chaos=plan, device=CPU)
    full = srv.query(Q, k=k, budget=512, deadline_ms=60_000)
    assert not full.degraded and full.shards_answered == 2 and full.shards_total == 2
    plan.kill_shard(1)
    shard_rows = n // 2
    answers = []
    for _ in range(4):
        r = srv.query(Q, k=k, budget=512, deadline_ms=60_000)
        assert r.degraded and r.shards_answered == 1 and r.deadline_met
        assert (r.idx[r.idx >= 0] < shard_rows).all()
        answers.append(r.idx)
    assert srv.health == "DEGRADED" and sorted(srv._dead_shards) == [1]
    assert r.retries == 0  # a known-dead shard burns no retries
    np.testing.assert_array_equal(answers[0], answers[-1])
    # the survivors' answer is a brute search over shard 0's rows (IVF-Flat
    # probing all 8 lists is exhaustive)
    want = tindex.build("brute", X[:shard_rows], {}, device=CPU).search(Q, k=k)
    np.testing.assert_array_equal(answers[0], to_np(want.idx))
    plan.revive_shard(1)
    back = srv.query(Q, k=k, budget=512, deadline_ms=60_000)
    assert not back.degraded and back.shards_answered == 2
    assert srv.health == "SERVING" and not srv._dead_shards
    np.testing.assert_array_equal(full.idx, back.idx)
    np.testing.assert_array_equal(full.dist, back.dist)
    assert srv.fault_counters["degraded_queries"] == 4
    assert srv.fault_counters["recoveries"] == 1
    assert srv.health_log == ["SERVING", "DEGRADED", "SERVING"]
    assert srv.stats()["shards"] == 2


def test_rate_based_shard_flap_is_absorbed_by_retries():
    X = np.random.default_rng(0).normal(size=(400, 16)).astype(np.float32)
    Q = X[:8] + 0.01
    plan = tchaos.FaultPlan(rules=[{"site": "shard", "shard": 0, "start": 1, "stop": 3}])
    srv = tserve.SearchServer(X, engine="brute", shards=2, cfg={}, chaos=plan,
                              policy=tserve.FaultPolicy(max_retries=4,
                                                        backoff_base_s=0.001),
                              device=CPU)
    clean = srv.query(Q, k=5)
    flap = srv.query(Q, k=5)
    assert flap.retries == 2 and not flap.degraded
    np.testing.assert_array_equal(clean.idx, flap.idx)


def test_give_up_frac_masks_instead_of_retrying():
    """With less than ``give_up_frac`` of the deadline left a failing shard
    is masked at once: a spent deadline degrades on the first fault."""
    X = np.random.default_rng(0).normal(size=(400, 16)).astype(np.float32)
    plan = tchaos.FaultPlan(rules=[{"site": "shard", "shard": 1, "start": 0, "stop": 1}])
    srv = tserve.SearchServer(X, engine="brute", shards=2, cfg={}, chaos=plan,
                              device=CPU)
    r = srv.query(X[:4], k=3, deadline_ms=0.0)
    assert r.degraded and r.retries == 0 and r.shards_answered == 1
    assert tserve.FaultPolicy().give_up_frac == 0.25


def test_served_shards_swap_and_restore(data, tmp_path):
    X, Q = data
    srv = tserve.SearchServer(X, engine="brute", shards=2, cfg={}, device=CPU)
    one = tserve.SearchServer(X, engine="brute", cfg={}, device=CPU).query(Q, k=K)
    two = srv.query(Q, k=K)
    assert two.shards_total == 2 and not two.degraded
    np.testing.assert_array_equal(two.idx, one.idx)
    srv.swap("brute", shards=4, cfg={})
    four = srv.query(Q, k=K)
    assert four.shards_total == 4 and srv.stats()["shards"] == 4
    np.testing.assert_array_equal(four.idx, one.idx)
    back = tserve.SearchServer.restore(srv.snapshot(str(tmp_path / "s")), device=CPU)
    assert (back.engine, back.shards) == ("brute", 4)
    np.testing.assert_array_equal(back.query(Q, k=K).idx, one.idx)
