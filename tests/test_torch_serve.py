"""Port parity: ``launch/serve.SearchServer`` against JAX's, on the CPU.

The bridge is the snapshot: JAX builds and saves each engine, both
packages' ``SearchServer.restore`` load it, and batches of 1, 7, 40, 64
and 100 queries must get JAX's ids (near ties aside; distances rtol 1e-5 /
atol 5e-4) and comparison counts.  The pad decides the traversal: the
40-query batch is served padded to 64, by the infinity engine's beam —
both packages count its three beam stages, and the counts are equal.

A chaos plan with transient errors and latency spikes gives the same
fault counters, health log, injection totals and answers in both; a
corrupted snapshot under ``snapshot_dir`` is discarded and a failed swap
restores the last good one; a probe at rate 0.5 samples the same ordinals
and gives the same recall estimate; the live server's operations match;
the surfaces that once raised ``NotImplementedError`` (shards, the
roofline capture, the runtime and its HTTP front) now answer.  The CLI is held to JAX's in ``tests/test_torch_serve_cli.py``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import chaos as jchaos  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import probes as jprobes  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core import telemetry as jtelem  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import chaos as tchaos  # noqa: E402
from repro_torch.core import probes as tprobes  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core import telemetry as ttelem  # noqa: E402
from repro_torch.launch import runtime as truntime  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from torch_parity import assert_same_ids  # noqa: E402

CPU = "cpu"
N, D, K, BUDGET = 1024, 16, 10, 256
BATCHES = (1, 7, 40, 64, 100)
ENGINES = {
    "brute": {},
    "ivf_flat": {"num_clusters": 16, "nprobe": 4},
    "ivf_pq": {"num_clusters": 16, "M": 4, "ksub": 16, "nprobe": 4, "rerank": 32},
    "nsw": {"degree": 8, "ef": 32, "max_steps": 64},
    "infinity": {"q": float("inf"), "proj_sample": 256, "knn_k": 8, "num_hops": 4,
                 "embed_dim": 8, "hidden": (32,), "train_steps": 80,
                 "batch_pairs": 128, "rerank": 48},
}


@pytest.fixture(scope="module")
def data():
    from repro_torch.data import synthetic

    X = synthetic.make("manifold", N + 200, seed=0)[:, :D].astype(np.float32)
    return X[:N], X[N:]


@pytest.fixture(scope="module")
def snapshots(data, tmp_path_factory):
    """{engine: JAX snapshot path}, each engine built once by JAX."""
    X, _ = data
    root = tmp_path_factory.mktemp("serve_snaps")
    return {name: jstore.save(jindex.build(name, X, dict(cfg)), str(root / name))
            for name, cfg in ENGINES.items()}


@pytest.fixture(scope="module")
def servers(snapshots):
    """{engine: (JAX server, port server)}, both restored from JAX's
    snapshot."""
    return {name: (jserve.SearchServer.restore(path),
                   tserve.SearchServer.restore(path, device=CPU))
            for name, path in snapshots.items()}


@pytest.fixture
def telemetry_on():
    for t in (jtelem, ttelem):
        t.reset()
        t.enable()
    yield
    for t in (jtelem, ttelem):
        t.reset()
        t.disable()


def _same_answer(tres, jres):
    assert_same_ids(tres.idx, tres.dist, jres.idx, jres.dist)
    np.testing.assert_array_equal(tres.comparisons, np.asarray(jres.comparisons))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_restored_server_answers_as_jax(servers, data, engine, batch):
    _, Q = data
    jsrv, tsrv = servers[engine]
    jres = jsrv.query(Q[:batch], k=K, budget=BUDGET)
    tres = tsrv.query(Q[:batch], k=K, budget=BUDGET)
    assert tres.idx.shape == (batch, K) and tres.idx.dtype == np.int32
    assert isinstance(tres.idx, np.ndarray) and tres.retries == 0 and tres.deadline_met
    _same_answer(tres, jres)


@pytest.mark.parametrize("batch, beam", [(40, True), (7, False), (100, True)])
def test_the_pad_decides_the_traversal(servers, data, telemetry_on, batch, beam):
    """Padded to 64, a 40-query batch takes the beam: its three stage
    counters fire, equal in both packages, and sum to the served
    traversal comparisons; a 7-query batch (padded to 8) takes
    best-first."""
    _, Q = data
    jsrv, tsrv = servers["infinity"]
    jres = jsrv.query(Q[:batch], k=K, budget=BUDGET)
    tres = tsrv.query(Q[:batch], k=K, budget=BUDGET)
    _same_answer(tres, jres)
    stages = {}
    for t in (jtelem, ttelem):
        stages[t] = {lbl["stage"]: v for lbl, v in t.counter_series("comparisons_total")}
    assert stages[ttelem] == stages[jtelem]
    got = stages[ttelem]
    if beam:
        assert set(got) == {"traversal", "centroid_rank", "bucket_scan", "rerank"}
    else:
        assert "bucket_scan" not in got and got["traversal"] > 0
    # the port compiles nothing, so it keeps no compile-cache counters
    assert not ttelem.counter_series("jit_cache_misses_total")
    assert not ttelem.counter_series("jit_cache_hits_total")
    assert [ev["name"] for ev in ttelem.trace_events()].count("dispatch") == 1


def test_beam_stage_counters_sum_to_the_served_comparisons(servers, data, telemetry_on):
    _, Q = data
    _, tsrv = servers["infinity"]
    res = tsrv.query(Q[:64], k=K, budget=BUDGET)
    got = {lbl["stage"]: v for lbl, v in ttelem.counter_series("comparisons_total")}
    rerank = got.pop("rerank")
    assert sum(got.values()) + rerank == int(res.comparisons.sum())
    # the beam's level loop and bucket scan are timed where they run; the
    # centroid ranking runs inside each level and is counted only
    assert {ev["name"] for ev in ttelem.trace_events()} == {
        "pad", "dispatch", "embed", "traversal", "bucket_scan", "rerank"}


CHAOS = {"seed": 4, "rules": [{"site": "search", "kind": "error", "rate": 0.3},
                              {"site": "search", "kind": "latency", "rate": 0.3,
                               "ms": 1.0}]}


def test_chaos_plan_gives_jax_faults_and_answers(data):
    X, Q = data
    pol = dict(max_retries=4, backoff_base_s=0.0005, backoff_cap_s=0.002)
    j = jserve.SearchServer(X, engine="brute", cfg={}, chaos=dict(CHAOS),
                            policy=jserve.FaultPolicy(**pol))
    t = tserve.SearchServer(X, engine="brute", cfg={}, chaos=dict(CHAOS),
                            policy=tserve.FaultPolicy(**pol), device=CPU)
    clean = tserve.SearchServer(X, engine="brute", cfg={}, device=CPU)
    for i in range(12):
        q = Q[8 * i:8 * i + 8]
        jr, tr = j.query(q, k=K), t.query(q, k=K)
        _same_answer(tr, jr)
        assert tr.retries == jr.retries
        np.testing.assert_array_equal(tr.idx, clean.query(q, k=K).idx)
    assert t.fault_counters == j.fault_counters
    assert t.fault_counters["retries"] > 0
    assert t.health_log == j.health_log
    assert t.chaos.stats() == j.chaos.stats()
    assert t.chaos.stats()["injected"]["search:latency"] > 0


def test_fault_storm_surfaces_after_max_retries(data):
    X, Q = data
    plan = {"rules": [{"site": "search", "start": 1, "stop": 50}]}
    t = tserve.SearchServer(X, engine="brute", cfg={}, chaos=plan, device=CPU,
                            policy=tserve.FaultPolicy(max_retries=2, backoff_base_s=0.0005))
    t.query(Q[:8], k=K)
    with pytest.raises(tchaos.TransientFault):
        t.query(Q[:8], k=K)
    assert t.fault_counters["retries"] == 2 and t.fault_counters["faults"] == 3


@pytest.mark.parametrize("package", ["jax", "port"])
def test_corrupted_snapshot_is_skipped_and_heal_restores_the_last_good(
        data, tmp_path, package):
    """The second rotation write is corrupted (discarded, retried clean);
    then a poisoned swap walks SERVING -> DEGRADED -> RECOVERING -> SERVING
    and the last good snapshot serves — the same counters in both."""
    X, Q = data
    mod, chaos_mod = (jserve, jchaos) if package == "jax" else (tserve, tchaos)
    kw = {} if package == "jax" else {"device": CPU}
    plan = {"rules": [{"site": "snapshot", "start": 1, "stop": 2},
                      {"site": "build", "start": 1, "stop": 2}]}
    srv = mod.SearchServer(X, engine="brute", cfg={}, chaos=plan,
                           snapshot_dir=str(tmp_path), **kw)
    first = srv._last_good
    second = srv._save_good_snapshot()  # corrupted once, clean on retry
    assert second not in (None, first) and not os.path.exists(first)
    assert srv.fault_counters["snapshot_corrupt"] == 1
    before = srv.query(Q[:8], k=K)
    with pytest.raises(chaos_mod.BuildFault):
        srv.swap("ivf_flat", cfg={"num_clusters": 8, "nprobe": 4})
    assert srv.health_log == ["SERVING", "DEGRADED", "RECOVERING", "SERVING"]
    assert srv.fault_counters == {
        "faults": 1, "retries": 0, "degraded_queries": 0, "recoveries": 1,
        "snapshot_restores": 1, "snapshot_corrupt": 1, "deadline_misses": 0,
        "quality_breaches": 0}
    np.testing.assert_array_equal(srv.query(Q[:8], k=K).idx, before.idx)
    assert srv.engine == "brute"


def test_server_snapshot_verifies_what_it_wrote(data, tmp_path):
    X, _ = data
    t = tserve.SearchServer(X, engine="brute", cfg={}, device=CPU, chaos={
        "rules": [{"site": "snapshot", "rate": 1.0, "mode": "truncate"}]})
    with pytest.raises(tstore.SnapshotCorruption):
        t.snapshot(str(tmp_path / "snap"))
    assert t.fault_counters["snapshot_corrupt"] == 1


def test_probe_samples_and_estimates_as_jax(snapshots, data):
    _, Q = data
    path = snapshots["infinity"]
    j, t = jserve.SearchServer.restore(path), tserve.SearchServer.restore(path, device=CPU)
    for srv, mod in ((j, jprobes), (t, tprobes)):
        srv._probe = mod.RecallProbe({"rate": 0.5, "seed": 3, "flush_at": 16})
    for size in (40, 64, 7, 64, 25):
        j.query(Q[:size], k=K, budget=BUDGET)
        t.query(Q[:size], k=K, budget=BUDGET)
    jq, tq = j.stats()["quality"], t.stats()["quality"]
    assert tq == jq
    assert 0 < tq["probed"] < tq["seen"] == 200 and tq["recall_estimate"] < 1.0
    np.testing.assert_array_equal(tprobes.sampled_mask(3, 0.5, 0, 200),
                                  jprobes.sampled_mask(3, 0.5, 0, 200))


def test_live_server_operations_match_jax(data, tmp_path):
    X, Q = data
    rng = np.random.default_rng(4)
    ins = rng.normal(size=(6, D)).astype(np.float32)
    plan = {"rules": [{"site": "delta", "start": 1, "stop": 2}]}
    j = jserve.SearchServer(X, engine="brute", cfg={}, live=True, delta_cap=16,
                            chaos=dict(plan))
    t = tserve.SearchServer(X, engine="brute", cfg={}, live=True, delta_cap=16,
                            chaos=dict(plan), device=CPU)
    for srv in (j, t):
        ids = srv.upsert(ins)
        srv.delete(ids[:2])
        srv.upsert(ins)  # injected overflow: compact, then retry
        srv.query(Q[:10], k=3)
        srv.serve([Q[:10]], k=3)
    keys = ("live", "queries", "batches", "generation", "frozen_size", "delta_fill",
            "delta_cap", "tombstones", "deleted_frac", "n_alive", "compactions",
            "health", "faults")
    js, ts = j.stats(), t.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    np.testing.assert_array_equal(t.compact(), j.compact())
    _same_answer(t.query(Q[:10], k=3), j.query(Q[:10], k=3))
    back = tserve.SearchServer.restore(t.snapshot(str(tmp_path / "snap")), device=CPU)
    assert back.live and back.stats()["frozen_size"] == t.stats()["frozen_size"]
    np.testing.assert_array_equal(back.query(Q[:10], k=3).idx, t.query(Q[:10], k=3).idx)
    frozen = tserve.SearchServer(X, engine="brute", cfg={}, device=CPU)
    with pytest.raises(TypeError):
        frozen.upsert(ins[:1])


def test_deadline_shrinks_the_budget_as_jax(data):
    X, Q = data
    cfg = {"num_clusters": 8, "nprobe": 4, "budget": 256}
    j = jserve.SearchServer(X, engine="ivf_flat", cfg=dict(cfg))
    t = tserve.SearchServer(X, engine="ivf_flat", cfg=dict(cfg), device=CPU)
    for srv in (j, t):
        spent = srv.query(Q[:8], k=5, budget=256, deadline_ms=0.0)
        assert not spent.deadline_met
        assert srv.fault_counters["deadline_misses"] == 1
    for frac in (1.0, 0.3, 0.05):
        assert tserve.backoff_lib.degraded_budget(256, frac) == \
            jserve.backoff_lib.degraded_budget(256, frac)


def test_what_is_not_ported_raises(data, servers):
    """Named for the surfaces that once raised ``NotImplementedError``
    (sharding, the roofline capture, the runtime and its HTTP front); the
    name is kept so the test's history stays one line.  Nothing the server
    reaches raises any more: every registry key
    resolves, a 2-shard server answers as the restored brute engine, and
    the roofline capture, the runtime and its HTTP front run (their parity
    tests: tests/test_torch_sharded.py, _profile.py, _runtime.py)."""
    from repro_torch.core import index as tindex

    X, Q = data
    assert all(tindex.get_index(name) for name in tindex.BUILTIN)
    brute = servers["brute"][1]
    sharded = tserve.SearchServer(X, engine="brute", shards=2, cfg={}, device=CPU)
    np.testing.assert_array_equal(sharded.query(Q[:8], k=K).idx,
                                  brute.query(Q[:8], k=K).idx)
    assert "search:brute" in brute.capture_roofline(batch=8)
    run = truntime.ServingRuntime(brute).start()
    httpd = truntime.start_http_front(run, port=0)
    try:
        assert run.submit(Q[0], k=K).result(timeout=30).outcome == "ok"
    finally:
        httpd.shutdown()
        run.stop()
