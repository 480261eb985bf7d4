"""Port parity: ``core/backoff`` and ``core/chaos`` — the port's copies
against the JAX package's, on the CPU.

The arithmetic must be equal over a grid (``backoff_s``, the
``degraded_budget`` ladder, ``median_deadline``, ``RunCounter``, and
``CircuitBreaker`` transitions under a fake clock).  A scripted
``FaultPlan`` must fire the same sites on the same call numbers as JAX's,
exactly: the draws are a pure function of (seed, site, rule, call number).
A snapshot ``corrupt_snapshot`` damaged must fail the port's ``verify``,
and a ``snapshot`` rule must corrupt what the port's ``store.save`` wrote."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import backoff as jback  # noqa: E402
from repro.core import chaos as jchaos  # noqa: E402
from repro_torch.core import backoff as tback  # noqa: E402
from repro_torch.core import chaos as tchaos  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402

CPU = "cpu"


@pytest.mark.parametrize("base, cap, factor", [(0.005, 0.05, 2.0), (0.001, 0.1, 3.0),
                                               (0.01, 0.01, 2.0)])
def test_backoff_s_matches_jax(base, cap, factor):
    for attempt in list(range(-2, 40)) + [2000]:
        assert tback.backoff_s(attempt, base_s=base, cap_s=cap, factor=factor) == \
            jback.backoff_s(attempt, base_s=base, cap_s=cap, factor=factor)


@pytest.mark.parametrize("budget", [None, 8, 100, 256, 1024, 4096])
@pytest.mark.parametrize("floor", [1, 8, 32])
def test_degraded_budget_ladder_matches_jax(budget, floor):
    for frac in np.linspace(0.0, 1.0, 41):
        assert tback.degraded_budget(budget, float(frac), floor=floor) == \
            jback.degraded_budget(budget, float(frac), floor=floor)


def test_median_deadline_and_run_counter_match_jax():
    rng = np.random.default_rng(0)
    hist = list(rng.uniform(0.01, 0.2, size=12))
    for n in range(len(hist) + 1):
        for factor in (1.5, 3.0):
            assert tback.median_deadline(hist[:n], factor=factor) == \
                jback.median_deadline(hist[:n], factor=factor)
    events = rng.random(200) < 0.6
    for trip in (1, 3, 5):
        jc, tc = jback.RunCounter(trip), tback.RunCounter(trip)
        assert [tc.observe(bool(e)) for e in events] == [jc.observe(bool(e)) for e in events]


def test_deadline_none_and_zero_match_jax():
    for ms in (None, 0, -1):
        j, t = jback.Deadline(ms), tback.Deadline(ms)
        assert (t.fraction_left(), t.expired()) == (j.fraction_left(), j.expired())


@pytest.mark.parametrize("trip, cooldown", [(1, 0.5), (3, 0.25), (5, 1.0)])
def test_circuit_breaker_transitions_match_jax(trip, cooldown):
    """One scripted stream of allow / record(ok) / clock ticks through both
    breakers: every return value, state and trip count equal."""
    rng = np.random.default_rng(trip)
    now = [0.0]

    def clock():
        return now[0]

    jb = jback.CircuitBreaker(trip, cooldown, cooldown_cap_s=4.0, clock=clock)
    tb = tback.CircuitBreaker(trip, cooldown, cooldown_cap_s=4.0, clock=clock)
    log_j, log_t = [], []
    for step in range(400):
        op = rng.integers(0, 3)
        if op == 0:
            now[0] += float(rng.uniform(0.0, 0.6))
            continue
        if op == 1:
            log_j.append(("allow", jb.allow()))
            log_t.append(("allow", tb.allow()))
        else:
            ok = bool(rng.random() < 0.4)
            log_j.append(("record", jb.record(ok)))
            log_t.append(("record", tb.record(ok)))
        log_j.append((jb.state, jb.trips, jb.state_code(), round(jb.retry_after_s(), 9)))
        log_t.append((tb.state, tb.trips, tb.state_code(), round(tb.retry_after_s(), 9)))
    assert log_t == log_j
    assert jb.trips > 0  # the script exercised the open path


PLANS = {
    "search-rates": {"seed": 3, "rules": [
        {"site": "search", "kind": "error", "rate": 0.2},
        {"site": "search", "kind": "latency", "rate": 0.3, "ms": 5.0}]},
    "windows": {"seed": 0, "rules": [
        {"site": "search", "start": 4, "stop": 7},
        {"site": "build", "start": 1, "stop": 2},
        {"site": "compact", "rate": 0.5},
        {"site": "delta", "start": 2, "stop": 3}]},
    "shards": {"seed": 11, "rules": [
        {"site": "shard", "rate": 0.25},
        {"site": "shard", "shard": 1, "start": 3, "stop": 9}]},
    "slow": {"seed": 5, "rules": [
        {"site": "slow_search", "kind": "latency", "rate": 0.5, "ms": 1.0},
        {"site": "slow_search", "rate": 0.1}]},
}

SITES = {"search": "on_search", "slow_search": "on_slow_search", "build": "on_build",
         "compact": "on_compact", "delta": "on_delta"}


def _fire_sequence(mod, spec: dict, calls: int):
    """(site, call, outcome) for ``calls`` calls of every site, the sleeps
    recorded instead of slept."""
    slept = []
    plan = mod.FaultPlan(seed=spec["seed"], rules=spec["rules"], sleep=slept.append)
    out = []
    for callno in range(calls):
        for site, fn in SITES.items():
            try:
                getattr(plan, fn)()
                out.append((site, callno, "ok"))
            except mod.FaultError as e:
                out.append((site, callno, type(e).__name__))
        out.append(("shard", callno, tuple(sorted(plan.dead_shards(4)))))
    return out, slept, plan.stats()


@pytest.mark.parametrize("name", list(PLANS))
def test_fault_plan_fires_as_jax(name):
    j = _fire_sequence(jchaos, PLANS[name], 64)
    t = _fire_sequence(tchaos, PLANS[name], 64)
    assert t == j
    assert any(outcome not in ("ok", ()) for _, _, outcome in t[0])


def test_draws_and_rule_validation_match_jax():
    for seed in range(3):
        for callno in range(50):
            assert tchaos._draw(seed, "search", 1, callno, 2) == \
                jchaos._draw(seed, "search", 1, callno, 2)
    for bad in ({"site": "nowhere", "rate": 1.0}, {"site": "search"}):
        with pytest.raises(ValueError) as je:
            jchaos.Rule(**bad)
        with pytest.raises(ValueError) as te:
            tchaos.Rule(**bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError):
        tchaos.FaultPlan.from_cfg("rate=1")


@pytest.fixture
def snapshot(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    eng = tindex.build("brute", X, {}, device=CPU)
    return tstore.save(eng, str(tmp_path / "snap"))


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "drop"])
def test_corrupted_snapshot_fails_verify(snapshot, mode):
    tstore.verify(snapshot)
    member = tchaos.corrupt_snapshot(snapshot, mode=mode, seed=7)
    assert os.path.basename(member).startswith("arrays-")
    with pytest.raises(tstore.SnapshotCorruption):
        tstore.verify(snapshot)
    with pytest.raises(tstore.SnapshotCorruption):
        tstore.load(snapshot, device=CPU)


def test_corruption_is_the_same_bytes_as_jax(snapshot, tmp_path):
    """Both packages' ``corrupt_snapshot`` damage one file identically."""
    import shutil

    other = str(tmp_path / "copy")
    shutil.copytree(snapshot, other)
    tchaos.corrupt_snapshot(snapshot, mode="bitflip", seed=3)
    jchaos.corrupt_snapshot(other, mode="bitflip", seed=3)
    name = tstore.peek(snapshot)["arrays"]
    with open(os.path.join(snapshot, name), "rb") as a, \
            open(os.path.join(other, name), "rb") as b:
        assert a.read() == b.read()


def test_snapshot_rule_corrupts_the_ports_save(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    eng = tindex.build("brute", X, {"chaos": {"rules": [
        {"site": "snapshot", "start": 1, "stop": 2, "mode": "truncate"}]}}, device=CPU)
    first = tstore.save(eng, str(tmp_path / "a"))
    tstore.verify(first)  # call 0: clean
    second = tstore.save(eng, str(tmp_path / "b"))  # call 1: truncated
    with pytest.raises(tstore.SnapshotCorruption, match="sha256"):
        tstore.verify(second)
    assert eng.chaos.stats()["injected"] == {"snapshot:truncate": 1}
