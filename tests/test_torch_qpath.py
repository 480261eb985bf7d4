"""The qpath kernel's plain-side contracts, on the CPU.

``csrc/qpath.cu`` skips, in logminplus, every (i, j, k) whose max(a, b) is
already >= the running minimum.  That is exact because the kernel's combine
— max(a, b) + log1p(exp(-|a - b|)), and a + b where a - b is NaN — is never
below max(a, b) (or is NaN, which fminf ignores), so min(acc, combine) is
acc wherever max(a, b) >= acc.  These tests hold that premise with the
formula written in torch f32 (fmax / fmin are the NaN-ignoring fmaxf /
fminf), on random bit patterns and on the infinities, and hold the
launcher's split plan to its contract."""
import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels.qpath.qpath import (  # noqa: E402
    MIN_SPLIT_K, STAGE_K, TILE, WAVES, split_plan,
)

INF = math.inf
SPECIAL = np.array([0.0, -0.0, INF, -INF, 1.0, -1.0, 0.5, -0.5, 1e-30, -1e-30, 1e-45,
                    -1e-45, 3.4e38, -3.4e38, 88.0, -88.0, 104.0, -104.0, 17.0, -17.0],
                   dtype=np.float32)


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``csrc/qpath.cu:combine<LOGMINPLUS>`` in torch f32."""
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.fmax(a, b) + torch.log1p(torch.exp(-delta.abs())))


def _values(rng: np.random.Generator, n: int) -> np.ndarray:
    """n f32 values: random bit patterns (every finite, subnormal and
    infinite value, and NaNs), random values of the log-power domain's
    range, and the special values."""
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    logs = (rng.normal(size=n) * 10.0).astype(np.float32)
    return np.concatenate([bits, logs, rng.choice(SPECIAL, size=n)])


def _hold_premise(a: np.ndarray, b: np.ndarray, acc: np.ndarray) -> None:
    a, b, acc = map(torch.as_tensor, (a, b, acc))
    c = combine(a, b)
    mx = torch.fmax(a, b)
    assert bool((torch.isnan(c) | (c >= mx)).all()), "combine fell below max(a, b)"
    skip = (mx >= acc) & ~torch.isnan(acc)
    kept = torch.fmin(acc, c)
    assert torch.equal(kept[skip], acc[skip]), "a skipped combine would lower acc"


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_logminplus_combine_is_never_below_max(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    _hold_premise(_values(rng, n), _values(rng, n), _values(rng, n))


def test_logminplus_combine_on_the_special_values():
    # every (a, b) pair of the special values against every special acc,
    # (-inf, -inf) -> -inf (the log-domain diagonal) among them
    a, b, acc = np.meshgrid(SPECIAL, SPECIAL, SPECIAL, indexing="ij")
    _hold_premise(a.ravel(), b.ravel(), acc.ravel())
    c = combine(torch.tensor([-INF, INF, -INF]), torch.tensor([-INF, INF, 2.0]))
    assert c.tolist() == [-INF, INF, 2.0]


@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (512, 512, 512), (1000, 1000, 1000),
                                   (130, 70, 257), (8, 300, 9), (33, 7, 65), (1, 1, 1)])
@pytest.mark.parametrize("mode", sorted(TILE))
@pytest.mark.parametrize("slots", [132, 264, 396])
def test_split_plan_covers_k_in_whole_stages(shape, mode, slots):
    m, kd, n = shape
    splits, per = split_plan(m, kd, n, slots, TILE[mode], WAVES[mode])
    assert per % STAGE_K == 0
    assert splits * per >= kd > (splits - 1) * per  # every split is non-empty
    tiles = -(-m // TILE[mode]) * -(-n // TILE[mode])
    if splits > 1:
        assert per >= MIN_SPLIT_K or kd < MIN_SPLIT_K
        assert tiles * splits <= WAVES[mode] * slots


@pytest.mark.parametrize("q", [2.0, INF])
def test_recorded_sweeps_replays_a_builds_projection(q):
    # chip_smoke.py and tools/profile_qpath.py time the kernel on the
    # operands a build's projection hands it, recorded by this context
    # manager: every sweep of a small CPU build, in the build's mode, the
    # doubling sweeps' right operand being the left one; the library's
    # entry is restored afterwards
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core import index as index_lib
    from repro_torch.core import qmetric
    from repro_torch.data import synthetic
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref

    entry = qmetric.qpath_ops.qpath_matmul
    corpus = synthetic.make("manifold", 200, seed=0)
    seen = []
    with chip_smoke.recorded_sweeps(seen):
        index_lib.build("infinity", corpus, {"q": q, "proj_sample": 96, "train_steps": 2},
                        device="cpu")
    assert qmetric.qpath_ops.qpath_matmul is entry
    mode = "minmax" if math.isinf(q) else "logminplus"
    assert [(m, tuple(A.shape), B) for m, A, B in seen] == [(mode, (96, 96), None)] * 6
    # each sweep's operand is min(previous, previous (x) previous)
    for (_, prev, _), (_, nxt, _) in zip(seen, seen[1:]):
        assert torch.equal(nxt, torch.minimum(prev, qpath_matmul_ref(prev, prev, mode=mode)))
