"""Port parity: ``core/profile`` and ``dist/roofline`` on the CPU.

The port counts work analytically per kernel call (``dist/roofline``)
plus the torch products outside the kernels (``FlopCounterMode``), where
JAX counts the dots of optimized HLO.  For the jnp brute scan both come to
exactly 2·B·n·d flops: JAX's program has one dot (the cross term; the
norms are reductions, not dots) and the port's one topk call reports
2·m·n·d, its plain version's own matmul running with the counters
suspended.  So the comparison with JAX's ``capture_search(...).flops`` is
exact (tolerance 0).  Bytes are not compared: JAX counts every HLO
instruction's output, the port the bytes its kernels must move and the
tensors its torch ops write.
"""
import json
import math
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import index as jindex  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import profile as tprofile  # noqa: E402
from repro_torch.core import telemetry as telem  # noqa: E402
from repro_torch.dist import roofline  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

CPU = "cpu"
SHAPES = [(512, 16, 64), (1000, 32, 8), (2048, 24, 128)]  # (n, d, B)
INF_CFG = {"q": math.inf, "proj_sample": 96, "knn_k": 8, "num_hops": 3,
           "embed_dim": 8, "hidden": (32,), "train_steps": 40, "batch_pairs": 128,
           "rerank": 16}


def _data(n, d, B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(B, d)).astype(np.float32))


@pytest.fixture(autouse=True)
def _fresh_registry():
    tprofile.reset()
    jprofile.reset()
    yield
    tprofile.reset()
    jprofile.reset()


@pytest.mark.parametrize("n,d,B", SHAPES)
def test_brute_flops_are_2bnd_as_jax(n, d, B):
    X, Q = _data(n, d, B)
    port = tprofile.capture_search(tindex.build("brute", X, {}, device=CPU), Q, k=5,
                                   measure=False)
    jax_prof = jprofile.capture_search(jindex.build("brute", X, {}), Q, k=5,
                                       measure=False)
    assert port.flops == 2 * B * n * d
    assert port.flops == jax_prof.flops  # exact: see the module docstring
    assert port.dot_count == jax_prof.dot_count == 1
    # the kernel's bytes: corpus and queries once, the (B, k) lists once
    assert port.hbm_bytes >= 4 * (B * d + n * d) + 8 * B * 5
    assert port.t_collective_s == 0.0 and port.dominant in ("compute", "memory")


def test_as_row_keys_are_jax_keys():
    X, Q = _data(512, 16, 64)
    port = tprofile.capture_search(tindex.build("brute", X, {}, device=CPU), Q, k=5)
    jax_prof = jprofile.capture_search(jindex.build("brute", X, {}), Q, k=5)
    assert set(port.as_row()) == set(jax_prof.as_row())
    assert [f.name for f in tprofile.dataclasses.fields(tprofile.ProgramProfile)] == \
        [f.name for f in jprofile.dataclasses.fields(jprofile.ProgramProfile)]
    assert 0.0 < port.pct_of_peak <= tprofile.PCT_LIMIT
    assert port.labels == {"engine": "brute", "batch": 64, "k": 5}


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_work_sums_over_shards(shards):
    n, d, B = 512, 16, 64
    X, Q = _data(n, d, B)
    eng = tindex.build("sharded", X, {"engine": "brute", "shards": shards}, device=CPU)
    prof = tprofile.capture_search(eng, Q, k=5, measure=False)
    assert prof.flops == 2 * B * n * d
    assert prof.dot_count == shards  # one topk launch per shard


def test_quant_brute_counts_int8_ops_at_the_int8_rate():
    n, d, B = 512, 16, 64
    X, Q = _data(n, d, B)
    eng = tindex.build("brute", X, {"quant": True}, device=CPU)
    with roofline.counting() as work:
        eng.search(torch.as_tensor(Q), k=5)
    assert work.launches == 1 and work.ops == 2 * B * n * d
    assert work.t_compute_s == pytest.approx(2 * B * n * d / roofline.INT8_OPS)


def test_infinity_counts_phi_products():
    n, d, B = 512, 16, 64
    X, Q = _data(n, d, B)
    eng = tindex.build("infinity", X, dict(INF_CFG), device=CPU)
    prof = tprofile.capture_search(eng, Q, k=5, measure=False)
    # Phi (16 -> 32 -> 8) is the only product: the beam and the rerank
    # score in the metrics' elementwise forms
    assert prof.flops == 2 * B * (d * 32 + 32 * 8)
    assert prof.dot_count == 2
    assert prof.dominant == "memory"


def test_counts_do_not_leak_outside_a_capture():
    X, Q = _data(256, 8, 8)
    eng = tindex.build("brute", X, {}, device=CPU)
    with roofline.counting() as work:
        pass
    eng.search(torch.as_tensor(Q), k=3)
    assert work.launches == 0 and work.ops == 0
    # a capture counts its own thread's calls only; the entry's defaults
    # (metric "sqeuclidean": the f32 matmul rate) reach the work formula
    from repro_torch.kernels.topk import ops as topk_ops

    Xt, Qt = torch.as_tensor(X), torch.as_tensor(Q)
    with roofline.counting() as work:
        other = threading.Thread(target=lambda: topk_ops.topk(Qt, Xt, k=3))
        other.start()
        other.join()
        topk_ops.topk(Qt, Xt, k=3)
    m, n, d = Qt.shape[0], Xt.shape[0], Xt.shape[1]
    assert work.launches == 1 and work.ops == 2 * m * n * d
    assert work.t_compute_s == 2 * m * n * d / roofline.F32_FLOPS


def test_registry_cache_and_gauges():
    X, Q = _data(512, 16, 64)
    eng = tindex.build("brute", X, {}, device=CPU)
    telem.reset()
    telem.enable()
    try:
        first = tprofile.capture_search(eng, Q, k=5, labels={"shards": 1})
        assert tprofile.capture_search(eng, Q, k=5, labels={"shards": 1}) is first
        again = tprofile.capture_search(eng, Q, k=5, labels={"shards": 1}, force=True)
        assert again is not first and len(tprofile.profiles("search:brute")) == 1
        text = telem.metrics_text()
    finally:
        telem.disable()
        telem.reset()
    for gauge in ("roofline_flops", "roofline_hbm_bytes", "roofline_intensity",
                  "roofline_predicted_s", "roofline_measured_s", "roofline_pct_of_peak"):
        assert f'{gauge}{{batch="64",engine="brute",k="5",program="search:brute",shards="1"}}' \
            in text, gauge


def test_a_count_above_the_measured_time_raises():
    X, Q = _data(512, 16, 64)
    eng = tindex.build("brute", X, {}, device=CPU)
    with pytest.raises(RuntimeError, match="a work count is wrong"):
        tprofile.capture_jit("search:brute", lambda q: eng.search(q, k=5),
                             torch.as_tensor(Q), measured_s=1e-15)
    assert not tprofile.profiles()  # nothing wrong is registered


def test_server_capture_roofline(tmp_path):
    X, Q = _data(512, 16, 64)
    srv = tserve.SearchServer(X, engine="brute", shards=2, cfg={}, device=CPU)
    srv.query(Q[:10], k=5)  # served bucket 16
    out = srv.capture_roofline(k=5)
    row = out["search:brute"]
    assert row["flops"] == 2 * 16 * 512 * 16
    assert row["pct_of_peak"] <= tprofile.PCT_LIMIT
    prof = tprofile.profiles("search:brute")[0]
    assert prof.labels == {"engine": "brute", "batch": 16, "k": 5, "shards": 2}
    json.dumps(out)  # a JSON block, as JAX's


def test_peaks_are_the_smoke_scripts():
    """``chip_smoke.py``'s bounds are this module's: its ``_bound`` takes a
    work function's (ops, kind, bytes) against these peaks, and the script
    states no peaks of its own."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert not any(hasattr(chip_smoke, name) for name in
                   ("F32_FLOPS", "F32_INSTR", "INT8_OPS", "HBM_BYTES", "HBM_BW"))
    for work, rate in ((roofline.topk_work(512, 30000, 784, 10, cube=False, masked=False),
                        roofline.F32_FLOPS),
                       (roofline.topk_int8_work(512, 30000, 784, 64, masked=False),
                        roofline.INT8_OPS),
                       (roofline.qpath_work(2048, 2048, 2048), roofline.F32_INSTR)):
        ops, _, nbytes = work
        bound = chip_smoke._bound(*work)
        assert bound["ms"] == max(ops / rate, nbytes / roofline.HBM_BW) * 1e3
        assert (bound["ops"], bound["bytes"]) == (ops, nbytes)


def test_kernel_work_formulas():
    assert roofline.topk_work(4, 10, 3, 2, cube=False, masked=True) == \
        (240, "f32", 4 * (12 + 30) + 64 + 10)
    assert roofline.topk_work(4, 10, 3, 2, cube=True, masked=False)[1] == "f32_instr"
    assert roofline.topk_int8_work(4, 10, 3, 2, masked=False) == \
        (240, "int8", 12 + 30 + 4 * 18 + 64)
    assert roofline.pdist_work(4, 5, 3, cube=False) == (120, "f32", 4 * (12 + 15 + 20))
    assert roofline.qpath_work(4, 6, 5) == (240, "f32_instr", 4 * (24 + 30 + 20))
    ids = torch.tensor([[0, 0, 2], [2, -1, 1]])
    ops, kind, nbytes = roofline.bag_work(ids, 8, weighted=False, elem=4)
    # rows 0, 1, 2 of 32 bytes each (the padding id reads row 0)
    assert (ops, kind, nbytes) == (2 * 6 * 8, "f32_instr", 3 * 32 + 4 * 6 + 4 * 2 * 8)
    # without reuse every lookup reads its row's sector
    assert roofline.bag_work(ids, 8, weighted=False, elem=4, reuse=False)[2] == \
        6 * 32 + 4 * 6 + 4 * 2 * 8
    # a mask's data-dependent work: the passing rows scanned, the mask read whole
    assert roofline.topk_work(4, 10, 3, 2, cube=False, masked=True, live=6) == \
        (144, "f32", 4 * (12 + 18) + 64 + 10)
    assert roofline.topk_int8_work(4, 10, 3, 2, masked=True, live=6) == \
        (144, "int8", 12 + 18 + 4 * 14 + 64 + 10)
    assert roofline.merge_work(4, 2, 3, 20) == (24, "f32_instr", 8 * 20 + 8 * 8)
