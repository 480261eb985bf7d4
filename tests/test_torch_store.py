"""Port parity: ``core/store`` — snapshots cross between the packages, on
the CPU.

For brute (f32 and ``quant``), ivf_flat, ivf_pq, nsw and infinity (q=2 and
q=inf), with and without an attribute store: JAX ``store.save`` -> the
port's ``store.load`` -> ``search`` gives JAX's ids (near ties aside) and
distances within rtol 1e-5 / atol 5e-4 (``tests/torch_parity.py``), and
the port's ``save`` -> JAX's ``load`` gives the same again.  Both
packages write the same ``meta.json`` keys and statics and the same npz
members (names, shapes, dtypes).  The manifest catches a flipped byte and
a dropped member, and the format-version gate raises as JAX's does.

The quantized brute is built with JAX's ``impl="pallas"`` (its int8
kernel in interpret mode), whose function the port computes."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import attrs as jattrs  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N, D, B, K = 512, 16, 64, 5
INF_SMALL = {"proj_sample": 128, "knn_k": 8, "num_hops": 3, "embed_dim": 8,
             "hidden": (32,), "train_steps": 60, "batch_pairs": 128, "rerank": 16}
ENGINES = {
    "brute": ("brute", {}),
    "brute+quant": ("brute", {"quant": True, "impl": "pallas"}),
    "ivf_flat": ("ivf_flat", {"num_clusters": 8, "nprobe": 4}),
    "ivf_pq": ("ivf_pq", {"num_clusters": 8, "M": 4, "ksub": 16, "nprobe": 4,
                          "rerank": 16}),
    "nsw": ("nsw", {"degree": 8, "ef": 24, "max_steps": 64}),
    "infinity q=2": ("infinity", {"q": 2.0} | INF_SMALL),
    "infinity q=inf": ("infinity", {"q": float("inf")} | INF_SMALL),
}
FILTER = {"score": {"range": [None, 0.5]}}


def _attrs(n: int) -> dict:
    rng = np.random.default_rng(5)
    return {"score": rng.uniform(size=n).astype(np.float32),
            "cat": [f"c{i % 5}" for i in range(n)]}


@pytest.fixture(scope="module")
def data():
    X = synthetic.make("manifold", N + B, seed=0)[:, :D].astype(np.float32)
    return X[:N], X[N:]


@pytest.fixture(scope="module")
def jax_snapshots(data, tmp_path_factory):
    """{(engine, with_attrs): (snapshot path, JAX engine)}, each engine
    built once; the attrs variant is a loaded copy with a store attached."""
    X, _ = data
    root = tmp_path_factory.mktemp("jax_snaps")
    out = {}
    for name, (key, cfg) in ENGINES.items():
        eng = jindex.build(key, X, dict(cfg))
        slug = name.replace(" ", "_").replace("=", "")
        path = jstore.save(eng, str(root / slug))
        out[(name, False)] = (path, eng)
        tagged = jstore.load(path)
        jindex.attach_store(tagged, jattrs.AttributeStore.build(_attrs(N), N))
        out[(name, True)] = (jstore.save(tagged, str(root / (slug + "_attrs"))), tagged)
    return out


def _search(eng, Q, with_attrs: bool):
    res = [eng.search(Q, k=K)]
    if with_attrs:
        res.append(eng.search(Q, k=K, filter=FILTER))
    return res


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert_same_ids(g.idx, g.dist, w.idx, w.dist)
        np.testing.assert_array_equal(to_np(g.comparisons), to_np(w.comparisons))


CASES = [(name, a) for name in ENGINES for a in (False, True)]
IDS = [f"{n}{'+attrs' if a else ''}" for n, a in CASES]


@pytest.mark.parametrize("name, with_attrs", CASES, ids=IDS)
def test_jax_snapshot_loads_in_the_port(jax_snapshots, data, name, with_attrs):
    _, Q = data
    path, jeng = jax_snapshots[(name, with_attrs)]
    teng = tstore.load(path, device=CPU)
    assert teng.registry_name == jeng.registry_name
    assert (getattr(teng, "attrs", None) is None) == (not with_attrs)
    assert (getattr(teng, "quant", None) is None) == (getattr(jeng, "quant", None) is None)
    _assert_same(_search(teng, Q, with_attrs), _search(jeng, Q, with_attrs))


@pytest.mark.parametrize("name, with_attrs", CASES, ids=IDS)
def test_port_snapshot_loads_in_jax(jax_snapshots, data, tmp_path, name, with_attrs):
    _, Q = data
    path, jeng = jax_snapshots[(name, with_attrs)]
    teng = tstore.load(path, device=CPU)
    back = jstore.load(tstore.save(teng, str(tmp_path / "port")))
    _assert_same(_search(back, Q, with_attrs), _search(jeng, Q, with_attrs))


def _members(path: str) -> dict:
    meta = tstore.peek(path)
    with np.load(os.path.join(path, meta["arrays"])) as z:
        return {k: (z[k].shape, z[k].dtype.str) for k in z.files}


@pytest.mark.parametrize("name, with_attrs", CASES, ids=IDS)
def test_meta_and_members_match_jax(jax_snapshots, tmp_path, name, with_attrs):
    path, _ = jax_snapshots[(name, with_attrs)]
    mine = tstore.save(tstore.load(path, device=CPU), str(tmp_path / "port"))
    jmeta, tmeta = jstore.peek(path), tstore.peek(mine)
    assert sorted(tmeta) == sorted(jmeta)
    for key in ("format_version", "engine", "statics", "attrs_statics", "quant_statics"):
        assert tmeta[key] == jmeta[key], key
    assert _members(mine) == _members(path)


def test_manifest_catches_a_flipped_byte_and_a_dropped_member(jax_snapshots, tmp_path):
    import shutil

    src, _ = jax_snapshots[("brute", True)]
    for mode in ("flip", "drop"):
        path = str(tmp_path / mode)
        shutil.copytree(src, path)
        member = os.path.join(path, tstore.peek(path)["arrays"])
        if mode == "drop":
            os.unlink(member)
        else:
            with open(member, "r+b") as f:
                f.seek(100)
                byte = f.read(1)
                f.seek(100)
                f.write(bytes([byte[0] ^ 0xFF]))
        for fn in (tstore.verify, lambda p: tstore.load(p, device=CPU)):
            with pytest.raises(tstore.SnapshotCorruption,
                               match="missing" if mode == "drop" else "sha256"):
                fn(path)


@pytest.mark.parametrize("version", [99, 0, "3"])
def test_format_version_gate_raises_as_jax(jax_snapshots, tmp_path, version):
    import shutil

    src, _ = jax_snapshots[("brute", False)]
    path = str(tmp_path / "v")
    shutil.copytree(src, path)
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path))
    meta["format_version"] = version
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError) as je:
        jstore.load(path)
    with pytest.raises(ValueError) as te:
        tstore.load(path, device=CPU)
    assert type(te.value) is ValueError and str(te.value) == str(je.value)


def test_flatten_round_trip_matches_jax():
    tree = {"a": [{"w": np.ones((2, 3))}, {"w": np.zeros(1)}], "b": np.arange(4),
            "c": torch.arange(3)}
    flat = tstore.flatten_arrays(tree)
    assert sorted(flat) == sorted(jstore.flatten_arrays(
        {**tree, "c": np.arange(3)}))
    back = tstore.unflatten_arrays(flat)
    assert isinstance(back["a"], list) and back["a"][1]["w"].shape == (1,)
    with pytest.raises(ValueError, match="may not contain"):
        tstore.flatten_arrays({"a/b": np.ones(1)})
