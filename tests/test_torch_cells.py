"""The dry-run layer of the port (``models/params`` abstract views,
``launch/cells``, ``launch/dryrun``, ``dist/roofline``'s whole-step
counters) on the CPU.

The cells' helpers are pure functions of a config (and a mesh's shape):
JAX's and the port's are held equal on every arch, a ``PartitionSpec``
read as the tuple of its entries, on meshes that need no devices (JAX's
FakeMesh way).  ``run_cell`` runs one LM, one GNN and one recsys cell on a
(2, 4) mesh of meta ranks and writes JAX's JSON layout; the one-rank run
of a meta mesh is held to every rank's run (flops, ops and collectives
equal, bytes within 1 %).
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import roofline as jroofline  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import roofline, sharding  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_meta_mesh  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

LM_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.family(a) == "lm"]
RECSYS_ARCHS = [a for a in tconfigs.ARCHS if tconfigs.family(a) == "recsys"]
MESHES = {"16x16": (16, 16), "2x4": (2, 4)}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


def _decls(arch):
    fam = tconfigs.family(arch)
    if fam == "lm":
        return ttf.lm_decls(tconfigs.get(arch)), jtf.lm_decls(jconfigs.get(arch))
    if fam == "gnn":
        return tgnn.gcn_decls(tconfigs.get(arch), 1433), jgnn.gcn_decls(jconfigs.get(arch), 1433)
    return trecsys.recsys_decls(tconfigs.get(arch)), jrecsys.recsys_decls(jconfigs.get(arch))


def _jleaves(tree, is_leaf=None):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)


def _tleaves(tree):
    """Leaves in JAX's order (dict keys sorted); a ``P`` or a tuple of
    names is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tleaves(v)]
    return [tree]


ALL_ARCHS = LM_ARCHS + ["gcn-cora"] + RECSYS_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_logical_specs_map_with_decls(arch):
    tdecls, jdecls = _decls(arch)
    t_abs = _tleaves(tparams.abstract_params(tdecls))
    j_abs = _jleaves(jparams.abstract_params(jdecls))
    assert [tuple(t.shape) for t in t_abs] == [tuple(j.shape) for j in j_abs]
    assert [str(t.dtype).removeprefix("torch.") for t in t_abs] == [str(j.dtype) for j in j_abs]
    assert all(t.device.type == "meta" for t in t_abs)
    is_names = lambda x: isinstance(x, tuple)  # noqa: E731
    assert (_tleaves(tparams.logical_specs(tdecls))
            == _jleaves(jparams.logical_specs(jdecls), is_leaf=is_names))
    sizes = lambda p, leaf: (p.shape, tuple(leaf.shape))  # noqa: E731
    t_map = _tleaves(tparams.map_with_decls(sizes, tdecls, tparams.abstract_params(tdecls)))
    j_map = _jleaves(jparams.map_with_decls(sizes, jdecls, jparams.abstract_params(jdecls)),
                     is_leaf=is_names)
    assert t_map == j_map


def test_map_with_decls_refuses_another_structure():
    tdecls, _ = _decls("deepfm")
    with pytest.raises(ValueError):
        tparams.map_with_decls(lambda p, x: x, tdecls, {"table": 0})


def test_registry_and_train_opts_are_jax_s():
    assert cells.LM_TRAIN_OPTS == jcells.LM_TRAIN_OPTS
    assert cells.all_cells() == jcells.all_cells()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_flops_and_active_params(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    assert cells._lm_active_params(tcfg) == jcells._lm_active_params(jcfg)
    for kind, tokens, kv in (("train", 256 * 4096, 4096), ("prefill", 32 * 32768, 16384),
                             ("decode", 128, 32768)):
        assert (cells._model_flops_lm(tcfg, tokens=tokens, kind=kind, kv_len=kv)
                == jcells._model_flops_lm(jcfg, tokens=tokens, kind=kind, kv_len=kv))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_dense_flops(arch):
    assert (cells._recsys_dense_flops(tconfigs.get(arch))
            == jcells._recsys_dense_flops(jconfigs.get(arch)))
    assert cells._pad_to(1_000_000, 512 * 2048) == jcells._pad_to(1_000_000, 512 * 2048)


def _jtuples(tree):
    return jax.tree_util.tree_map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs(arch, mesh, kind):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    t = cells._cache_specs(tcfg, sharding.lm_policy(tcfg, FakeMesh(MESHES[mesh]), kind=kind,
                                                    batch=128))
    j = jcells._cache_specs(jcfg, jsharding.lm_policy(jcfg, FakeMesh(MESHES[mesh]), kind=kind,
                                                      batch=128))
    assert jax.tree_util.tree_map(tuple, t, is_leaf=lambda s: isinstance(s, P)) == _jtuples(j)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_adafactor_spec_tree(arch, mesh):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    t = cells._adafactor_spec_tree(ttf.lm_decls(tcfg),
                                   sharding.lm_policy(tcfg, FakeMesh(MESHES[mesh])))
    j = jcells._adafactor_spec_tree(jtf.lm_decls(jcfg),
                                    jsharding.lm_policy(jcfg, FakeMesh(MESHES[mesh])))
    assert tuple(t.step) == tuple(j.step)
    assert ([tuple(s) for s in _tleaves(t.stats)]
            == [tuple(s) for s in _jleaves(j.stats, is_leaf=lambda s: isinstance(s, JP))])


def test_roofline_terms_dominance():
    """``tests/test_dist.py``'s inputs: JAX's keys, dominance and fraction
    arithmetic at the H100's peaks."""
    cost = {"flops": 1e15, "bytes accessed": 1e9}
    t = roofline.roofline_terms(cost, roofline.CollectiveStats(), chips=256,
                                model_flops=2.56e17)
    j = jroofline.roofline_terms(cost, jroofline.CollectiveStats({}, 0, 0, {}), chips=256,
                                 model_flops=2.56e17)
    assert t.keys() == j.keys()
    assert t["dominant"] == j["dominant"] == "compute"
    assert t["useful_flops_ratio"] == j["useful_flops_ratio"]
    assert t["t_compute_s"] == 1e15 / roofline.BF16_FLOPS
    assert t["t_memory_s"] == 1e9 / roofline.HBM_BW
    assert t["roofline_fraction"] == pytest.approx(
        t["t_compute_s"] / (t["t_compute_s"] + t["t_memory_s"]))
    coll = roofline.CollectiveStats()
    coll.add("all-reduce", 1e12)
    t = roofline.roofline_terms(cost, coll, chips=256)
    assert t["dominant"] == "collective" and t["t_collective_s"] == 1e12 / roofline.NVLINK_BW
    assert "useful_flops_ratio" not in t


# ---------------------------------------------------------------- run_cell

JAX_LAYOUT = {
    "top": {"arch", "shape", "mesh", "step", "ok", "lower_s", "compile_s", "memory", "cost",
            "collectives", "roofline", "meta"},
    "memory": {"argument_bytes_per_device", "output_bytes_per_device", "temp_bytes_per_device",
               "alias_bytes_per_device", "peak_estimate_gib"},
    "cost": {"xla_flops", "xla_bytes", "loop_aware_flops", "loop_aware_bytes", "dot_ops"},
    "collectives": {"total_bytes", "by_kind", "loop_trips"},
    "roofline": {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "roofline_fraction", "useful_flops_ratio"},
}


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-235b-a22b", "decode_32k"),
                                        ("gcn-cora", "molecule"),
                                        ("deepfm", "train_batch")])
def test_run_cell_on_a_meta_mesh(tmp_path, arch, shape):
    r = dryrun.run_cell(arch, shape, out_dir=str(tmp_path), mesh_shape=(2, 4))
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__2x4.json").read_text())
    assert on_disk["arch"] == arch and on_disk["mesh"] == "2x4"
    assert JAX_LAYOUT["top"] <= on_disk.keys()
    for key in ("memory", "cost", "collectives", "roofline"):
        assert JAX_LAYOUT[key] <= on_disk[key].keys(), key
    assert on_disk["compile_s"] is None and on_disk["cost"]["xla_flops"] is None
    cost, mem = r["cost"], r["memory"]
    assert cost["loop_aware_flops"] > 0 and cost["loop_aware_bytes"] > 0
    assert cost["loop_aware_flops"] * 8 == cost["counted_flops"]
    assert mem["argument_bytes_per_device"] > 0 and mem["temp_bytes_per_device"] > 0
    assert {"arch", "shape", "family", "model_flops"} <= r["meta"].keys()
    assert r["roofline"]["useful_flops_ratio"] == pytest.approx(
        r["meta"]["model_flops"] / cost["counted_flops"])
    if arch.startswith("qwen3"):
        # the EP's all-gathers and psums, one each a MoE layer (94), per device
        assert r["collectives"]["explicit"]["all-reduce"] > 0
        assert r["collectives"]["gspmd_implied"]["all-gather"] > 0


def test_run_cell_refuses_a_moe_cell_without_ep(tmp_path):
    with pytest.raises(ValueError, match="deepseek-v3-671b x long_500k"):
        dryrun.run_cell("deepseek-v3-671b", "long_500k", out_dir=str(tmp_path),
                        mesh_shape=(2, 4))


def test_one_rank_of_a_meta_mesh_counts_every_rank(monkeypatch):
    """An LM train step (``REDUCED`` qwen3-moe, every MoE layer through the
    EP ``shard_map`` with gradients) on a (2, 4) meta mesh: the one-rank
    run against every rank run."""
    cfg = tconfigs.get_reduced("qwen3-moe-235b-a22b")
    mesh = make_meta_mesh(shape=(2, 4))
    dctx = sharding.lm_policy(cfg, mesh, kind="train", batch=4)
    decls = ttf.lm_decls(cfg)
    opt = opt_lib.adamw(1e-3)
    from repro_torch.train import train_step as tsteps

    step = tsteps.make_train_step(cfg, "lm", opt, dctx, microbatches=2)
    got = {}
    for sym in (True, False):
        monkeypatch.setattr(sharding, "SYMMETRIC_META", sym)
        params = tparams.abstract_params(decls)
        batch = {"tokens": torch.empty((4, 16), dtype=torch.int32, device="meta")}
        with roofline.OpCounter() as c, roofline.collecting() as coll:
            step(params, opt.init(params), batch)
        got[sym] = c, coll
    (a, ca), (b, cb) = got[True], got[False]
    assert a.flops == b.flops and a.dot_ops == b.dot_ops and a.flops > 0
    assert ca.bytes_by_kind == cb.bytes_by_kind and ca.count == cb.count
    assert abs(a.bytes - b.bytes) <= 1e-2 * b.bytes
