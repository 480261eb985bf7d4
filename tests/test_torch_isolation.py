"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port leaves
``jax`` out of ``sys.modules``, and ``chip_smoke.py`` refuses to report a
result without a CUDA device or without the rest of the repo."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.search\n"
        "import repro_torch.kernels.topk, repro_torch.kernels.pdist, "
        "repro_torch.kernels.qpath, repro_torch.kernels.bag\n"
        "import repro_torch.kernels.bag.ops, repro_torch.models.recsys, "
        "repro_torch.configs, repro_torch.configs.deepfm, "
        "repro_torch.train.train_step, repro_torch.data.tokens\n"
        "import repro_torch.train.checkpoint, repro_torch.train.fault, "
        "repro_torch.train.optimizer, repro_torch.train.tree, "
        "repro_torch.dist.compression, repro_torch.launch.train\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun, "
        "repro_torch.launch.mesh, repro_torch.dist.roofline, repro_torch.dist.sharding\n"
        "import repro_torch.models.transformer, repro_torch.models.gnn, "
        "repro_torch.models.sampler, repro_torch.models.attention, "
        "repro_torch.models.moe, repro_torch.configs.deepseek_v3_671b, "
        "repro_torch.models.layers, repro_torch.configs.smollm_135m, "
        "repro_torch.configs.gcn_cora, repro_torch.configs.infinity_search\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "No module named 'repro_torch'" in res.stderr
