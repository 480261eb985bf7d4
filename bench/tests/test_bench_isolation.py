"""The benchmark stands apart from the JAX package: no module under
``bench/`` imports ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level
names compared whole, so ``repro_torch`` passes), the reference imports
nothing of the program, and the command refuses to report without a card
or without the program beside it."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from bench.harness import spec

BENCH = spec.ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")) + [BENCH / "data" / "manifold.py",
                                                              BENCH / "roofline" / "h100.py"]:
        mods = [m.split(".")[0] for m in _imports(path)]
        assert set(mods) <= {"__future__", "numpy", "torch"}, (path, mods)


def _run_command(cwd, workload="fmnist784-infinity-b512"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_the_command_exits_non_zero_without_a_card():
    out = _run_command(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_command_exits_non_zero_with_only_the_benchmark(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _run_command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
