"""Port parity: the serving CLI, ``python -m repro_torch.launch.serve``,
against JAX's ``repro.launch.serve`` on the CPU: it exits 0 and prints
the stats keys JAX's prints, line by line, and ``--list-engines`` lists
the registry."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--n", "1024", "--queries", "64", "--batch", "16"]
_KEY = re.compile(r"([A-Za-z_/0-9]+)[=~]")


def _stat_keys(out: str) -> list:
    return [_KEY.findall(line) for line in out.splitlines() if "=" in line]


def test_cli_runs_and_prints_jax_stats_keys(capsys):
    # one intra-op thread: the test workers already fill the cores, and a
    # child with a thread per core waits on each of its many small ops
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", *ARGS],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    _jax_main(ARGS)
    jax_out = capsys.readouterr().out
    assert _stat_keys(res.stdout) == _stat_keys(jax_out)
    assert _stat_keys(res.stdout)[0][:3] == ["engine", "shards", "corpus"]


def _jax_main(args):
    old_argv = sys.argv
    sys.argv = ["serve", *args]
    try:
        jserve.main()
    finally:
        sys.argv = old_argv


def test_list_engines_matches_jax(capsys):
    """Every registry key JAX lists, ``sharded`` included."""
    tserve.main(["--list-engines"])
    mine = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    _jax_main(["--list-engines"])
    theirs = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert mine == theirs
    assert "live" in mine
