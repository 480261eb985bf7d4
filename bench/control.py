"""The readings the limits of ``correct`` are set from, beside a run's own:
the control and the planted faults.  Not part of a run.

    python3 bench/control.py --workload <cell> --seeds 11 12 13
    python3 bench/control.py --workload <cell> --seeds 11 12 13 --fault quarter_budget

Without ``--fault``: the control, the reference put in the program's place
and computed in TF32 (the precision below the float32 the configurations
state), answering every query of the query set (each query a run answers)
after the cell's set-up mutations.  With ``--fault``: a whole run of the
cell (``--seconds`` long) with the program broken as ``FAULTS`` says.
Either way it is judged by the same numbers and limits as a run and has to
come out not correct; one JSON line for each seed.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.harness import judge as judge_lib, spec as spec_lib  # noqa: E402
from bench.harness.system import Data, truth  # noqa: E402


def readings(cell, seed: int, device: torch.device) -> dict:
    cfg, tr = cell.config, cell.traffic
    k = int(tr["k"])
    data = Data(cfg, seed, device)
    _, rows, alive = truth(tr, data, seed)
    qids = np.arange(data.n_test)
    idx, dist = judge_lib.control_answers(data.queries, rows, alive, qids, k=k)
    numbers = judge_lib.judge(data.queries, rows, alive, qids, idx, dist, k=k,
                              exact=bool(cfg.get("exact", False)))
    correct, checks = judge_lib.verdict(numbers, cfg.get("limits", {}), 0)
    return {"workload": cell.name, "seed": seed, "correct": correct, "checks": checks,
            "recall": numbers["recall"]}


@contextlib.contextmanager
def _phi_bf16():
    """Phi evaluated under bf16 autocast, for the corpus and the queries."""
    from repro_torch.core import embedding

    orig = embedding.apply

    def low(phi, X, *a, **kw):
        with torch.autocast(X.device.type, dtype=torch.bfloat16):
            return orig(phi, X, *a, **kw).float()

    embedding.apply = low
    try:
        yield
    finally:
        embedding.apply = orig


#: the infinity engine's traversal faults: (override of the configuration,
#: the patch of the program), each a fault whose answers keep exact
#: distances, so that only ``recall_loss`` can see it
FAULTS = {
    "quarter_budget": ({"search": {"budget": 256, "rerank": 64}}, contextlib.nullcontext),
    "untrained_phi": ({"index": {"train_steps": 0}}, contextlib.nullcontext),
    "phi_bf16": ({}, _phi_bf16),
}


def fault_readings(cell, fault: str, seed: int, seconds: float,
                   device: torch.device) -> dict:
    from bench.harness import main as main_lib

    override, patch = FAULTS[fault]
    with patch():
        result, run = main_lib.execute(cell.override(override), seed=seed, seconds=seconds,
                                       trace=False, device=device,
                                       t_start=time.perf_counter(), log=lambda s: None)
    return {"workload": cell.name, "fault": fault, "seed": seed,
            "correct": result["correct"], "checks": result["checks"],
            "recall": run.judge.get("recall")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of the comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = spec_lib.Cell(spec_lib.load_spec(), args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        if args.fault:
            line = fault_readings(cell, args.fault, seed, args.seconds, device)
        else:
            line = readings(cell, seed, device)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
