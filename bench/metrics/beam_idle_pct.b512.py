"""Share of the beam's level loop in which the card ran nothing: of the
time inside the profiled half's ``repro_torch.traversal`` ranges (the
innermost range there), the part in which no kernel, copy or set ran."""
from bench.harness.stages import run_stages


def read(run):
    got = run_stages(run)
    rec = (got or {}).get("stages", {}).get("traversal")
    if not rec or rec["wall_s"] <= 0:
        return None
    return 100.0 * rec["idle_s"] / rec["wall_s"]
