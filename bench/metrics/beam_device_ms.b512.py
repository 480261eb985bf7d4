"""Device milliseconds a batch of the beam's level loop: the whole device
time of the work launched from inside the profiled half's
``repro_torch.traversal`` ranges (the innermost range there), each launch
matched to its kernel by the profiler's correlation id, so that the loop's
kernels count however long after the range's close they run, over the
number of ``repro_torch.dispatch`` ranges."""
from bench.harness.stages import run_stages


def read(run):
    got = run_stages(run)
    rec = (got or {}).get("stages", {}).get("traversal")
    if not rec or not got["dispatches"] or rec["launched_s"] <= 0:
        return None
    return 1e3 * rec["launched_s"] / got["dispatches"]
