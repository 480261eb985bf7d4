"""Kernel launches a batch: the CUDA runtime's launch calls
(``bench.harness.stages.LAUNCHES``) that start inside a
``repro_torch.dispatch`` range of the profiled half, over the number of
those ranges."""
from bench.harness.stages import run_stages


def read(run):
    got = run_stages(run)
    if not got or not got["dispatches"]:
        return None
    return got["dispatch_launches"] / got["dispatches"]
