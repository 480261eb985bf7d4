"""The build's sparse canonical projection: the program's device-synchronised
stage clock (``train_history["stage_seconds"]["projection"]``), the
``num_hops`` path-doubling sweeps on the qpath kernel (``minmax`` at
q = inf, ``logminplus`` at finite q)."""


def read(run):
    return run.stage_seconds.get("projection")
