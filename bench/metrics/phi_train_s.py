"""Phi's training in the build: the program's device-synchronised stage
clock (``train_history["stage_seconds"]["train_phi"]``)."""


def read(run):
    return run.stage_seconds.get("train_phi")
