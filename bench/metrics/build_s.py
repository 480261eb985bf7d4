"""Re-index time: the device-synchronised wall time from the corpus on the
card to an index ready to answer (the server's build and the beam's
flattened tree), measured once in set-up."""


def read(run):
    return run.build_s
