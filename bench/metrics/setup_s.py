"""Set-up: process start to the window's start (imports, data, build,
mutations, warm-up; the kernels' build in a checkout's first run)."""


def read(run):
    return run.setup_s
