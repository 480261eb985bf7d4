"""Mean overlap of each answer's 10 ids with the reference's exact top 10,
over every answer of the window."""


def read(run):
    return run.judge.get("recall")
