"""Mean of the comparisons the program reports for each answered query
(tree visits plus the rerank's width), over the traced run."""


def read(run):
    if run.comparisons.size == 0:
        return None
    return float(run.comparisons.mean())
