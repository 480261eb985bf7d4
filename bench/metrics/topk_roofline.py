"""The topk kernel's share of its roofline in a live cell: the least time
the card could take for the selections the window needed, over the
profiler's device time of every launch of the kernel's three parts
(``csrc/topk.cu``: the norm pre-pass, the scan, the merge of the splits'
lists) in the profiled half.

The work is that of the live search's selection, counted from the shapes
whatever computes it: for each batch, the k nearest among the alive rows
(frozen and delta) of every query of the padded batch."""
import re

from bench.roofline.h100 import knn_work, least_seconds

KERNELS = re.compile(r"(^|::)(sqnorm_kernel|topk_kernel|merge_kernel)$")


def read(run):
    prof = run.profile
    if not prof or not prof.get("batches"):
        return None
    measured = sum(sec for name, sec in prof["kernels"].items() if KERNELS.search(name))
    if measured <= 0:
        return None
    s = run.shapes
    flops, nbytes = knn_work(s["batch"], s["rows_alive"], s["dim"], s["k"])
    return 100.0 * prof["batches"] * least_seconds(flops, nbytes) / measured
