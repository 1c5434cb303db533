"""kernel_s.count: mean device seconds of a count_readset call in the port's kernels K1-K4."""
from benchmark import trace


def read(tr):
    return trace.device_s(tr, "call.count", port=True)
