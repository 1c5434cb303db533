"""kernel_s.paths: mean device seconds of a path_readset call in the port's kernels K1-K4."""
from benchmark import trace


def read(tr):
    return trace.device_s(tr, "call.paths", port=True)
