"""torch_ops_s.paths: mean device seconds of a path_readset call outside K1-K4 (torch operators,
copies)."""
from benchmark import trace


def read(tr):
    return trace.device_s(tr, "call.paths", port=False)
