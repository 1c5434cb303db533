"""torch_ops_s.count: mean device seconds of a count_readset call outside K1-K4 (torch operators,
copies)."""
from benchmark import trace


def read(tr):
    return trace.device_s(tr, "call.count", port=False)
