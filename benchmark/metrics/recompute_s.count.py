"""recompute_s.count: mean device seconds of a count_readset call in its adjacency recompute
(call.count.recompute: the 8 membership joins)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.device_s(tr, "call.count", "call.count_readset", "call.count.recompute")
