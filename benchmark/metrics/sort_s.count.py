"""sort_s.count: mean device seconds of a count_readset call in its sort step (call.count.sort:
K1, canonicalisation, the attributes and the tail cut, K4's occurrence sort and its gathers)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.device_s(tr, "call.count", "call.count_readset", "call.count.sort")
