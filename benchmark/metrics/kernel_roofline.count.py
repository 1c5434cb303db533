"""kernel_roofline.count: K1-K4's bytes in a count_readset call over 3.35 TB/s, as a share of
their device seconds."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.kernel_roofline(tr, "call.count", "call.count_readset")
