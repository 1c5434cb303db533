"""kernel_roofline.paths: K1-K4's bytes in a path_readset call over 3.35 TB/s, as a share of
their device seconds."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.kernel_roofline(tr, "call.paths", "call.path_readset")
