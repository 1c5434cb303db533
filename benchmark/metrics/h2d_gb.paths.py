"""h2d_gb.paths: mean GB a path_readset call uploads to the card (each block's packed codes)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.h2d_gb(tr, "call.paths", "call.path_readset")
