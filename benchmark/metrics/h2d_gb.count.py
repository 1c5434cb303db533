"""h2d_gb.count: mean GB a count_readset call uploads to the card (prepare_reads' copies)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.h2d_gb(tr, "call.count", "call.count_readset")
