"""prep_s.paths: mean host seconds of a path_readset call in its prep steps (call.paths.prep:
the block split, each block's host preparation, upload and expansion on the card)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.host_s(tr, "call.paths", "call.path_readset", "call.paths.prep")
