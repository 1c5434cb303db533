"""place_s.paths: mean device seconds of a path_readset call in its place steps
(call.paths.place: slotting, seed chains, the blocks' concatenation)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.device_s(tr, "call.paths", "call.path_readset", "call.paths.place")
