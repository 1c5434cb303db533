"""join_s.paths: mean device seconds of a path_readset call in its join steps (call.paths.join:
K1, canonicalisation, the tail cut, the merge join and its value gathers)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.device_s(tr, "call.paths", "call.path_readset", "call.paths.join")
