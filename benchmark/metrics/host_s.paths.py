"""host_s.paths: mean seconds of a path_readset call with the card idle (prepare_reads_packed,
block splitting)."""
from benchmark import trace


def read(tr):
    return trace.host_s(tr, "call.paths")
