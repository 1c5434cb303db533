"""host_s.count: mean seconds of a count_readset call with the card idle (host preparation, H2D
waits)."""
from benchmark import trace


def read(tr):
    return trace.host_s(tr, "call.count")
