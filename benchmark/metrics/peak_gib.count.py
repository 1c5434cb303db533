"""peak_gib.count: the allocated device peak over the window of a count cell, GiB."""
from benchmark import trace


def read(tr):
    return trace.peak_gib(tr, "call.count")
