"""peak_gib.paths: the allocated device peak over the window of a paths cell, GiB."""
from benchmark import trace


def read(tr):
    return trace.peak_gib(tr, "call.paths")
