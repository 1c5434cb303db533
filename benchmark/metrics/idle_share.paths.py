"""idle_share.paths: 1 - the device's busy time over the window of a paths cell."""
from benchmark import trace


def read(tr):
    return trace.idle_share(tr, "call.paths")
