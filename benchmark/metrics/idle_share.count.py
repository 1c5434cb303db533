"""idle_share.count: 1 - the device's busy time over the window of a count cell."""
from benchmark import trace


def read(tr):
    return trace.idle_share(tr, "call.count")
