"""reduce_s.count: mean device seconds of a count_readset call in its reduce step
(call.count.reduce: K3, K2, the stats unpacked, trim_table)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.device_s(tr, "call.count", "call.count_readset", "call.count.reduce")
