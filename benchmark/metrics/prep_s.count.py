"""prep_s.count: mean host seconds of a count_readset call in its prep step (call.count.prep:
the padded copy, good lengths, pack_codes, the uploads, the expansion on the card)."""
from benchmark.metrics import program_spans


def read(tr):
    return program_spans.host_s(tr, "call.count", "call.count_readset", "call.count.prep")
