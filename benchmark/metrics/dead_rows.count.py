"""dead_rows.count: the share of a count_readset call's occurrence sort rows (K4's rows) that
hold the sentinel: positions past a read's good length or its last K-1, reads below
min_read_len, the bucket padding.  From the program's counters sort_rows and dead_sort_rows
(supernova_tpu_torch/stats/trace.py count_rows) over the window's calls; None where the program
keeps no such counter."""
from benchmark.metrics import program_spans


def read(tr):
    got = program_spans.window_log(tr, "call.count", "call.count_readset")
    if got is None:
        return None
    roots = [e for e in got[1] if e["name"] == "call.count_readset"]
    rows = sum(e.get("sort_rows", 0) for e in roots)
    return sum(e.get("dead_sort_rows", 0) for e in roots) / rows if rows > 0 else None
