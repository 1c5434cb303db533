"""dead_rows.paths: the share of a path_readset call's dictionary queries, over all its blocks,
that cannot hold a read's kmer: positions past a read's last K-1 and the padding of each block
to its siblings' shape.  From the program's counters join_rows and dead_join_rows
(supernova_tpu_torch/stats/trace.py count_rows) over the window's calls; None where the program
keeps no such counter."""
from benchmark.metrics import program_spans


def read(tr):
    got = program_spans.window_log(tr, "call.paths", "call.path_readset")
    if got is None:
        return None
    roots = [e for e in got[1] if e["name"] == "call.path_readset"]
    rows = sum(e.get("join_rows", 0) for e in roots)
    return sum(e.get("dead_join_rows", 0) for e in roots) / rows if rows > 0 else None
