"""GFA1 export of the unipath graph and the supergraph.

The port's own copy of supernova_tpu/out/gfa.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of the reference's graph export commands (`tada gfa`,
lib/tada/src/cmd_graph_stats.rs; scaf_graph.rs): segments are canonical
edges (one per rc pair), links carry the K-1 overlap, and supergraph
segments record their base-edge paths in a PT tag.
"""
from __future__ import annotations

import gzip
import numpy as np

from ..core.kmer_codec import K


def _open(path, mode="wt"):
    path = str(path)
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def write_gfa(bg, path) -> int:
    """Base graph -> GFA1.  Segments = canonical edges; links = vertex
    adjacencies with K-1 overlap, orientation from the involution."""
    inv = bg.inv
    canon = np.arange(bg.n_edges) <= inv

    def seg_ref(e: int):
        """edge id -> (segment name, orientation)."""
        if canon[e]:
            return f"E{e}", "+"
        return f"E{int(inv[e])}", "-"

    n = 0
    with _open(path) as f:
        f.write("H\tVN:Z:1.0\n")
        for e in np.nonzero(canon)[0]:
            f.write(f"S\tE{int(e)}\t{bg.edge_seq(int(e))}\n")
            n += 1
        seen = set()
        by_from = {}
        for e in range(bg.n_edges):
            by_from.setdefault(int(bg.from_v[e]), []).append(e)
        for e in range(bg.n_edges):
            for g in by_from.get(int(bg.to_v[e]), ()):
                a, ao = seg_ref(e)
                b, bo = seg_ref(int(g))
                key = (a, ao, b, bo)
                rkey = (b, "+-"[bo == "+"], a, "+-"[ao == "+"])
                if key in seen or rkey in seen:
                    continue
                seen.add(key)
                f.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t{K - 1}M\n")
    return n


def write_gfa_super(D, path) -> int:
    """Supergraph -> GFA1 with PT tags recording base-edge paths."""
    dinv = D.dinv
    canon = np.arange(D.n_edges) <= dinv

    def seg_ref(d: int):
        if canon[d]:
            return f"D{d}", "+"
        return f"D{int(dinv[d])}", "-"

    gap = D.gap_mask()
    n = 0
    with _open(path) as f:
        f.write("H\tVN:Z:1.0\n")
        for d in np.nonzero(canon)[0]:
            row = D.epaths.row(int(d))
            if gap[d]:
                # gap edges: GP tag records the Gap.h code payload
                gp = ",".join(str(int(x)) for x in row[: min(len(row), 4)])
                f.write(f"S\tD{int(d)}\t{D.edge_seq(int(d))}\tGP:Z:{gp}\n")
            else:
                pt = ",".join(str(int(e)) for e in row)
                f.write(f"S\tD{int(d)}\t{D.edge_seq(int(d))}\tPT:Z:{pt}\n")
            n += 1
        seen = set()
        by_from = {}
        for d in range(D.n_edges):
            by_from.setdefault(int(D.from_v[d]), []).append(d)
        for d in range(D.n_edges):
            for g in by_from.get(int(D.to_v[d]), ()):
                a, ao = seg_ref(d)
                b, bo = seg_ref(int(g))
                key = (a, ao, b, bo)
                rkey = (b, "+-"[bo == "+"], a, "+-"[ao == "+"])
                if key in seen or rkey in seen:
                    continue
                seen.add(key)
                ov = 0 if (gap[d] or gap[int(g)]) else K - 1
                f.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t{ov}M\n")
    return n
