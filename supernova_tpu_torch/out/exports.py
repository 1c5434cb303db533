"""Debug exports: the tada `bcmat` / `stats` / `scaf-graph` analogues.

The port's own copy of supernova_tpu/out/exports.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference: `tada bcmat <graph> <bcs> <mm-file>` writes the edge->barcode
incidence as a MatrixMarket coordinate/pattern file
(lib/tada/src/cmd_graph_stats.rs:89-115); `tada stats` writes a per-edge
TSV (id, len, num_bcs, exts; cmd_graph_stats.rs:19-51); `tada scaf-graph`
writes a barcode-overlap contig-proximity graph (scaf_graph.rs:84-97).
Same formats here, from the run-directory checkpoints; the pairwise
Jaccard loop is replaced with a vectorized per-barcode co-occurrence
expansion.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.ragged import Ragged


def write_bcmat(
    ebcx: Ragged, path: str | Path, comment: str = "edge -> bc matrix"
) -> Path:
    path = Path(path)
    n_edges = ebcx.n_rows
    max_bc = int(ebcx.values.max()) if len(ebcx.values) else 0
    with open(path, "w") as w:
        w.write("%%MatrixMarket matrix coordinate pattern general\n")
        w.write(f"% {comment}\n")
        w.write(f"{n_edges} {max_bc + 1} {len(ebcx.values)}\n")
        offs = ebcx.offsets
        for e in range(n_edges):
            for b in ebcx.values[offs[e] : offs[e + 1]]:
                w.write(f"{e + 1} {int(b) + 1}\n")
    return path


def load_bcmat(path: str | Path):
    """-> (n_edges, n_bcs, [(edge, bc)]) 0-based."""
    with open(path) as f:
        header = f.readline()
        assert header.startswith("%%MatrixMarket")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_edges, n_bcs, nnz = (int(x) for x in line.split())
        pairs = []
        for line in f:
            a, b = line.split()
            pairs.append((int(a) - 1, int(b) - 1))
    assert len(pairs) == nnz
    return n_edges, n_bcs, pairs


def write_graph_stats(bg, ebcx: Ragged | None, path: str | Path) -> Path:
    """Per-edge TSV: id, len, num_bcs, exts_left, exts_right, sequence
    (main_graph_stats, cmd_graph_stats.rs:29-51).  The reference's Exts
    nibbles become in/out degree at the edge's end vertices."""
    path = Path(path)
    E = bg.n_edges
    lens = bg.edges.lengths()
    nbcs = ebcx.lengths() if ebcx is not None else np.zeros(E, np.int64)
    out_deg = np.bincount(bg.from_v, minlength=bg.n_vertices)
    in_deg = np.bincount(bg.to_v, minlength=bg.n_vertices)
    with open(path, "w") as w:
        w.write("id\tlen\tnum_bcs\texts_left\texts_right\tsequence\n")
        for e in range(E):
            w.write(
                f"{e}\t{int(lens[e])}\t{int(nbcs[e])}\t"
                f"{int(in_deg[bg.from_v[e]])}\t{int(out_deg[bg.to_v[e]])}\t"
                f"{bg.edge_seq(e)}\n"
            )
    return path


def estimate_distance(
    intersection, union, s1, s2, total_diversity: float = 1.5e6
):
    """Barcode-overlap proximity score (scaf_graph.rs:16-22): excess shared
    barcodes over the chance expectation, Jaccard-normalized, as
    -log(expected distance).  Smaller = closer.  Vectorized."""
    intersection = np.asarray(intersection, np.float64)
    union = np.asarray(union, np.float64)
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    expected = s1 / total_diversity * s2
    exp_d = np.maximum(1.0, intersection - expected) * union / (s1 * s2)
    return -np.log(exp_d)


def build_bc_scaffold_graph(
    lens: np.ndarray,
    ebcx: Ragged,
    max_links: int = 5,
    min_ctg: int = 0,
    max_bcs: int = 1 << 30,
    min_bcs: int = 0,
    total_diversity: float = 1.5e6,
    max_dist: float = 2.0,
):
    """-> [(edge_i, edge_j, dist)], i < j, <= max_links best per source
    (build_bc_scaffold_graph, scaf_graph.rs:46-80).  Pairwise barcode-set
    intersections are computed by expanding per-barcode candidate groups
    into co-occurrence pairs (sorted-key unique-count), not by the
    reference's O(C^2) quick_jaccard loop."""
    lens = np.asarray(lens)
    sizes = ebcx.lengths()
    cand = np.flatnonzero((lens > min_ctg) & (sizes > min_bcs) & (sizes < max_bcs))
    if len(cand) < 2:
        return []
    # (barcode, candidate) incidence restricted to candidates
    in_cand = np.zeros(ebcx.n_rows, bool)
    in_cand[cand] = True
    edge_of_val = np.repeat(np.arange(ebcx.n_rows), sizes)
    keep = in_cand[edge_of_val]
    rank = np.zeros(ebcx.n_rows, np.int64)
    rank[cand] = np.arange(len(cand))
    ce = rank[edge_of_val[keep]]
    cb = np.asarray(ebcx.values)[keep].astype(np.int64)
    # ebcx rows are barcode multisets — dedupe (barcode, candidate) pairs
    pk = np.unique(cb * len(cand) + ce)
    cb, ce = pk // len(cand), pk % len(cand)
    # all within-barcode candidate pairs (a < b by candidate rank)
    grp_start = np.flatnonzero(np.r_[True, cb[1:] != cb[:-1]])
    grp_size = np.diff(np.r_[grp_start, len(cb)])
    grp_end = np.repeat(grp_start + grp_size, grp_size)  # per element
    i = np.arange(len(cb))
    c = grp_end - i - 1  # pairs contributed by element i
    first = np.repeat(i, c)
    csum = np.cumsum(c) - c
    second = np.arange(c.sum()) - np.repeat(csum, c) + first + 1
    a, b = ce[first], ce[second]
    key = a.astype(np.int64) * len(cand) + b
    ukey, inter = np.unique(key, return_counts=True)
    a, b = ukey // len(cand), ukey % len(cand)
    usizes = np.bincount(ce, minlength=len(cand))  # deduped set sizes
    s1, s2 = usizes[a], usizes[b]
    union = s1 + s2 - inter
    dist = estimate_distance(inter, union, s1, s2, total_diversity)
    ok = dist < max_dist
    a, b, dist = a[ok], b[ok], dist[ok]
    # keep the max_links best (smallest dist) per source a
    order = np.lexsort((dist, a))
    a, b, dist = a[order], b[order], dist[order]
    start = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    pos_in_grp = np.arange(len(a)) - np.repeat(start, np.diff(np.r_[start, len(a)]))
    keep = pos_in_grp < max_links
    return [
        (int(cand[x]), int(cand[y]), float(d))
        for x, y, d in zip(a[keep], b[keep], dist[keep])
    ]


def write_scaf_graph(
    lens, ebcx: Ragged, path: str | Path, **kw
) -> Path:
    """CSV "i, j, dist" lines (write_scaf_graph, scaf_graph.rs:84-97)."""
    path = Path(path)
    ovl = build_bc_scaffold_graph(lens, ebcx, **kw)
    with open(path, "w") as w:
        for i, j, v in ovl:
            w.write(f"{i}, {j}, {v}\n")
    return path
