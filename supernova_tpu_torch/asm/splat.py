"""Splat: patch DF's original gap closures back into the supergraph.

The port's own copy of supernova_tpu/asm/splat.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of 10X/Splat.cc (called at CP's `post` stage, CP.cc:1211-1224)
plus the {-2}->{-1} gap conversion that precedes it (CP.cc:1233-1257):

1. `convert_bc_gaps`: a barcode-only gap whose flanking edges are linked
   by a placed read pair becomes a {-1} pair gap.
2. `splat`: for each {-1} pair gap d between simple vertices, look for
   closure paths (a.cpaths) that run from a suffix edge of the incoming
   D-edge d1 into a prefix edge of the outgoing D-edge d2 (windows of
   MAX_BACK=100 kmers).  With 1..MAX_PATHS=4 unique bridges: trim the
   windows off d1/d2, add each bridge as a real sequence D-edge v->w
   (plus rc), and delete the gap edge.  Empty leftover edges are removed
   with a vertex merge (Splat.cc:150-160).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.kmer_codec import K
from .capture import GraphEditor

MAX_BACK = 100  # kmers of play on each flank (Splat.cc:37)
MAX_PATHS = 4  # max distinct bridges per gap (Splat.cc:38)


def convert_bc_gaps(D, dpaths: np.ndarray, dlen: np.ndarray):
    """{-2} gaps with read-pair linkage become {-1} pair gaps
    (CP.cc:1233-1257).  Mate of read i is i^1; mate placements are on the
    rc strand, so linkage tests dinv[g] membership.  Returns (D', n)."""
    from . import gap as agap
    from ..core.ragged import Ragged
    from .supergraph import SuperGraph

    nd = D.n_edges
    gm = D.gap_mask()
    # per-D-edge read lists
    by_edge: Dict[int, List[int]] = {}
    R = len(dlen)
    for i in range(R):
        for j in range(int(dlen[i])):
            by_edge.setdefault(int(dpaths[i, j]), []).append(i)
    inn: Dict[int, List[int]] = {}
    out: Dict[int, List[int]] = {}
    for d in range(nd):
        out.setdefault(int(D.from_v[d]), []).append(d)
        inn.setdefault(int(D.to_v[d]), []).append(d)

    rows = list(D.epaths)
    n = 0
    for d in range(nd):
        rd = int(D.dinv[d])
        if rd <= d or not agap.is_bc_gap(rows[d]):
            continue
        v, w = int(D.from_v[d]), int(D.to_v[d])
        ins = [f for f in inn.get(v, []) if f != d]
        outs = [g for g in out.get(w, []) if g != d]
        if len(ins) != 1 or len(outs) != 1:
            continue
        f, g = ins[0], outs[0]
        rg = int(D.dinv[g])
        linked = False
        for rid in by_edge.get(f, []):
            mate = rid ^ 1
            if mate >= R:
                continue
            md = dpaths[mate, : int(dlen[mate])]
            if (md == rg).any():
                linked = True
                break
        if linked:
            rows[d] = agap.pair_gap()
            rows[rd] = agap.pair_gap()
            n += 2
    if n == 0:
        return D, 0
    return (
        SuperGraph(
            epaths=Ragged.from_rows(rows, dtype=np.int64),
            dinv=D.dinv.copy(),
            from_v=D.from_v.copy(),
            to_v=D.to_v.copy(),
            n_vertices=D.n_vertices,
            bg=D.bg,
        ),
        n,
    )


def _window(kmers: np.ndarray, path: np.ndarray, from_end: bool) -> int:
    """Number of path edges (suffix if from_end else prefix) summing to
    >= MAX_BACK kmers (Splat.cc:53-67)."""
    n, play = 0, 0
    idx = range(len(path) - 1, -1, -1) if from_end else range(len(path))
    for i in idx:
        n += int(kmers[int(path[i])])
        play += 1
        if n >= MAX_BACK:
            break
    return play


def splat(D, cpaths: List[np.ndarray]):
    """Patch closures into {-1} pair gaps (Splat.cc:18-160).  Returns
    (D', n_gaps_patched); D' is recompacted but not otherwise cleaned —
    callers follow with their cleanup passes as CP does."""
    from . import gap as agap
    from .inversion import delete_edges

    if not cpaths:
        return D, 0
    binv = np.asarray(D.bg.inv, np.int64)
    kmers = D.bg.edges.lengths() - (K - 1)

    # index closure paths by base edge (Splat.cc:28-32)
    pos: Dict[int, List[Tuple[int, int]]] = {}
    for ci, cp in enumerate(cpaths):
        for j, e in enumerate(np.asarray(cp, np.int64)):
            pos.setdefault(int(e), []).append((ci, j))

    g = GraphEditor(D)
    inn, out = g.in_edges(), g.out_edges()
    edits = []
    for d in range(g.n_edges):
        row = g.rows[d]
        if not agap.is_pair_gap(row) or g.dinv[d] < d:
            continue
        v, w = g.from_v[d], g.to_v[d]
        if len(out[v]) != 1 or len(inn[v]) != 1:
            continue
        if len(out[w]) != 1 or len(inn[w]) != 1:
            continue
        d1, d2 = inn[v][0], out[w][0]
        x1, x2 = g.rows[d1], g.rows[d2]
        if g.is_gap(d1) or g.is_gap(d2):
            continue
        play0 = _window(kmers, x1, from_end=True)
        play1 = _window(kmers, x2, from_end=False)
        zset = []
        w0 = len(x1) - play0
        for i1 in range(w0, len(x1)):
            e1 = int(x1[i1])
            for (p1, k1) in pos.get(e1, []):
                if i1 > w0 and k1 > 0:
                    continue  # interior window edge: closure must start here
                for i2 in range(play1):
                    e2 = int(x2[i2])
                    for (p2, k2) in pos.get(e2, []):
                        if p1 != p2 or k1 > k2:
                            continue
                        cp = np.asarray(cpaths[p1], np.int64)
                        if i2 < play1 - 1 and k2 < len(cp) - 1:
                            continue  # interior: closure must end here
                        z = np.concatenate(
                            [x1[w0:i1], cp[k1 : k2 + 1], x2[i2 + 1 : play1]]
                        )
                        zset.append(tuple(int(t) for t in z))
        zset = sorted(set(zset))
        if not zset or len(zset) > MAX_PATHS:
            continue
        left = x1[w0:].copy()
        right = x2[:play1].copy()
        edits.append((d, d1, d2, left, right, [np.asarray(z, np.int64) for z in zset]))

    n_edits = 0
    for d, d1, d2, left, right, Z in edits:
        rd = g.dinv[d]
        rd1, rd2 = g.dinv[d1], g.dinv[d2]
        if len({d1, d2, rd1, rd2}) != 4:
            continue
        x1, x2 = g.rows[d1], g.rows[d2]
        if len(left) > len(x1) or not np.array_equal(x1[len(x1) - len(left) :], left):
            continue
        if len(right) > len(x2) or not np.array_equal(x2[: len(right)], right):
            continue
        v, w = g.from_v[d], g.to_v[d]
        rv, rw = g.from_v[rd], g.to_v[rd]
        g.rows[d1] = x1[: len(x1) - len(left)]
        g.rows[d2] = x2[len(right) :]
        g.rows[rd1] = binv[g.rows[d1][::-1]]
        g.rows[rd2] = binv[g.rows[d2][::-1]]
        for z in Z:
            a = g.add_edge(v, w, z)
            b = g.add_edge(rv, rw, binv[z[::-1]])
            g.dinv[a] = b
            g.dinv[b] = a
        g.dels.extend([d, rd])
        n_edits += 1
    if n_edits == 0:
        return D, 0

    # remove now-empty edges with a vertex merge (Splat.cc:150-160)
    dels = set(g.dels)
    empties = [
        d for d in range(g.n_edges) if len(g.rows[d]) == 0 and d not in dels
    ]
    for d in empties:
        v, w = g.from_v[d], g.to_v[d]
        dels.add(d)
        if v != w:
            g.transfer_vertex(v, w)
    D2 = g.build()
    D2 = delete_edges(D2, sorted(dels), force=True)
    return D2, n_edits
