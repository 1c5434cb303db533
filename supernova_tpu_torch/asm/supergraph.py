"""Supergraph D: digraphE<vec<int>> over base-graph edges + involution.

The port's own copy of supernova_tpu/asm/supergraph.py, kept equal to it by
tests/test_torch_hostcopies.py, apart from closures_to_graph: it takes the
device the closure glue runs on (and an `info` dict for the glue's route)
instead of a mesh.  The port imports nothing of the JAX package.

Reference analogues: TR's weak-branch trimming (Lawnmower, 10X/Lawnmower.cc)
and hairy-tip removal (cmd_main_asm.rs:54-68), MC's ClosuresToGraph
Vectorify collapse (10X/mergers/ClosuresToGraph.h:12-30: digraphE<int> ->
digraphE<vec<int>>), and CP's Cleaner/RemoveUnneededVertices compactions
(10X/CleanThe.cc).  Closure-based gluing across pair gaps (NucleateGraph)
lands in a later round; here D starts as the edge-level compaction of the
base graph, which downstream scaffolding/phasing consume.

Host-side by design: D has ~1e5-1e6 edges (SURVEY.md §7 "Hard parts" —
late-stage small graphs are legitimately host work; hb-scale stages stay on
device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core import dna
from ..core.kmer_codec import K
from ..core.ragged import Ragged

# Deep validate() after every surgery (the reference's paranoid Validate
# discipline).  Off in production (per-edge Python loops are a wall at
# 1e6 edges); the test suite turns it on via conftest so invariant breaks
# fail unit tests.  Overridable via --addin asm.supergraph.PARANOID=1.
PARANOID = False


@dataclass
class SuperGraph:
    """D: edges are paths (lists of base-edge ids) in the base graph."""

    epaths: Ragged  # D-edge -> base edge ids
    dinv: np.ndarray  # (ED,) involution
    from_v: np.ndarray  # (ED,) int32
    to_v: np.ndarray  # (ED,) int32
    n_vertices: int
    bg: object  # BaseGraph (sequence authority)

    @property
    def n_edges(self) -> int:
        return self.epaths.n_rows

    def is_gap(self, d: int) -> bool:
        """Gap edges carry a negative-coded row instead of a base-edge path
        (10X/Gap.h; see asm/gap.py)."""
        row = self.epaths.row(d)
        return len(row) > 0 and int(row[0]) < 0

    def gap_mask(self) -> np.ndarray:
        """(ED,) bool: True where the D-edge is a gap edge."""
        vals = self.epaths.values
        offs = self.epaths.offsets
        nonempty = offs[1:] > offs[:-1]
        first = vals[np.minimum(offs[:-1], len(vals) - 1)] if len(vals) else np.zeros(self.n_edges, np.int64)
        return nonempty & (first < 0)

    def edge_bases(self, d: int) -> np.ndarray:
        """Spell a D-edge: constituent base edges overlap by K-1.  {-3}
        sequence gaps spell their stored bases; N-type gaps have no base
        spelling (use edge_seq)."""
        path = self.epaths.row(d)
        if len(path) and path[0] < 0:
            from . import gap as agap

            if agap.is_seq_gap(path):
                return agap.gap_to_seq(path)[2]
            raise ValueError(f"D-edge {d} is an N-type gap edge (code {path[0]})")
        parts = [self.bg.edges.row(int(path[0]))]
        for e in path[1:]:
            parts.append(self.bg.edges.row(int(e))[K - 1 :])
        return np.concatenate(parts)

    def edge_tail_bases(self, d: int, n: int) -> np.ndarray:
        """Last <= n bases of a non-gap D-edge WITHOUT materializing the
        whole edge (long chains make edge_bases O(edge length); gap-filling
        only needs flank-sized context)."""
        path = self.epaths.row(d)
        if len(path) and path[0] < 0:
            return self.edge_bases(d)[-n:]
        parts = []
        got = 0
        for i in range(len(path) - 1, -1, -1):
            row = self.bg.edges.row(int(path[i]))
            if i > 0:
                row = row[K - 1 :]
            parts.append(row)
            got += len(row)
            if got >= n:
                break
        return np.concatenate(parts[::-1])[-n:]

    def edge_head_bases(self, d: int, n: int) -> np.ndarray:
        """First <= n bases of a non-gap D-edge (see edge_tail_bases)."""
        path = self.epaths.row(d)
        if len(path) and path[0] < 0:
            return self.edge_bases(d)[:n]
        parts = []
        got = 0
        for i in range(len(path)):
            row = self.bg.edges.row(int(path[i]))
            if i > 0:
                row = row[K - 1 :]
            parts.append(row)
            got += len(row)
            if got >= n:
                break
        return np.concatenate(parts)[:n]

    def edge_len(self, d: int) -> int:
        path = self.epaths.row(d)
        if len(path) and path[0] < 0:
            from . import gap as agap

            return agap.gap_repr_len(path)
        lens = self.bg.edges.lengths()[path]
        return int(lens.sum() - (len(path) - 1) * (K - 1))

    def edge_seq(self, d: int) -> str:
        path = self.epaths.row(d)
        if len(path) and path[0] < 0:
            from . import gap as agap

            if agap.is_seq_gap(path):
                return dna.codes_to_seq(agap.gap_to_seq(path)[2])
            return "N" * agap.gap_repr_len(path)
        return dna.codes_to_seq(self.edge_bases(d))

    def validate(self, deep: bool | None = None):
        """Graph invariants (the reference's Validate(hb,inv,D,dinv), run
        after every surgery — CP.cc:529,639,893,917,1038).

        Light checks (always, vectorized numpy — safe to call after every
        edit at any scale): involution, dinv length/gap symmetry, and the
        K-1 base-edge adjacency inside every non-gap D-edge.  Deep checks
        (per-edge Python loops: exact rc path mirror, per-vertex 47-mer
        consistency) run when `deep` — default is the PARANOID module
        constant, switched on by the test suite so any surgery that breaks
        an invariant fails its unit test, not a 10 Mb run."""
        if deep is None:
            deep = PARANOID
        from . import gap as agap

        ed = self.n_edges
        assert np.array_equal(self.dinv[self.dinv], np.arange(ed))
        lens = self.epaths.lengths()
        assert np.array_equal(lens[self.dinv], lens), "dinv length mismatch"
        gm = self.gap_mask()
        assert np.array_equal(gm[self.dinv], gm), "dinv gap-type mismatch"
        vals = self.epaths.values
        if len(vals) and ed:
            row_of = np.repeat(np.arange(ed), lens)
            pair = (row_of[1:] == row_of[:-1]) & ~gm[row_of[:-1]]
            a = vals[:-1][pair].astype(np.int64)
            b = vals[1:][pair].astype(np.int64)
            ok = self.bg.to_v[a] == self.bg.from_v[b]
            assert ok.all(), (
                f"K-1 adjacency broken at {int((~ok).sum())} junctions "
                f"(first D-edge {int(row_of[:-1][pair][~ok][0])})"
            )
        if not deep:
            return
        binv = self.bg.inv
        for d in range(ed):
            p = self.epaths.row(d)
            q = self.epaths.row(int(self.dinv[d]))
            if len(p) and p[0] < 0:
                assert np.array_equal(
                    q, agap.rc_gap(p, binv)
                ), f"gap dinv mismatch at {d}"
                continue
            assert np.array_equal(q, binv[p[::-1]]), f"dinv mismatch at {d}"
        # vertex consistency: edges leaving one vertex start with the same
        # 47-mer (inherited from the base graph); gap edges are exempt —
        # they join arbitrary vertices by construction (Gap.h note 1)
        outk = {}
        gapped_v = set()
        for d in range(ed):
            p = self.epaths.row(d)
            if len(p) and p[0] < 0:
                gapped_v.add(int(self.from_v[d]))
                gapped_v.add(int(self.to_v[d]))
                continue
            e0 = int(p[0])
            v = int(self.from_v[d])
            k47 = self.bg.edge_seq(e0)[: K - 1]
            outk.setdefault(v, set()).add(k47)
        for v, ks in outk.items():
            if v in gapped_v:
                continue
            assert len(ks) == 1, f"vertex {v}: {len(ks)} distinct out 47-mers"


def trim_weak_edges(
    bg,
    support: np.ndarray,
    min_tip_kmers: int = 2 * K,
    weak_support: int = 0,
    strong_support: int = 10,
    tips: bool = True,
) -> np.ndarray:
    """Edge deletion mask: hairy tips (dead-end edges <= 2K kmers,
    cmd_main_asm.rs:54-68; disabled with tips=False — genuine sequence ends
    are tips too) and unsupported fork branches whose sibling is strongly
    supported (Lawnmower's lopsided rule, 10X/Lawnmower.cc:3-25).
    Deletions are involution-symmetric.  Returns bool (E,) keep mask."""
    E = bg.n_edges
    keep = np.ones(E, dtype=bool)
    lens = bg.edges.lengths()
    kmers = lens - (K - 1)
    indeg = np.bincount(bg.to_v, minlength=bg.n_vertices)
    outdeg = np.bincount(bg.from_v, minlength=bg.n_vertices)

    # hairy tips: hanging edges (dead-end at either endpoint) that are short
    if tips:
        tip = ((indeg[bg.from_v] == 0) | (outdeg[bg.to_v] == 0)) & (
            kmers <= min_tip_kmers
        )
    else:
        tip = np.zeros(E, dtype=bool)
    # but keep isolated edges (both ends bare and long enough handled above)
    # weak fork branches
    weak = np.zeros(E, dtype=bool)
    from collections import defaultdict

    by_from = defaultdict(list)
    for e in range(E):
        by_from[int(bg.from_v[e])].append(e)
    for v, es in by_from.items():
        if len(es) < 2:
            continue
        sup = support[es]
        strong = sup.max()
        if strong >= strong_support:
            for e, s in zip(es, sup):
                if s <= weak_support and kmers[e] <= min_tip_kmers:
                    weak[e] = True

    drop = tip | weak
    drop = drop | drop[bg.inv]  # involution-symmetric
    keep &= ~drop
    # never delete everything
    if not keep.any():
        keep[:] = True
    return keep


def build_supergraph(bg, keep: np.ndarray | None = None) -> SuperGraph:
    """Vectorify-style compaction: chains of base edges through simple
    (in=1, out=1) vertices become single D-edges."""
    E = bg.n_edges
    if keep is None:
        keep = np.ones(E, dtype=bool)
    live = np.nonzero(keep)[0]
    indeg = np.zeros(bg.n_vertices, dtype=np.int64)
    outdeg = np.zeros(bg.n_vertices, dtype=np.int64)
    np.add.at(indeg, bg.to_v[live], 1)
    np.add.at(outdeg, bg.from_v[live], 1)

    # next[e] = f iff to_v[e] is a simple vertex joining exactly e -> f
    nxt = np.full(E, -1, dtype=np.int64)
    prv = np.full(E, -1, dtype=np.int64)
    # unique live out-edge per vertex
    out_edge = np.full(bg.n_vertices, -1, dtype=np.int64)
    in_edge = np.full(bg.n_vertices, -1, dtype=np.int64)
    for e in live:
        v = int(bg.from_v[e])
        if outdeg[v] == 1:
            out_edge[v] = e
        v = int(bg.to_v[e])
        if indeg[v] == 1:
            in_edge[v] = e
    for e in live:
        v = int(bg.to_v[e])
        if indeg[v] == 1 and outdeg[v] == 1:
            f = out_edge[v]
            if f >= 0 and f != e:
                nxt[e] = f
                prv[f] = e

    # break cycles at min edge id (deterministic, matches dbg/build.py)
    visited = np.zeros(E, dtype=bool)
    for e in live:
        if visited[e] or prv[e] != -1:
            continue
        c = e
        while c != -1 and not visited[c]:
            visited[c] = True
            c = nxt[c]
    for e in live:
        if not visited[e]:  # cycle member
            c, cyc = e, [e]
            visited[e] = True
            c = nxt[c]
            while c != e:
                visited[c] = True
                cyc.append(c)
                c = nxt[c]
            m = min(cyc)
            prv[m] = -1
            nxt[cyc[cyc.index(m) - 1]] = -1

    # chains -> D edges
    paths: List[np.ndarray] = []
    head_of = {}
    edge_of_base = np.full(E, -1, dtype=np.int64)
    for e in live:
        if prv[e] != -1:
            continue
        chain = [e]
        c = nxt[e]
        while c != -1:
            chain.append(c)
            c = nxt[c]
        d = len(paths)
        head_of[e] = d
        for b in chain:
            edge_of_base[b] = d
        paths.append(np.asarray(chain, dtype=np.int64))

    ed = len(paths)
    dinv = np.zeros(ed, dtype=np.int64)
    for d, p in enumerate(paths):
        # rc chain's head is inv of our tail
        dinv[d] = edge_of_base[int(bg.inv[p[-1]])]

    # D vertices: reuse base-graph vertices at chain endpoints
    from_v = np.array([bg.from_v[p[0]] for p in paths], dtype=np.int64)
    to_v = np.array([bg.to_v[p[-1]] for p in paths], dtype=np.int64)
    used_v = np.unique(np.concatenate([from_v, to_v])) if ed else np.zeros(0, np.int64)
    remap = {int(v): i for i, v in enumerate(used_v)}
    from_v = np.array([remap[int(v)] for v in from_v], dtype=np.int64)
    to_v = np.array([remap[int(v)] for v in to_v], dtype=np.int64)

    return SuperGraph(
        epaths=Ragged.from_rows(paths, dtype=np.int64) if ed else Ragged(np.zeros(0, np.int64), np.zeros(1, np.int64)),
        dinv=dinv,
        from_v=from_v,
        to_v=to_v,
        n_vertices=len(used_v),
        bg=bg,
    )


def closures_to_graph(bg, closures, min_over_bases: int | None = None,
                      device=None, info: dict | None = None, mesh=None) -> SuperGraph:
    """ClosuresToGraph analogue (10X/mergers/ClosuresToGraph.h): glue
    closure paths into the supergraph D by position-level nucleation —
    see asm/nucleate.py for the full construction (GetMatches overlap
    rules + boundary union-find + Vectorify), which duplicates repeat
    base edges into their distinct closure contexts.  `device` is where
    the closure glue may run (nucleate_graph's gate), `mesh` the shards of
    the mesh glue; `info` receives the glue's route, overflow counts and
    closure positions."""
    from .nucleate import nucleate_graph

    # min_over_bases=None -> adaptive gate (see nucleate_graph docstring)
    return nucleate_graph(
        bg, closures, min_over_bases=min_over_bases, device=device, info=info, mesh=mesh
    )


def super_edge_support(D: SuperGraph, base_counts: np.ndarray) -> np.ndarray:
    """Read support per D-edge = mean support of constituent base edges
    (gap edges carry no base edges -> 0)."""
    out = np.zeros(D.n_edges)
    for d in range(D.n_edges):
        if D.is_gap(d):
            continue
        out[d] = float(base_counts[D.epaths.row(d)].mean())
    return out


def super_edge_barcodes(D: SuperGraph, ebcx: Ragged) -> List[np.ndarray]:
    """Barcode set per D-edge (union of constituent base-edge barcodes;
    gap edges -> empty)."""
    out = []
    for d in range(D.n_edges):
        if D.is_gap(d):
            out.append(np.zeros(0, np.int64))
            continue
        bcs = [ebcx.row(int(e)) for e in D.epaths.row(d)]
        out.append(np.unique(np.concatenate(bcs)) if bcs else np.zeros(0, np.int64))
    return out


def append_gap_edges(
    D: SuperGraph,
    items: List[tuple],
) -> SuperGraph:
    """Append gap edges to D, involution-symmetrically.  Each item is
    (v, w, row, vr, wr): a gap edge v->w with payload `row` plus its rc
    partner vr->wr carrying rc_gap(row); when (v, w, row) IS its own rc
    image a single self-inverse edge is appended.  Returns a new
    SuperGraph sharing bg (the reference appends {-2} edges to D in Star,
    10X/Star.cc:8-27, and {-3} edges in Surgery/Patch)."""
    from . import gap as agap

    rows = list(D.epaths)
    dinv = list(D.dinv)
    from_v = list(D.from_v)
    to_v = list(D.to_v)
    binv = getattr(D.bg, "inv", None)  # only {-4} cell rows need it
    for v, w, row, vr, wr in items:
        row = np.asarray(row, dtype=np.int64)
        rrow = agap.rc_gap(row, binv)
        d = len(rows)
        if (vr, wr) == (v, w) and np.array_equal(rrow, row):
            rows.append(row)
            from_v.append(v)
            to_v.append(w)
            dinv.append(d)  # self-inverse gap edge
            continue
        rows.append(row)
        rows.append(rrow)
        from_v.extend([v, vr])
        to_v.extend([w, wr])
        dinv.extend([d + 1, d])
    return SuperGraph(
        epaths=Ragged.from_rows(rows, dtype=np.int64),
        dinv=np.asarray(dinv, dtype=np.int64),
        from_v=np.asarray(from_v, dtype=np.int64),
        to_v=np.asarray(to_v, dtype=np.int64),
        n_vertices=D.n_vertices,
        bg=D.bg,
    )
