"""Loop capture: abstract loop subgraphs of D into {-4} cell gap edges.

The port's own copy of supernova_tpu/asm/capture.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of 10X/Capture.cc.  Three shapes are captured (the reference runs
them inside CleanTheAssembly and the CP surgery stage — CleanThe.cc:2460,
CP.cc:872-873, Scaffold.cc:508-509):

* canonical loops (Capture.cc:769): v ==d1==> w, w ==d2==> v with exactly
  one other edge into v and one other out of w: replace {d1, d2} with a
  single cell edge v->w whose cell is the 2-vertex loop graph.
* simple loops (Capture.cc:661): self-loop e at a 2-in/2-out vertex v with
  through edges d: u->v and f: v->w: delete e, add a new vertex V and a
  cell edge v->V holding e, and re-root f at V.
* multi loops (Capture.cc:31): n>=2 self-loops at a vertex with single
  entry x and exit y: all loops collapse into one cell edge ahead of y.

Captured cells ride the supergraph as gap edges: FindLines treats them as
non-overlapping elements, and FASTA emission spells them via
cell::FindPath (asm/gap.py cell_find_path).  `reinsert_loops` is the
inverse edit (ReinsertLoops, Gap.cc:77-93) used before sequence-graph
export.

All edits are involution-symmetric: the rc cell row is rc_gap(row, binv)
(paths mapped through the base involution), so SuperGraph.validate holds.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.ragged import Ragged
from . import gap as agap


class GraphEditor:
    """Mutable view of a SuperGraph for structural surgery; `build`
    re-materializes (without compaction — callers recompact via
    inversion.delete_edges(force=True))."""

    def __init__(self, D):
        self.rows: List[np.ndarray] = [
            np.asarray(D.epaths.row(d), np.int64).copy() for d in range(D.n_edges)
        ]
        self.dinv: List[int] = [int(x) for x in D.dinv]
        self.from_v: List[int] = [int(x) for x in D.from_v]
        self.to_v: List[int] = [int(x) for x in D.to_v]
        self.n_vertices = int(D.n_vertices)
        self.bg = D.bg
        self.dels: List[int] = []

    @property
    def n_edges(self) -> int:
        return len(self.rows)

    def add_vertex(self) -> int:
        self.n_vertices += 1
        return self.n_vertices - 1

    def add_edge(self, v: int, w: int, row: np.ndarray, dinv: int = -1) -> int:
        self.rows.append(np.asarray(row, np.int64))
        self.from_v.append(int(v))
        self.to_v.append(int(w))
        self.dinv.append(int(dinv))
        return len(self.rows) - 1

    def out_edges(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.n_vertices)]
        for d, v in enumerate(self.from_v):
            out[v].append(d)
        return out

    def in_edges(self) -> List[List[int]]:
        inn: List[List[int]] = [[] for _ in range(self.n_vertices)]
        for d, v in enumerate(self.to_v):
            inn[v].append(d)
        return inn

    def transfer_vertex(self, old: int, new: int):
        """Move every edge endpoint at `old` to `new`
        (TransferEdgesWithUpdate analogue)."""
        for d in range(len(self.rows)):
            if self.from_v[d] == old:
                self.from_v[d] = new
            if self.to_v[d] == old:
                self.to_v[d] = new

    def is_gap(self, d: int) -> bool:
        r = self.rows[d]
        return len(r) > 0 and int(r[0]) < 0

    def build(self):
        from .supergraph import SuperGraph

        nd = len(self.rows)
        return SuperGraph(
            epaths=Ragged.from_rows(self.rows, dtype=np.int64)
            if nd
            else Ragged(np.zeros(0, np.int64), np.zeros(1, np.int64)),
            dinv=np.asarray(self.dinv, np.int64),
            from_v=np.asarray(self.from_v, np.int64),
            to_v=np.asarray(self.to_v, np.int64),
            n_vertices=self.n_vertices,
            bg=self.bg,
        )


def capture_canonical_loops(g: GraphEditor) -> int:
    """v ==d1==> w / w ==d2==> v two-edge loops -> one cell edge v->w
    (CaptureCanonicalLoops, Capture.cc:769-832)."""
    out, inn = g.out_edges(), g.in_edges()
    binv = g.bg.inv
    pairs: List[Tuple[int, int]] = []
    for v in range(g.n_vertices):
        if len(inn[v]) != 2 or len(out[v]) != 1:
            continue
        d1 = out[v][0]
        w = g.to_v[d1]
        if len(out[w]) != 2 or len(inn[w]) != 1:
            continue
        d2 = next((f for f in out[w] if g.to_v[f] == v), -1)
        if d2 < 0:
            continue
        # four distinct flanking vertices (no degenerate nests)
        flank = {g.from_v[f] for f in inn[v]} | {g.to_v[f] for f in out[w]}
        if len(flank) != 4:
            continue
        if g.is_gap(d1) or g.is_gap(d2):
            continue
        rd1, rd2 = g.dinv[d1], g.dinv[d2]
        if len({d1, d2, rd1, rd2}) != 4:
            continue
        pairs.append((d1, d2))
    pairs.sort()
    pset = set(pairs)
    new_of: dict = {}
    n = 0
    for d1, d2 in pairs:
        rd1, rd2 = g.dinv[d1], g.dinv[d2]
        if (rd1, rd2) not in pset:
            continue
        if (rd1, rd2) < (d1, d2):
            continue  # rc site handles the pair
        v, w = g.from_v[d1], g.to_v[d1]
        row = agap.cell_encode(
            0, 1, 2, [(0, 1, g.rows[d1]), (1, 0, g.rows[d2])]
        )
        e1 = g.add_edge(v, w, row)
        rrow = agap.rc_gap(row, binv)
        rv, rw = g.from_v[rd1], g.to_v[rd1]
        e2 = g.add_edge(rv, rw, rrow)
        g.dinv[e1] = e2
        g.dinv[e2] = e1
        g.dels.extend([d1, d2, rd1, rd2])
        n += 1
    return n


def capture_simple_loops(g: GraphEditor) -> int:
    """Self-loop at a 2-in/2-out vertex -> cell edge + re-rooted out edge
    (CaptureSimpleLoops, Capture.cc:661-747)."""
    out, inn = g.out_edges(), g.in_edges()
    binv = g.bg.inv
    sites: List[Tuple[int, int, int]] = []  # (e, f, v)
    for v in range(g.n_vertices):
        if len(inn[v]) != 2 or len(out[v]) != 2:
            continue
        loops = [d for d in out[v] if g.to_v[d] == v]
        if len(loops) != 1:
            continue
        e = loops[0]
        d = next(f for f in inn[v] if f != e)
        f = next(x for x in out[v] if x != e)
        u, w = g.from_v[d], g.to_v[f]
        if len({u, v, w}) != 3:
            continue
        if g.is_gap(e):
            continue
        rd, re, rf = g.dinv[d], g.dinv[e], g.dinv[f]
        if len({d, e, f, rd, re, rf}) != 6:
            continue
        sites.append((e, f, v))
    sites.sort()
    by_e = {e: (f, v) for e, f, v in sites}
    n = 0
    for e, f, v in sites:
        re = g.dinv[e]
        if re not in by_e or re < e:
            continue
        rf2, rv = by_e[re]
        # e site: v ->cell-> V, f re-rooted at V
        V = g.add_vertex()
        row = agap.cell_encode(0, 0, 1, [(0, 0, g.rows[e])])
        e1 = g.add_edge(v, V, row)
        g.from_v[f] = V
        # re site (rc image): rv ->cell(re)-> V', with rd = dinv[f]'s
        # successor re-rooted — symmetric edit
        V2 = g.add_vertex()
        rrow = agap.rc_gap(row, binv)
        e2 = g.add_edge(rv, V2, rrow)
        g.from_v[rf2] = V2
        g.dinv[e1] = e2
        g.dinv[e2] = e1
        g.dels.extend([e, re])
        n += 1
    return n


def capture_multi_loops(g: GraphEditor) -> int:
    """n>=2 self-loops at a single-entry/single-exit vertex -> one cell
    edge before the exit (CaptureMultiLoops, Capture.cc:31-108)."""
    out, inn = g.out_edges(), g.in_edges()
    binv = g.bg.inv
    sites: List[Tuple[int, int, int]] = []  # (v, x, y)
    for v in range(g.n_vertices):
        loops = [d for d in out[v] if g.to_v[d] == v]
        if len(loops) < 2:
            continue
        if len(out[v]) != len(loops) + 1 or len(inn[v]) != len(loops) + 1:
            continue
        x = next(d for d in inn[v] if g.from_v[d] != v)
        y = next(d for d in out[v] if g.to_v[d] != v)
        if (g.dinv[y], g.dinv[x]) < (x, y):
            continue  # rc site is canonical
        if len({x, y, g.dinv[x], g.dinv[y]}) != 4:
            continue
        if any(g.is_gap(d) for d in loops):
            continue
        sites.append((v, x, y))
    sites.sort()
    n = 0
    for v, x, y in sites:
        loops = sorted(d for d in g.out_edges()[v] if g.to_v[d] == v)
        if not loops:
            continue
        ry = g.dinv[y]
        rv = g.to_v[ry]
        row = agap.cell_encode(0, 0, 1, [(0, 0, g.rows[d]) for d in loops])
        rrow = agap.rc_gap(row, binv)
        N = g.add_vertex()
        N2 = g.add_vertex()
        e1 = g.add_edge(v, N, row)
        e2 = g.add_edge(N2, rv, rrow)
        g.dinv[e1] = e2
        g.dinv[e2] = e1
        g.from_v[y] = N
        g.to_v[ry] = N2
        rloops = sorted(g.dinv[d] for d in loops)
        g.dels.extend(loops)
        g.dels.extend(rloops)
        n += 1
    return n


END_SEARCH = 10  # BFS depth from a long line's end (Capture.cc:118)
MAX_MESS = 20  # max vertices in a captured mess (Capture.cc:119)
LONG_LINE = 10_000  # min line length (bases) flanking a mess (Capture.h:21)
MAX_EDGE_IN_LOOP = 2_000  # max kmers of any mess edge (Capture.h:22)


def capture_messy_loops(
    D,
    lines=None,
    allow_point: bool = False,
    long_line: int = LONG_LINE,
    max_edge_in_loop: int = MAX_EDGE_IN_LOOP,
):
    """Capture the tangle between two long lines into one {-4} cell edge
    (CaptureMessyLoops, Capture.cc:110-331): from the end vertex v of a
    long line L1, a bounded BFS finds the start vertex w of another long
    line L2; if the subgraph between them is closed (<= MAX_MESS+2
    vertices, no sources/sinks, no long or gap edges, no external
    attachments at v/w), its edges become a single cell edge v->w (plus
    rc), and the mess edges are deleted.  allow_point permits v == w.
    Messes containing gap/cell edges are skipped (the reference expands
    cells inline; we stay conservative).  Returns (D', n_captured)."""
    from ..core.kmer_codec import K
    from .inversion import delete_edges

    if lines is None:
        from .lines import find_lines

        lines = find_lines(D)
    g = GraphEditor(D)
    binv = g.bg.inv
    bkmers = D.bg.edges.lengths() - (K - 1)
    lens = np.zeros(g.n_edges, np.int64)
    for d in range(g.n_edges):
        if not g.is_gap(d):
            lens[d] = int(bkmers[np.asarray(g.rows[d], np.int64)].sum())
    llens = lines.lengths(D)

    out, inn = g.out_edges(), g.in_edges()
    long_left: dict = {}  # start vertex -> (line, first edge)
    long_right: list = []  # (end vertex, line, last edge)
    for li, ln in enumerate(lines.lines):
        if llens[li] < long_line:
            continue
        d_first = int(ln.elements[0].paths[0][0])
        d_last = int(ln.elements[-1].paths[0][-1])
        if not g.is_gap(d_first):
            long_left.setdefault(int(g.from_v[d_first]), (li, d_first))
        if not g.is_gap(d_last):
            long_right.append((int(g.to_v[d_last]), li, d_last))
    long_right.sort()

    n = 0
    for v, L1, d1 in long_right:
        # bounded forward BFS (Capture.cc:157-164)
        vs = {v}
        for _ in range(END_SEARCH):
            nxt = set(vs)
            for t in vs:
                for d in out[t]:
                    nxt.add(int(g.to_v[d]))
            if nxt == vs:
                break
            vs = nxt
        w = None
        for t in sorted(vs):
            if t in long_left and long_left[t][0] != L1:
                w, (L2, d2) = t, long_left[t]
                break
        if w is None:
            continue
        rd1, rd2 = g.dinv[d1], g.dinv[d2]
        if (rd2, rd1) <= (d1, d2):
            continue  # rc site handles it
        rv, rw = int(g.to_v[rd2]), int(g.from_v[rd1])
        if allow_point and v == w:
            if v == rv:
                continue
            seed = {v}
        else:
            if len({v, w, rv, rw}) != 4:
                continue
            seed = {v, w}

        # collect the mess vertices (Capture.cc:194-206)
        vs = set(seed)
        while len(vs) <= MAX_MESS + 2:
            nxt = set(vs)
            for t in vs:
                for d in out[t]:
                    if d != d2:
                        nxt.add(int(g.to_v[d]))
                for d in inn[t]:
                    if d != d1:
                        nxt.add(int(g.from_v[d]))
            if nxt == vs:
                break
            vs = nxt
        if len(vs) > MAX_MESS + 2:
            continue
        if any(not inn[t] or not out[t] for t in vs):
            continue  # source/sink inside the mess

        ds = set()
        for t in vs:
            for d in out[t]:
                if d != d2:
                    ds.add(d)
            for d in inn[t]:
                if d != d1:
                    ds.add(d)
        if not ds:
            continue
        # closure at the attachment points (Capture.cc:225-236)
        if any(d != d1 and d not in ds for d in inn[v]):
            continue
        if any(d != d2 and d not in ds for d in out[w]):
            continue
        # content gates (Capture.cc:241-249 + conservative cell/gap skip)
        if any(g.is_gap(d) or lens[d] > max_edge_in_loop for d in ds):
            continue
        if d1 in ds or d2 in ds or rd1 in ds or rd2 in ds:
            continue

        # encode the mess as a cell between v and w
        ds_sorted = sorted(ds)
        verts = sorted(
            {int(g.from_v[d]) for d in ds_sorted}
            | {int(g.to_v[d]) for d in ds_sorted}
            | {v, w}
        )
        vidx = {t: i for i, t in enumerate(verts)}
        cedges = [
            (vidx[int(g.from_v[d])], vidx[int(g.to_v[d])], g.rows[d])
            for d in ds_sorted
        ]
        row = agap.cell_encode(vidx[v], vidx[w], len(verts), cedges)
        rrow = agap.rc_gap(row, binv)
        if v != w:
            e1 = g.add_edge(v, w, row)
            e2 = g.add_edge(rv, rw, rrow)
        else:
            N = g.add_vertex()
            N2 = g.add_vertex()
            g.from_v[d2] = N
            e1 = g.add_edge(v, N, row)
            g.to_v[rd2] = N2
            e2 = g.add_edge(N2, rv, rrow)
        g.dinv[e1] = e2
        g.dinv[e2] = e1
        rds = {int(g.dinv[d]) for d in ds}
        g.dels.extend(sorted(ds | rds))
        # refresh adjacency for subsequent sites
        out, inn = g.out_edges(), g.in_edges()
        n += 1
    if n == 0:
        return D, 0
    D2 = g.build()
    D2 = delete_edges(D2, g.dels, force=True)
    return D2, n


def capture_loops(D, canonical: bool = True):
    """CaptureLoops / surgery-stage capture: multi + simple (+ canonical)
    loop capture, deletions applied, graph recompacted.  Returns
    (D', n_captured)."""
    from .inversion import delete_edges

    g = GraphEditor(D)
    n = capture_multi_loops(g)
    n += capture_simple_loops(g)
    if canonical:
        n += capture_canonical_loops(g)
    if n == 0:
        return D, 0
    D2 = g.build()
    D2 = delete_edges(D2, g.dels, force=True)
    return D2, n


XMAX_CANON = 4  # canonicalize cells with 3..4 parallel paths (CP.cc:1822)


def canonicalize_cells(D, lines=None):
    """Canon stage (CP.cc:1819-1860): a line cell with 3..XMAX_CANON
    parallel multi-edge paths is replaced by that many parallel SINGLE
    D-edges v->w (each path's base edges concatenated), plus the rc
    mirror.  Simplifies cells into plain bubbles ahead of SuperFiles /
    output.  Returns (D', n_canonicalized)."""
    from .inversion import delete_edges

    if lines is None:
        from .lines import find_lines

        lines = find_lines(D)
    g = GraphEditor(D)
    binv = np.asarray(g.bg.inv, np.int64)
    n = 0
    consumed: set = set()
    for ln in lines.lines:
        els = ln.elements
        for j in range(1, len(els) - 1):
            cell = els[j]
            npaths = len(cell.paths)
            if npaths <= 2 or npaths > XMAX_CANON:
                continue
            dels = sorted(int(e) for e in cell.edge_ids())
            if any(g.is_gap(d) for d in dels):
                continue
            if any(d in consumed for d in dels):
                continue
            d1 = int(els[j - 1].paths[0][-1])
            d2 = int(els[j + 1].paths[0][0])
            rd1, rd2 = int(g.dinv[d2]), int(g.dinv[d1])
            if len({d1, d2, rd1, rd2}) != 4:
                continue
            if (rd1, rd2) < (d1, d2):
                continue  # rc site is canonical
            v, w = int(g.to_v[d1]), int(g.from_v[d2])
            rv, rw = int(g.to_v[rd1]), int(g.from_v[rd2])
            news = []
            for p in cell.paths:
                news.append(
                    np.concatenate(
                        [np.asarray(g.rows[int(d)], np.int64) for d in p]
                    )
                )
            fwd_ids = [g.add_edge(v, w, x) for x in news]
            rc_ids = [
                g.add_edge(rv, rw, binv[x[::-1]]) for x in news
            ]
            for a, b in zip(fwd_ids, rc_ids):
                g.dinv[a] = b
                g.dinv[b] = a
            rdels = [int(g.dinv[d]) for d in dels]
            consumed.update(dels)
            consumed.update(rdels)
            g.dels.extend(dels + rdels)
            n += 1
    if n == 0:
        return D, 0
    D2 = g.build()
    D2 = delete_edges(D2, g.dels, force=True)
    return D2, n


def reinsert_loops(D):
    """Expand every {-4} cell edge back into live vertices/edges
    (ReinsertLoops, Gap.cc:11-93).  Self-inverse cell edges are left in
    place (the reference punts on them too).  Returns (D', n_reinserted)."""
    from .inversion import delete_edges

    g = GraphEditor(D)
    nd0 = g.n_edges
    n = 0
    for d in range(nd0):
        rd = g.dinv[d]
        if rd <= d:
            continue
        row = g.rows[d]
        if not (len(row) and int(row[0]) == -4):
            continue
        left, right, nv, cedges = agap.cell_decode(row)
        rleft, rright, rnv, rcedges = agap.cell_decode(g.rows[rd])
        assert len(cedges) == len(rcedges) and nv == rnv
        v, w = g.from_v[d], g.to_v[d]
        rv, rw = g.from_v[rd], g.to_v[rd]
        # new vertices for the cell interiors
        vmap = [g.add_vertex() for _ in range(nv)]
        rvmap = [g.add_vertex() for _ in range(rnv)]
        new_f: List[int] = []
        new_r: List[int] = []
        for (f, t, p) in cedges:
            new_f.append(g.add_edge(vmap[f], vmap[t], p))
        for (f, t, p) in rcedges:
            new_r.append(g.add_edge(rvmap[f], rvmap[t], p))
        for a, b in zip(new_f, new_r):
            g.dinv[a] = b
            g.dinv[b] = a
        # glue cell boundary onto D vertices (ReinsertLoop transfer order)
        g.transfer_vertex(vmap[left], v)
        g.transfer_vertex(rvmap[rleft], rv)
        if left == right:
            if w != v:
                g.transfer_vertex(w, v)
            if rw != rv:
                g.transfer_vertex(rw, rv)
        else:
            g.transfer_vertex(vmap[right], w)
            g.transfer_vertex(rvmap[rright], rw)
        g.dels.extend([d, rd])
        n += 1
    if n == 0:
        return D, 0
    D2 = g.build()
    D2 = delete_edges(D2, g.dels, force=True)
    return D2, n
