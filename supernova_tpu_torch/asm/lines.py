"""Line decomposition of the supergraph.

The port's own copy of supernova_tpu/asm/lines.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of FindLines (paths/long/large/Lines.h:16-47): a line is a maximal
alternating chain [cell, cell, ...] where a cell is the set of paths through
a single-entry/single-exit subgraph (a superbubble), bounded by
MAX_CELL_PATHS=20 and MAX_CELL_DEPTH=5 (10X/Heuristics.h:20-21).  A straight
stretch is a cell with one single-edge path; a simple het bubble is a cell
with two parallel paths.  Lines carry the involution (LineInv) and length
stats (GetLineLengths/LineN50 — 10X/LineLine.h analogues).

The reference stores a line as vec<vec<vec<int>>> (elements -> paths ->
edges); `Line.elements: List[Cell]`, `Cell.paths: List[np.ndarray]` is the
same shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.kmer_codec import K

MAX_CELL_PATHS = 20  # 10X/Heuristics.h:20
MAX_CELL_DEPTH = 5  # 10X/Heuristics.h:21 (nesting depth in the reference)
# The reference bounds cells tightly and handles megabubbles at the
# lines-of-lines level (FindLineLines + ScafLinePrinter).  Here cells
# capture megabubble-scale regions directly: the PATH-COUNT bound (20)
# still caps enumeration work, but arms may be long — phasing, pseudohap
# arm choice, and busting all operate on cells, so deep two-arm regions
# phase exactly like small bubbles.
_MAX_CELL_PATH_EDGES = 64  # max edges per cell path
_MAX_CELL_STEPS = 256  # superbubble search bound (vertices)


@dataclass
class Cell:
    """Paths through one line element (entry -> exit)."""

    paths: List[np.ndarray]

    def __len__(self) -> int:  # number of parallel paths ("arms")
        return len(self.paths)

    def edge_ids(self) -> np.ndarray:
        if not self.paths:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(self.paths))

    def is_straight(self) -> bool:
        return len(self.paths) == 1 and len(self.paths[0]) == 1


def _as_cell(el) -> Cell:
    """Normalize a raw array of parallel edge ids (legacy form) to a Cell."""
    if isinstance(el, Cell):
        return el
    arr = np.asarray(el, dtype=np.int64).ravel()
    return Cell([np.array([e], dtype=np.int64) for e in arr])


@dataclass
class Line:
    """elements[i] = Cell (1 path = straight, 2+ paths = bubble/cell)."""

    elements: List[Cell]

    def __post_init__(self):
        self.elements = [_as_cell(el) for el in self.elements]

    def edges(self) -> np.ndarray:
        if not self.elements:
            return np.zeros(0, np.int64)
        return np.concatenate([el.edge_ids() for el in self.elements])

    def n_bubbles(self) -> int:
        return sum(1 for el in self.elements if len(el) == 2)


@dataclass
class Lines:
    lines: List[Line]
    line_of_edge: np.ndarray  # (ED,) line id or -1
    linv: np.ndarray  # (L,) line involution

    @property
    def n_lines(self) -> int:
        return len(self.lines)

    def lengths(self, D) -> np.ndarray:
        """Per-line length in bases (longest path through each cell).
        N-type gap edges ({-1}/{-2}/{-4}) do not overlap their neighbors by
        K-1, so junctions around them skip the overlap subtraction."""
        out = np.zeros(self.n_lines, dtype=np.int64)
        elens = np.array([D.edge_len(d) for d in range(D.n_edges)], dtype=np.int64)
        no_ov = _no_overlap_mask(D)
        for i, ln in enumerate(self.lines):
            total = 0
            prev_last = -1
            for j, el in enumerate(ln.elements):
                total += max(cell_path_len(elens, p, no_ov) for p in el.paths)
                if j:
                    first = int(el.paths[0][0])
                    if not (no_ov[prev_last] or no_ov[first]):
                        total -= K - 1
                prev_last = int(el.paths[0][-1])
            out[i] = total
        return out


def _no_overlap_mask(D) -> np.ndarray:
    """(ED,) True for gap edges with no K-1 overlap ({-1}/{-2}/{-4};
    {-3} sequence gaps DO overlap — Gap.h:28-43)."""
    from .gap import is_seq_gap

    mask = D.gap_mask().copy()
    for d in np.nonzero(mask)[0]:
        if is_seq_gap(D.epaths.row(int(d))):
            mask[d] = False
    return mask


def cell_path_len(
    elens: np.ndarray, path: np.ndarray, no_ov: np.ndarray | None = None
) -> int:
    """Bases spelled by a D-edge path (consecutive edges overlap by K-1,
    except at junctions touching a no-overlap gap edge)."""
    total = int(elens[path].sum())
    if no_ov is None:
        return total - (len(path) - 1) * (K - 1)
    for a, b in zip(path, path[1:]):
        if not (no_ov[int(a)] or no_ov[int(b)]):
            total -= K - 1
    return total


def _superbubble_exit(
    v: int,
    out_adj: Dict[int, List[Tuple[int, int]]],
    in_adj: Dict[int, List[Tuple[int, int]]],
    max_steps: int = _MAX_CELL_STEPS,
) -> int | None:
    """Exit vertex of the superbubble entered at v, or None (standard
    single-entry/single-exit detection with a step bound)."""
    state: Dict[int, int] = {v: 1}  # 1 = seen, 2 = visited
    stack = [v]
    steps = 0
    n_seen = 1
    while stack:
        u = stack.pop()
        if state.get(u) != 2:
            n_seen -= 1
        state[u] = 2
        steps += 1
        if steps > max_steps:
            return None
        kids = out_adj.get(u, [])
        if not kids:
            return None  # tip inside the bubble
        for c, _e in kids:
            if c == v:
                return None  # cycle back to the entrance
            if state.get(c, 0) == 0:
                state[c] = 1
                n_seen += 1
            if state.get(c) != 2 and all(
                state.get(p) == 2 for p, _ in in_adj.get(c, [])
            ):
                if c not in stack:
                    stack.append(c)
        if len(stack) == 1 and n_seen == 1 and state.get(stack[0]) == 1:
            t = stack[0]
            if any(c == v for c, _ in out_adj.get(t, [])):
                return None
            return t
    return None


def _enumerate_paths(
    v: int,
    t: int,
    out_adj: Dict[int, List[Tuple[int, int]]],
    max_paths: int = MAX_CELL_PATHS,
    max_len: int = _MAX_CELL_PATH_EDGES,
) -> List[np.ndarray] | None:
    """All edge paths v -> t (DFS, bounded); None if bounds exceeded."""
    paths: List[np.ndarray] = []
    stack: List[Tuple[int, List[int]]] = [(v, [])]
    while stack:
        u, acc = stack.pop()
        if u == t and acc:
            paths.append(np.asarray(acc, dtype=np.int64))
            if len(paths) > max_paths:
                return None
            continue
        if len(acc) >= max_len:
            return None
        for c, e in sorted(out_adj.get(u, [])):
            if c == t or c != v:
                stack.append((c, acc + [e]))
    if not paths:
        return None
    paths.sort(key=lambda p: (len(p), p.tolist()))
    return paths


def find_cells(D, exclude: np.ndarray) -> List[Tuple[int, int, List[np.ndarray]]]:
    """Superbubble cells of D: -> [(entry_v, exit_v, paths)].  `exclude`
    marks edges (self-loops) ignored by the search.  Cells are disjoint,
    involution-symmetric (a cell's rc image is also emitted), deterministic."""
    out_adj: Dict[int, List[Tuple[int, int]]] = {}
    in_adj: Dict[int, List[Tuple[int, int]]] = {}
    for e in range(D.n_edges):
        if exclude[e]:
            continue
        out_adj.setdefault(int(D.from_v[e]), []).append((int(D.to_v[e]), e))
        in_adj.setdefault(int(D.to_v[e]), []).append((int(D.from_v[e]), e))

    claimed = np.zeros(D.n_edges, dtype=bool)
    cells: List[Tuple[int, int, List[np.ndarray]]] = []
    for v in sorted(out_adj):
        if len(out_adj[v]) < 2:
            continue
        t = _superbubble_exit(v, out_adj, in_adj)
        if t is None:
            continue
        paths = _enumerate_paths(v, int(t), out_adj)
        if paths is None or len(paths) < 2:
            continue
        edges = np.unique(np.concatenate(paths))
        mirror = np.unique(D.dinv[edges])
        if claimed[edges].any() or claimed[mirror].any():
            continue
        # every interior edge must ride some path (no escapes) — guaranteed
        # by the superbubble property, but re-check under the path bounds
        interior_src = {int(D.from_v[e]) for e in edges} - {v}
        esc = [
            e
            for u in interior_src
            for _c, e in out_adj.get(u, [])
            if e not in set(edges.tolist())
        ]
        if esc:
            continue
        claimed[edges] = True
        cells.append((v, int(t), paths))
        if not np.array_equal(np.sort(mirror), np.sort(edges)):
            claimed[mirror] = True
            mpaths = [D.dinv[p[::-1]].astype(np.int64) for p in paths]
            mpaths.sort(key=lambda p: (len(p), p.tolist()))
            mv = int(D.from_v[mpaths[0][0]])
            mt = int(D.to_v[mpaths[0][-1]])
            cells.append((mv, mt, mpaths))
    return cells


def find_lines(D) -> Lines:
    """Decompose D into lines: superbubble cells + parallel-edge cells +
    straight stretches, chained through simple vertices.  Self-loop edges
    are captured into the passing line as loop cells (CaptureSimpleLoops
    analogue, 10X/Capture.cc) instead of breaking the chain."""
    ed = D.n_edges
    self_loop = D.from_v == D.to_v
    loops_at: dict = {}
    for e in np.nonzero(self_loop)[0]:
        loops_at.setdefault(int(D.from_v[e]), []).append(int(e))

    # units: superbubble cells, then parallel-edge fallback cells, then
    # straight single edges.  Gap edges never ride bubble arms — they chain
    # as straight units (the reference's scaffold lines cross {-2} edges).
    sb_cells = find_cells(D, self_loop | D.gap_mask())
    in_cell_edge = np.zeros(ed, dtype=bool)
    units: List[Tuple[int, int, Cell]] = []  # (from_v, to_v, cell)
    for v, t, paths in sb_cells:
        for p in paths:
            in_cell_edge[p] = True
        units.append((v, t, Cell(paths)))

    free = np.nonzero(~in_cell_edge & ~self_loop)[0]
    pair_key = D.from_v.astype(np.int64) * (D.n_vertices + 1) + D.to_v
    order = free[np.argsort(pair_key[free], kind="stable")]
    i = 0
    ne = len(order)
    while i < ne:
        j = i
        while j < ne and pair_key[order[j]] == pair_key[order[i]]:
            j += 1
        members = np.sort(order[i:j])
        units.append(
            (
                int(D.from_v[members[0]]),
                int(D.to_v[members[0]]),
                Cell([np.array([e], dtype=np.int64) for e in members]),
            )
        )
        i = j

    nc = len(units)
    cfrom = np.array([u[0] for u in units], dtype=np.int64)
    cto = np.array([u[1] for u in units], dtype=np.int64)

    indeg = np.bincount(cto, minlength=D.n_vertices)
    outdeg = np.bincount(cfrom, minlength=D.n_vertices)
    out_cell = np.full(D.n_vertices, -1, dtype=np.int64)
    in_cell = np.full(D.n_vertices, -1, dtype=np.int64)
    for c in range(nc):
        if outdeg[cfrom[c]] == 1:
            out_cell[cfrom[c]] = c
        if indeg[cto[c]] == 1:
            in_cell[cto[c]] = c

    nxt = np.full(nc, -1, dtype=np.int64)
    prv = np.full(nc, -1, dtype=np.int64)
    for c in range(nc):
        v = cto[c]
        if indeg[v] == 1 and outdeg[v] == 1:
            f = out_cell[v]
            if f >= 0 and f != c:
                nxt[c] = f
                prv[f] = c

    # break cycles deterministically at min unit id
    visited = np.zeros(nc, dtype=bool)
    for c in range(nc):
        if visited[c] or prv[c] != -1:
            continue
        x = c
        while x != -1 and not visited[x]:
            visited[x] = True
            x = nxt[x]
    for c in range(nc):
        if not visited[c]:
            cyc, x = [c], nxt[c]
            visited[c] = True
            while x != c:
                visited[x] = True
                cyc.append(x)
                x = nxt[x]
            m = min(cyc)
            prv[m] = -1
            nxt[cyc[cyc.index(m) - 1]] = -1

    lines: List[Line] = []
    line_of_edge = np.full(ed, -1, dtype=np.int64)
    for c in range(nc):
        if prv[c] != -1:
            continue
        chain = [c]
        x = nxt[c]
        while x != -1:
            chain.append(x)
            x = nxt[x]
        li = len(lines)
        els: List[Cell] = []
        for cc in chain:
            cell = units[cc][2]
            for e in cell.edge_ids():
                line_of_edge[int(e)] = li
            els.append(cell)
            # capture self-loops at this unit's exit vertex into the line
            v = int(cto[cc])
            for le in loops_at.get(v, ()):
                if line_of_edge[le] == -1:
                    line_of_edge[le] = li
                    els.append(Cell([np.array([le], dtype=np.int64)]))
        lines.append(Line(els))

    # leftover self-loops (at vertices no chain passes) become their own lines
    for v, les in loops_at.items():
        for le in les:
            if line_of_edge[le] == -1:
                li = len(lines)
                line_of_edge[le] = li
                lines.append(Line([Cell([np.array([le], dtype=np.int64)])]))

    # involution: line containing the dinv of our first edge
    linv = np.zeros(len(lines), dtype=np.int64)
    for i, ln in enumerate(lines):
        e0 = int(ln.elements[0].paths[0][0])
        linv[i] = line_of_edge[int(D.dinv[e0])]
    return Lines(lines, line_of_edge, linv)


def check_mirror(D, lines: Lines) -> None:
    """Assert the line decomposition is rc-symmetric: linv is an involution
    and line linv[i] is the element-reversed dinv image of line i.  Cheap at
    host scale; pipeline edits that desymmetrize lines (e.g. a one-strand
    break) poison splay/dedup/scaffolding, so tests call this after every
    lines-producing step."""
    n = lines.n_lines
    linv = np.asarray(lines.linv)
    assert np.array_equal(linv[linv], np.arange(n)), "linv not an involution"
    for i in range(n):
        j = int(linv[i])
        A = lines.lines[i].elements
        B = lines.lines[j].elements
        assert len(A) == len(B), f"line {i} vs rc {j}: element count differs"
        for k, el in enumerate(A):
            mel = B[len(B) - 1 - k]
            ps = sorted(D.dinv[p[::-1]].tolist() for p in el.paths)
            qs = sorted(p.tolist() for p in mel.paths)
            assert ps == qs, f"line {i} el {k} is not the mirror of rc {j}"


def canonical_lines(lines: Lines) -> np.ndarray:
    """One representative per rc line pair (self-rc lines included)."""
    return np.nonzero(np.arange(lines.n_lines) <= lines.linv)[0]


@dataclass
class _MetaGraph:
    """Duck-typed digraph whose edges are lines — just enough surface for
    find_lines to run over it (FindLineLines builds digraphE<int> the same
    way, 10X/LineLine.cc:19-42)."""

    from_v: np.ndarray
    to_v: np.ndarray
    dinv: np.ndarray
    n_vertices: int

    @property
    def n_edges(self) -> int:
        return len(self.from_v)

    def gap_mask(self) -> np.ndarray:
        return np.zeros(self.n_edges, dtype=bool)


def find_line_lines(D, lines: Lines) -> Lines:
    """Lines of lines (FindLineLines, 10X/LineLine.cc:11-55): each line
    becomes one edge of a meta-graph between its end D-vertices; running
    the line finder over that graph yields scaffold-level structure —
    element paths hold LINE ids, and megabubble pairs appear as cells."""
    n = lines.n_lines
    lv = np.zeros(n, dtype=np.int64)
    wv = np.zeros(n, dtype=np.int64)
    for i, ln in enumerate(lines.lines):
        first = int(ln.elements[0].paths[0][0])
        last = int(ln.elements[-1].paths[0][-1])
        lv[i] = D.from_v[first]
        wv[i] = D.to_v[last]
    verts = np.unique(np.concatenate([lv, wv])) if n else np.zeros(0, np.int64)
    meta = _MetaGraph(
        from_v=np.searchsorted(verts, lv),
        to_v=np.searchsorted(verts, wv),
        dinv=np.asarray(lines.linv, np.int64).copy(),
        n_vertices=len(verts),
    )
    return find_lines(meta)


def line_line_lengths(llens: np.ndarray, lines2: Lines) -> np.ndarray:
    """Length of each line-of-lines: per element, the median over its
    parallel paths of the summed member-line lengths (GetLineLineLengths,
    10X/LineLine.cc:57-73)."""
    llens = np.asarray(llens)
    out = np.zeros(lines2.n_lines, dtype=np.int64)
    for i, ln in enumerate(lines2.lines):
        pos = 0
        for cell in ln.elements:
            plens = sorted(int(llens[p].sum()) for p in cell.paths)
            if plens:
                pos += plens[len(plens) // 2]
        out[i] = pos
    return out
