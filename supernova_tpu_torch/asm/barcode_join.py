"""BarcodeJoin: barcode-evidence joins between long lines.

The port's own copy of supernova_tpu/asm/barcode_join.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Behavioral analogue of the reference's BarcodeJoin (10X/CleanThe.cc:205-606,
called repeatedly from CleanTheAssembly, CleanThe.cc:2806-2929): for every
long line L (>= MIN_BIG), score its LineProx barcode neighbors with the four
ScoreOrder orientations, discard candidates that belong on the left
(left_adv >= MIN_LEFT_IGNORE), give up on ambiguous ones (|left_adv| <
MIN_LEFT_IGNORE unless excused by the right-reach set), pick the leftmost
surviving candidate by pairwise ordering, gate on copy-number closeness, and
keep only links whose rc mirror was independently found.  Accepted links are
realized as graph surgery:

  * type 1 (CleanThe.cc:486-499): both ends are simple dead ends -> append a
    {-2} barcode-only gap edge pair.
  * type 2 (CleanThe.cc:501-601): something sits between the two lines in
    the line graph -> duplicate the intermediate neighborhood (the lines
    within MIN_BIG bases that feed L2) and splice L1 -> copies -> L2,
    leaving the originals for their other contexts; with no intermediates
    but a shared vertex, detach both ends onto a fresh vertex.

Unlike Star (asm/star.py), BarcodeJoin does not require L1's right end to be
a dead end and can route through intermediate short lines.  Host-side: line
counts are ~1e3-1e5 (SURVEY.md §7 "Hard parts").
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .star import score_order

MIN_BIG = 10_000  # min length of an initiating (and target) line
MIN_LEN = 4_000  # min length of a line in the neighborhood
MAX_CN_DIFF = 0.25
MIN_LEFT_IGNORE = 100.0
MIN_ADVANTAGE = 100.0
MAX_DEPTH = 25
MAX_INTERMEDIATES = 100


def line_end_edges(lines, li: int) -> Tuple[int, int]:
    ln = lines.lines[li]
    return (
        int(ln.elements[0].paths[0][0]),
        int(ln.elements[-1].paths[0][-1]),
    )


def line_graph(lines, D) -> Tuple[Dict[int, List[int]], Dict[int, List[int]]]:
    """Lines-of-lines adjacency (BuildLineGraph analogue): successor lines
    share L's right D-vertex as their left D-vertex."""
    left_at: Dict[int, List[int]] = {}
    right_of: Dict[int, int] = {}
    left_of: Dict[int, int] = {}
    for li in range(lines.n_lines):
        first, last = line_end_edges(lines, li)
        lv, rv = int(D.from_v[first]), int(D.to_v[last])
        left_of[li] = lv
        right_of[li] = rv
        left_at.setdefault(lv, []).append(li)
    succs = {li: sorted(left_at.get(right_of[li], [])) for li in range(lines.n_lines)}
    preds: Dict[int, List[int]] = {li: [] for li in range(lines.n_lines)}
    for li, ss in succs.items():
        for s in ss:
            preds[s].append(li)
    return succs, preds


def right_reach(
    L: int,
    llens: np.ndarray,
    succs: Dict[int, List[int]],
    min_len: int = MIN_LEN,
    max_depth: int = MAX_DEPTH,
) -> List[int]:
    """Long lines (>= min_len) reachable rightward from L through short
    lines, bounded by max_depth BFS levels; empty on overflow
    (CleanThe.cc:317-340)."""
    reach: List[int] = []
    frontier = list(succs.get(L, []))
    seen = set(frontier)
    for _ in range(max_depth):
        if not frontier:
            return sorted(set(reach))
        nxt: List[int] = []
        for L2 in frontier:
            if llens[L2] >= min_len:
                reach.append(L2)
            else:
                for L3 in succs.get(L2, []):
                    if L3 not in seen:
                        seen.add(L3)
                        nxt.append(L3)
        frontier = nxt
    return []  # depth exceeded -> no reach constraint


def _left_adv(
    A: int, B: int, linvA: int, lbp, llens
) -> Tuple[float, List[float]]:
    """min(B-first orders) - min(A-first orders); positive => A belongs on
    the left of B (scores are badness, lower = better)."""
    scores = [
        score_order([A, B], lbp, llens),
        score_order([linvA, B], lbp, llens),
        score_order([B, A], lbp, llens),
        score_order([B, linvA], lbp, llens),
    ]
    return min(scores[2], scores[3]) - min(scores[0], scores[1]), scores


def barcode_join_links(
    lines,
    D,
    llens: np.ndarray,
    lbp: Dict[int, List[Tuple[int, int]]],
    lhood: Dict[int, List[Tuple[int, int]]],
    cov: np.ndarray,
    min_big: int = MIN_BIG,
    min_len: int = MIN_LEN,
    min_advantage: float = MIN_ADVANTAGE,
) -> List[Tuple[int, int]]:
    """Symmetric (L1, L2) join links, reference search (CleanThe.cc:281-462)."""
    from .star import lbp_arrays

    lbp = lbp_arrays(lbp)
    linv = lines.linv
    succs, _preds = line_graph(lines, D)
    links: List[Tuple[int, int]] = []
    for L in range(lines.n_lines):
        if llens[L] < min_big:
            continue
        LH = [
            L2
            for _s, L2 in lhood.get(L, ())
            if L2 != L and L2 != int(linv[L]) and llens[L2] >= min_len
        ]
        if not LH:
            continue
        reach = right_reach(L, llens, succs, min_len)
        confused = False
        X: List[int] = []
        good: List[bool] = []
        for L2 in LH:
            rl2 = int(linv[L2])
            adv, scores = _left_adv(L2, L, rl2, lbp, llens)
            # adv > 0: L2 belongs left of L
            if (
                reach
                and L2 not in reach
                and -MIN_LEFT_IGNORE < adv < MIN_LEFT_IGNORE
            ):
                continue
            if adv >= MIN_LEFT_IGNORE:
                continue
            if adv > -MIN_LEFT_IGNORE:
                confused = True
                break
            order = np.argsort(scores, kind="stable")
            win = scores[order[1]] - scores[order[0]]
            X.append(L2 if order[0] == 2 else rl2)
            good.append(win >= min_advantage)
        if confused or not X:
            continue
        # leftmost candidate by pairwise ordering (CleanThe.cc:392-417)
        if len(X) > 1:
            for j2, L2 in enumerate(X):
                conf2 = False
                for L3 in X:
                    if L3 == L2:
                        continue
                    adv, _ = _left_adv(L3, L2, int(linv[L3]), lbp, llens)
                    if (
                        reach
                        and L3 not in reach
                        and -MIN_LEFT_IGNORE <= adv <= 0
                    ):
                        continue
                    if adv >= -MIN_LEFT_IGNORE:
                        conf2 = True
                        break
                if not conf2:
                    if good[j2]:
                        X = [L2]
                    break
        if len(X) > 1:
            continue
        L2 = X[0]
        if llens[L2] >= min_big and abs(cov[L] - cov[L2]) < MAX_CN_DIFF:
            links.append((L, L2))
    links = sorted(set(links))
    # remove asymmetric links: the rc mirror must have been found too
    lset = set(links)
    return [
        (L1, L2)
        for (L1, L2) in links
        if (int(linv[L2]), int(linv[L1])) in lset
    ]


def _nhood_intermediates(
    L1: int,
    L2: int,
    llens: np.ndarray,
    succs: Dict[int, List[int]],
    preds: Dict[int, List[int]],
    min_big: int = MIN_BIG,
) -> List[int] | None:
    """Intermediate lines between L1 and L2 (CleanThe.cc:503-540): the
    rightward neighborhood of L1 within min_big bases, restricted to direct
    feeders of L2 (plus one expansion ring); None when the join must be
    refused (too many intermediates)."""
    dist: Dict[int, int] = {L1: 0}
    queue = [L1]
    while queue:
        Lx = queue.pop(0)
        for LP in succs.get(Lx, []):
            dp = dist[Lx] + int(llens[LP])
            if dp >= min_big:
                continue
            if LP not in dist or dp < dist[LP]:
                dist[LP] = dp
                queue.append(LP)
    ls = sorted(set(dist) - {L1})
    lsr = [Lx for Lx in preds.get(L2, []) if Lx in set(ls)]
    lsrx = set(lsr)
    for Lx in list(lsr):
        for LP in preds.get(Lx, []):
            if LP in set(ls) and LP not in lsrx:
                lsr.append(LP)
                lsrx.add(LP)
    lsr = sorted(lsrx)
    if len(lsr) > MAX_INTERMEDIATES:
        return None
    return lsr


def apply_barcode_joins(
    D,
    lines,
    links: Sequence[Tuple[int, int]],
) -> Tuple[object, int]:
    """Realize symmetric links as graph surgery -> (new D, n_joins)."""
    from . import gap as agap
    from .supergraph import SuperGraph, append_gap_edges
    from ..core.ragged import Ragged

    linv = lines.linv
    succs, preds = line_graph(lines, D)
    llens = lines.lengths(D)

    rows = list(D.epaths)
    dinv = list(D.dinv)
    from_v = list(D.from_v)
    to_v = list(D.to_v)
    n_vertices = D.n_vertices
    indeg = np.bincount(D.to_v, minlength=n_vertices)
    outdeg = np.bincount(D.from_v, minlength=n_vertices)

    gap_items = []
    n_joins = 0
    done = set()
    for L1, L2 in links:
        RL1, RL2 = int(linv[L1]), int(linv[L2])
        if len({L1, L2, RL1, RL2}) != 4:
            continue
        if (RL2, RL1) < (L1, L2):
            continue  # canonical orientation handles the pair once
        if {L1, L2, RL1, RL2} & done:
            continue
        _, d1 = line_end_edges(lines, L1)
        d2, _ = line_end_edges(lines, L2)
        v, w = int(D.to_v[d1]), int(D.from_v[d2])
        rd1, rd2 = int(D.dinv[d1]), int(D.dinv[d2])

        # type 1: simple dead ends -> {-2} gap edge pair
        if (
            outdeg[v] == 0
            and indeg[w] == 0
            and indeg[v] == 1
            and outdeg[w] == 1
        ):
            vr, wr = int(D.to_v[rd2]), int(D.from_v[rd1])
            gap_items.append((v, w, agap.bc_gap(100), vr, wr))
            done |= {L1, L2, RL1, RL2}
            n_joins += 1
            continue

        # type 2: splice through (copies of) the intermediate neighborhood
        lsr = _nhood_intermediates(L1, L2, llens, succs, preds)
        if lsr is None:
            continue
        if not lsr and w != v:
            continue
        em: List[int] = sorted(
            {int(e) for Lx in lsr for e in lines.lines[Lx].edges()}
        )
        emr = [int(D.dinv[d]) for d in em]
        n = len(em)
        if n == 0:
            # shared vertex: detach both ends onto a fresh vertex pair
            N = n_vertices
            n_vertices += 2
            to_v[d1] = N
            from_v[d2] = N
            to_v[rd2] = N + 1
            from_v[rd1] = N + 1
            done |= {L1, L2, RL1, RL2}
            n_joins += 1
            continue
        # duplicate em (and its rc image) on fresh vertices
        vmap: Dict[int, int] = {}
        rvmap: Dict[int, int] = {}
        for d in em:
            for vv in (int(D.from_v[d]), int(D.to_v[d])):
                if vv not in vmap:
                    vmap[vv] = n_vertices
                    n_vertices += 1
        for d in emr:
            for vv in (int(D.from_v[d]), int(D.to_v[d])):
                if vv not in rvmap:
                    rvmap[vv] = n_vertices
                    n_vertices += 1
        v1 = vmap.get(v)
        v2 = vmap.get(w)
        rv2 = rvmap.get(int(D.to_v[rd2]))
        rv1 = rvmap.get(int(D.from_v[rd1]))
        if v1 is None or v2 is None or rv1 is None or rv2 is None:
            n_vertices -= len(vmap) + len(rvmap)  # roll back unused ids
            continue
        E = len(rows)
        for d in em:
            rows.append(np.asarray(D.epaths.row(d), np.int64))
            from_v.append(vmap[int(D.from_v[d])])
            to_v.append(vmap[int(D.to_v[d])])
        for d in emr:
            rows.append(np.asarray(D.epaths.row(d), np.int64))
            from_v.append(rvmap[int(D.from_v[d])])
            to_v.append(rvmap[int(D.to_v[d])])
        dinv.extend(range(E + n, E + 2 * n))
        dinv.extend(range(E, E + n))
        to_v[d1] = v1
        from_v[d2] = v2
        to_v[rd2] = rv2
        from_v[rd1] = rv1
        done |= {L1, L2, RL1, RL2}
        n_joins += 1

    if not n_joins:
        return D, 0
    D2 = SuperGraph(
        epaths=Ragged.from_rows([np.asarray(r, np.int64) for r in rows]),
        dinv=np.asarray(dinv, np.int64),
        from_v=np.asarray(from_v, np.int64),
        to_v=np.asarray(to_v, np.int64),
        n_vertices=n_vertices,
        bg=D.bg,
    )
    if gap_items:
        D2 = append_gap_edges(D2, gap_items)
    return D2, n_joins


def barcode_join(
    D,
    lines,
    llens: np.ndarray,
    lbp: Dict[int, List[Tuple[int, int]]],
    lhood: Dict[int, List[Tuple[int, int]]],
    cov: np.ndarray,
    min_big: int | None = None,
    min_len: int | None = None,
) -> Tuple[object, int]:
    """One BarcodeJoin pass -> (possibly new D, n_joins).  None defaults
    read MIN_BIG/MIN_LEN at call time (--addin overridable)."""
    if min_big is None:
        min_big = MIN_BIG
    if min_len is None:
        min_len = MIN_LEN
    links = barcode_join_links(
        lines, D, llens, lbp, lhood, cov, min_big=min_big, min_len=min_len
    )
    if not links:
        return D, 0
    return apply_barcode_joins(D, lines, links)
