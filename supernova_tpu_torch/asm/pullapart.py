"""PullApart and Decycle: read-evidence repeat separation on D.

The port's own copy of supernova_tpu/asm/pullapart.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogues:
  * PullApart (10X/PullApart.cc:138-260): two shapes —
      type 1: {d1,d2} -> v -> e -> w -> {f1,f2}: duplicate the middle edge
        e so d1-e-f1 and d2-e'-f2 run separately;
      type 2: {d1,d2} -> v -> {f1,f2}: split the vertex.
    Both gated by SupportSplit (PullApart.cc:73-137): fragment-level paths
    (read dpath + mate's dpath translated through dinv) must support the
    direct pairings (sup11>=5 and sup22>=5) with at most bounded crossing
    support; edits are mirrored on the rc side and the involution updated.
  * Decycle (10X/Decycle.cc:15): remove the back edge of a simple two-edge
    cycle when read support shows the loop is not traversed (error-induced
    cycles); genuine tandem loops keep their back edge.

Host-side (supergraph scale); edits rebuild the SuperGraph and recompact.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..core.ragged import Ragged

MIN_DIRECT = 5  # SupportSplit sup11/sup22 threshold
MIN_DIRECT_LOOSE = 10  # with <=1 crossing support


class FragIndex:
    """Fragment membership as sorted (edge, pair) rows + a per-edge CSR —
    vectorized replacement for per-pair python sets."""

    def __init__(self, D, dpaths: np.ndarray, dlen: np.ndarray):
        r, mp = dpaths.shape
        dlen = np.asarray(dlen)[:r]
        slot_ok = np.arange(mp)[None, :] < dlen[:, None]
        valid = slot_ok & (dpaths >= 0)
        rows, cols = np.nonzero(valid)
        d = dpaths[rows, cols].astype(np.int64)
        mate = rows % 2 == 1
        d = np.where(mate, D.dinv[d], d)  # mates into fragment orientation
        pair = (rows // 2).astype(np.int64)
        key = d * np.int64(r // 2 + 1) + pair
        uk = np.unique(key)
        self.n_pairs = r // 2
        self.edge = (uk // (r // 2 + 1)).astype(np.int64)
        self.pair = (uk % (r // 2 + 1)).astype(np.int64)

    def pairs_of(self, e: int) -> np.ndarray:
        lo = np.searchsorted(self.edge, e, side="left")
        hi = np.searchsorted(self.edge, e, side="right")
        return self.pair[lo:hi]


def fragment_edge_sets(D, dpaths: np.ndarray, dlen: np.ndarray) -> FragIndex:
    """-> FragIndex over read pairs (kept name for callers)."""
    return FragIndex(D, dpaths, dlen)


def _edge_frag_index(frags: FragIndex) -> FragIndex:
    return frags


def _support_split(
    d1: int, d2: int, f1: int, f2: int, frags: FragIndex, findex, dinv
) -> bool:
    """SupportSplit (PullApart.cc:73-137), mode-2 thresholds; set algebra
    over the sorted fragment index."""
    p1 = frags.pairs_of(d1)
    p2 = frags.pairs_of(d2)
    both = np.intersect1d(p1, p2, assume_unique=True)
    only1 = np.setdiff1d(p1, both, assume_unique=True)
    only2 = np.setdiff1d(p2, both, assume_unique=True)
    pf1 = frags.pairs_of(f1)
    pf2 = frags.pairs_of(f2)
    s11 = len(np.intersect1d(only1, pf1, assume_unique=True))
    s12 = len(np.intersect1d(only1, pf2, assume_unique=True))
    s21 = len(np.intersect1d(only2, pf1, assume_unique=True))
    s22 = len(np.intersect1d(only2, pf2, assume_unique=True))
    if int(dinv[f1]) == f2:
        return s11 >= MIN_DIRECT and s22 >= MIN_DIRECT and (
            s11 + s22 >= 5 * (s12 + s21)
        )
    if s11 >= MIN_DIRECT and s22 >= MIN_DIRECT and s12 + s21 == 0:
        return True
    return s11 >= MIN_DIRECT_LOOSE and s22 >= MIN_DIRECT_LOOSE and s12 + s21 <= 1


def pull_apart(D, dpaths: np.ndarray, dlen: np.ndarray):
    """-> (new SuperGraph, n_pulls).  Applies type-1 and type-2 pullaparts
    with rc mirroring, then recompacts."""
    from .inversion import delete_edges
    from .supergraph import SuperGraph

    frags = fragment_edge_sets(D, dpaths, dlen)
    findex = _edge_frag_index(frags)
    dinv = [int(x) for x in D.dinv]
    rows = [D.epaths.row(d).copy() for d in range(D.n_edges)]
    from_v = [int(x) for x in D.from_v]
    to_v = [int(x) for x in D.to_v]
    nv = D.n_vertices

    in_at: Dict[int, List[int]] = {}
    out_at: Dict[int, List[int]] = {}
    for d in range(D.n_edges):
        out_at.setdefault(from_v[d], []).append(d)
        in_at.setdefault(to_v[d], []).append(d)

    touched: Set[int] = set()
    pulls = 0

    # type 1: {d1,d2} -> v -> e -> w -> {f1,f2}
    for v in range(nv):
        ins = in_at.get(v, [])
        outs = out_at.get(v, [])
        if len(ins) != 2 or len(outs) != 1:
            continue
        e = outs[0]
        w = to_v[e]
        if len(in_at.get(w, [])) != 1 or len(out_at.get(w, [])) != 2:
            continue
        d1, d2 = ins
        re = dinv[e]
        # rc side must be structurally distinct (IsUnique guard)
        if len({from_v[e], to_v[e], from_v[re], to_v[re]}) != 4:
            continue
        hit = False
        for f1, f2 in (tuple(out_at[w]), tuple(reversed(out_at[w]))):
            if _support_split(d1, d2, f1, f2, frags, findex, dinv):
                hit = True
                break
        if not hit:
            continue
        if from_v[e] in touched or to_v[e] in touched:
            continue
        rv, rw = from_v[re], to_v[re]
        if rv in touched or rw in touched:
            continue
        touched.update({from_v[e], to_v[e], rv, rw})
        # new vertices N..N+3, duplicated middle edges e' (N->N+1), re' (N+2->N+3)
        N = nv
        nv += 4
        rows.append(rows[e].copy())
        from_v.append(N)
        to_v.append(N + 1)
        rows.append(rows[re].copy())
        from_v.append(N + 2)
        to_v.append(N + 3)
        E = len(rows) - 2
        dinv.extend([E + 1, E])
        rd2, rf2 = dinv[d2], dinv[f2]
        to_v[d2] = N
        from_v[f2] = N + 1
        to_v[rf2] = N + 2
        from_v[rd2] = N + 3
        pulls += 1
        touched.update({N, N + 1, N + 2, N + 3})

    # type 2: {d1,d2} -> v -> {f1,f2}
    for v in range(D.n_vertices):
        if v in touched:
            continue
        ins = in_at.get(v, [])
        outs = out_at.get(v, [])
        if len(ins) != 2 or len(outs) != 2:
            continue
        d1, d2 = ins
        rd1 = dinv[d1]
        if to_v[rd1] == v:  # rc image is the same vertex
            continue
        hit = None
        for f1, f2 in (tuple(outs), tuple(reversed(outs))):
            if _support_split(d1, d2, f1, f2, frags, findex, dinv):
                hit = (f1, f2)
                break
        if hit is None:
            continue
        f1, f2 = hit
        rd2, rf2 = dinv[d2], dinv[f2]
        rv = to_v[rd2]
        if rv in touched or v in touched:
            continue
        touched.update({v, rv})
        N = nv
        nv += 2
        to_v[d2] = N
        from_v[f2] = N
        from_v[rd2] = N + 1
        to_v[rf2] = N + 1
        pulls += 1
        touched.update({N, N + 1})

    if not pulls:
        return D, 0
    D2 = SuperGraph(
        epaths=Ragged.from_rows(rows, dtype=np.int64),
        dinv=np.asarray(dinv, np.int64),
        from_v=np.asarray(from_v, np.int64),
        to_v=np.asarray(to_v, np.int64),
        n_vertices=nv,
        bg=D.bg,
    )
    return delete_edges(D2, [], force=True), pulls


def decycle(D, dpaths: np.ndarray, dlen: np.ndarray, min_loop_support: int = 2):
    """-> D-edge ids of unsupported back edges of two-edge cycles."""
    frags = fragment_edge_sets(D, dpaths, dlen)
    findex = _edge_frag_index(frags)
    dels: List[int] = []
    fwd: Dict[Tuple[int, int], List[int]] = {}
    for d in range(D.n_edges):
        v, w = int(D.from_v[d]), int(D.to_v[d])
        if v != w:
            fwd.setdefault((v, w), []).append(d)
    for (v, w), ds in fwd.items():
        if v >= w:
            continue
        back = fwd.get((w, v), [])
        if not ds or not back:
            continue
        for c in back:
            if len(findex.pairs_of(c)) < min_loop_support:
                dels.append(int(c))
                dels.append(int(D.dinv[c]))
    return sorted(set(dels))
