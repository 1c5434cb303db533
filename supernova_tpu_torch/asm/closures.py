"""Closure paths: joined per-pair walks on the base graph (MC stage).

The port's own copy of supernova_tpu/asm/closures.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (SURVEY.md §2.1 MC): MakeClosures (SecretOps.cc:
1049-1120) turns each non-dup, non-bad read pair whose two paths dead-end
into a joined closure path (Closer/DefinePairSet, 10X/Closer.cc:8-66),
doubles the set under the involution, UniqueSorts, and adds back unused
edges >= 200 kmers as singleton closures.  Closures are the raw material the
reference glues into the supergraph (ClosuresToGraph/NucleateGraph — the
full gluing construction is a later round; today's D comes from graph
compaction and closures are emitted as the a.cpaths-equivalent artifact and
used for scaffolding evidence).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

MIN_SINGLETON_KMERS = 200  # SecretOps.cc:1086-1113


def _offset_consistent(p1: List[int], p2: List[int], off: int) -> bool:
    """True if p1[j] == p2[j+off] wherever both are defined (ClosePair's
    is_match, 10X/Closer.cc:151-158)."""
    for j1 in range(len(p1)):
        j2 = j1 + off
        if 0 <= j2 < len(p2) and p1[j1] != p2[j2]:
            return False
    return True


def _join_pair(bg, p1: List[int], p2rc: List[int], bridges=None) -> List[int] | None:
    """Join r1's path with rc(r2's path) (ClosePair easy closures,
    10X/Closer.cc:95-137): direct graph adjacency, then offset-consistent
    shared-edge joins (unique ones only), then a one-read bridge through
    another read's path containing both flanking edges."""
    if not p1:
        return p2rc or None
    if not p2rc:
        return p1
    # easy closure: mates abut on the graph
    if bg.to_v[p1[-1]] == bg.from_v[p2rc[0]]:
        return p1 + p2rc
    if p1[-1] == p2rc[0]:
        return p1 + p2rc[1:]
    # offset-consistent shared-edge joins; accept only a unique join
    joins = set()
    for i1, e in enumerate(p1):
        for i2, f in enumerate(p2rc):
            if e == f and _offset_consistent(p1, p2rc, i2 - i1):
                joins.add(tuple(p1[: i1 + 1]) + tuple(p2rc[i2 + 1 :]))
    if len(joins) == 1:
        return list(joins.pop())
    if joins:
        return None  # ambiguous
    # one-read bridge: another read's path walks e1 ... e2
    if bridges is not None:
        e1, e2 = p1[-1], p2rc[0]
        middles = set()
        for q in bridges.get((e1, e2), ())[:20]:
            middles.add(tuple(q))
        if len(middles) == 1:
            return p1 + list(middles.pop()) + p2rc
    return None


def _build_bridges(paths_edges, path_len, flank_pairs) -> dict:
    """(e1, e2) -> list of middle segments from read paths containing e1
    then e2 (the read-assisted closure evidence, Closer.cc second half)."""
    want_e1: dict = {}
    for e1, e2 in flank_pairs:
        want_e1.setdefault(e1, set()).add(e2)
    out: dict = {}
    n, mp = paths_edges.shape
    pl_all = np.asarray(path_len)[:n]
    # vectorized prefilter: only reads whose path touches some flank e1
    e1s = np.asarray(sorted(want_e1), dtype=np.int64)
    if len(e1s) == 0:
        return out
    slot_ok = np.arange(mp)[None, :] < pl_all[:, None]
    masked = np.where(slot_ok, paths_edges[:n], -1)
    cand = np.nonzero((np.isin(masked, e1s)).any(axis=1) & (pl_all >= 2))[0]
    for r in cand:
        pl = int(pl_all[r])
        p = paths_edges[r, :pl]
        for a in range(pl - 1):
            e1 = int(p[a])
            targets = want_e1.get(e1)
            if not targets:
                continue
            for b in range(a + 1, pl):
                e2 = int(p[b])
                if e2 in targets:
                    key = (e1, e2)
                    lst = out.setdefault(key, [])
                    if len(lst) < 20:
                        lst.append([int(x) for x in p[a + 1 : b]])
    return out


def make_closures(
    bg, paths_edges: np.ndarray, path_len: np.ndarray, dup: np.ndarray | None
) -> List[Tuple[int, ...]]:
    """-> unique closure paths (tuples of base edge ids), involution-doubled,
    plus long unused edges as singletons."""
    n_reads = paths_edges.shape[0]
    n_pairs = n_reads // 2
    inv = bg.inv
    E = bg.n_edges
    closures = set()
    used = np.zeros(E, dtype=bool)
    pl = np.asarray(path_len)[:n_reads]

    # vectorized fast path: both mates single-edge (the vast majority) —
    # same-edge and graph-adjacent joins resolve without the python loop
    l1 = pl[0::2][:n_pairs]
    l2 = pl[1::2][:n_pairs]
    e1 = paths_edges[0::2, 0][:n_pairs].astype(np.int64)
    e2 = paths_edges[1::2, 0][:n_pairs].astype(np.int64)
    live = np.ones(n_pairs, bool) if dup is None else ~np.asarray(dup)[:n_pairs]
    simple = live & (l1 == 1) & (l2 == 1) & (e1 >= 0) & (e2 >= 0)
    e2rc = inv[np.clip(e2, 0, E - 1)]
    same = simple & (e1 == e2rc)
    adj = simple & ~same & (
        bg.to_v[np.clip(e1, 0, E - 1)] == bg.from_v[np.clip(e2rc, 0, E - 1)]
    )
    for e in np.unique(e1[same]):
        closures.add((int(e),))
        used[int(e)] = used[int(inv[e])] = True
    for a, b in np.unique(
        np.stack([e1[adj], e2rc[adj]], axis=1), axis=0
    ).tolist():
        closures.add((int(a), int(b)))
        used[int(a)] = used[int(inv[a])] = True
        used[int(b)] = used[int(inv[b])] = True

    # the rest walk the full Closer logic
    rest = np.nonzero(live & ~(same | adj))[0]
    pair_paths = []
    flank_pairs = set()
    for pair in rest:
        r1, r2 = 2 * pair, 2 * pair + 1
        p1 = [int(e) for e in paths_edges[r1, : pl[r1]]]
        p2 = [int(e) for e in paths_edges[r2, : pl[r2]]]
        p2rc = [int(inv[e]) for e in reversed(p2)]
        pair_paths.append((p1, p2rc))
        if p1 and p2rc:
            flank_pairs.add((p1[-1], p2rc[0]))
    bridges = _build_bridges(paths_edges, pl, flank_pairs)

    for p1, p2rc in pair_paths:
        joined = _join_pair(bg, p1, p2rc, bridges)
        if joined:
            closures.add(tuple(joined))
            for e in joined:
                used[e] = True
                used[int(inv[e])] = True

    # double under the involution (SecretOps.cc doubles then UniqueSorts)
    doubled = set(closures)
    for c in closures:
        doubled.add(tuple(int(inv[e]) for e in reversed(c)))

    # unused long edges become singleton closures
    kmers = bg.edges.lengths() - 47  # K-1
    for e in range(bg.n_edges):
        if not used[e] and kmers[e] >= MIN_SINGLETON_KMERS:
            doubled.add((e,))

    return sorted(doubled)


def closure_spans_junctions(closures, D) -> int:
    """How many closures cross a supergraph junction (evidence density the
    gluing construction will consume)."""
    from .place import base_to_super_map

    b2s = base_to_super_map(D)
    n = 0
    for c in closures:
        ds = {b2s[e][0] for e in c if e in b2s}
        if len(ds) > 1:
            n += 1
    return n


def load_closures(path) -> List[Tuple[int, ...]]:
    z = np.load(path)
    v, o = z["values"], z["offsets"]
    return [tuple(int(e) for e in v[o[i]: o[i + 1]]) for i in range(len(o) - 1)]


def save_closures(path, closures: List[Tuple[int, ...]]):
    values = np.concatenate([np.asarray(c, np.int64) for c in closures]) if closures else np.zeros(0, np.int64)
    offsets = np.zeros(len(closures) + 1, np.int64)
    np.cumsum([len(c) for c in closures], out=offsets[1:])
    np.savez_compressed(path, values=values, offsets=offsets)
