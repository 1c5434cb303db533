"""Duplicate read-pair marking.

The port's own copy of supernova_tpu/asm/dups.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of the reference's MarkDups (10X/SecretOps.cc:413,599): two pairs
are duplicates when they share the barcode and their reads start at the same
place on the graph (pair-identical start heuristic).  We key each pair on
(barcode, first-edge/offset of r1's path, first-edge/offset of r2's path)
and keep the first pair of each key (stable order = read order).
"""
from __future__ import annotations

import numpy as np


def mark_dups(paths_edges, path_len, offset, bc) -> np.ndarray:
    """-> bool (n_pairs,) dup flag.  Inputs are per-read arrays (2i, 2i+1
    are mates), bc per read."""
    n_reads = paths_edges.shape[0]
    n_pairs = n_reads // 2
    e0 = np.where(path_len > 0, paths_edges[:, 0], -1)
    off = np.where(path_len > 0, offset, 0)

    r1 = np.arange(0, n_reads, 2)
    r2 = r1 + 1
    key = np.stack(
        [bc[r1].astype(np.int64), e0[r1], off[r1], e0[r2], off[r2]], axis=1
    )
    # unplaced pairs (both mates pathless) are never dups
    placed = (e0[r1] >= 0) | (e0[r2] >= 0)

    order = np.lexsort(key.T[::-1])
    ks = key[order]
    first = np.ones(n_pairs, dtype=bool)
    if n_pairs > 1:
        first[1:] = np.any(ks[1:] != ks[:-1], axis=1)
    dup_sorted = ~first
    dup = np.zeros(n_pairs, dtype=bool)
    dup[order] = dup_sorted
    return dup & placed


def dup_fraction(dup: np.ndarray) -> float:
    return float(dup.mean()) if len(dup) else 0.0


def insert_size_stats(bg, paths_edges, path_len, offset, max_insert: int = 2000):
    """Insert-size estimate from mate placements (TR's insert stats feeding
    the median_ins_sz / proper_pairs_perc alarms, alarms-supernova.json:
    130-152): for pairs whose mates place on an edge and its rc twin, the
    fragment length is (edge_len - offset2) - offset1.  -> (median insert
    or None, proper-pair fraction of placed pairs)."""
    import numpy as np

    pe = np.asarray(paths_edges)
    pl = np.asarray(path_len)
    off = np.asarray(offset)
    n_pairs = pe.shape[0] // 2
    if n_pairs == 0:
        return None, 0.0
    e1 = pe[0::2, 0][:n_pairs]
    e2 = pe[1::2, 0][:n_pairs]
    l1 = pl[0::2][:n_pairs]
    l2 = pl[1::2][:n_pairs]
    o1 = off[0::2][:n_pairs]
    o2 = off[1::2][:n_pairs]
    placed = (l1 >= 1) & (l2 >= 1) & (e1 >= 0) & (e2 >= 0)
    E = bg.n_edges
    same = placed & (bg.inv[np.clip(e2, 0, E - 1)] == e1)
    elen = bg.edges.lengths()
    ins = elen[np.clip(e1, 0, E - 1)] - o2 - o1
    measurable = same & (ins > 0) & (ins <= max_insert)

    # proper = the mates' walks join: same edge pair, graph-adjacent ends,
    # or any shared edge between the paths (the Closer easy-join tests,
    # vectorized over the fixed path width)
    mp = pe.shape[1]
    p1 = pe[0::2][:n_pairs]
    p2 = pe[1::2][:n_pairs]
    slot1 = np.arange(mp)[None, :] < l1[:, None]
    slot2 = np.arange(mp)[None, :] < l2[:, None]
    p2rc = np.where(slot2, bg.inv[np.clip(p2, 0, E - 1)], -1)
    p1m = np.where(slot1, p1, -2)
    shares = (p1m[:, :, None] == p2rc[:, None, :]).any(axis=(1, 2))
    last1 = p1[np.arange(n_pairs), np.maximum(l1 - 1, 0)]
    first2rc = p2rc[np.arange(n_pairs), np.maximum(l2 - 1, 0)]
    adj = bg.to_v[np.clip(last1, 0, E - 1)] == bg.from_v[
        np.clip(first2rc, 0, E - 1)
    ]
    proper = placed & (shares | adj)
    n_placed = int(placed.sum())
    if n_placed == 0 or not measurable.any():
        return None, 0.0
    return float(np.median(ins[measurable])), float(proper.sum() / n_placed)
