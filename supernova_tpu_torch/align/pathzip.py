"""Zipped read-path storage: the ReadPathVecX analogue.

The port's own copy of supernova_tpu/align/pathzip.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The reference compresses per-read paths against the graph
(10X/paths/ReadPathVecX.h:9-100: a path is fully determined by its first
edge + offset + the branch CHOICES taken at multi-out vertices, so only
those choices are stored).  Same idea here, array-native: per read we
keep (first_edge, n_edges) and a CSR of branch-choice bytes — one byte
per subsequent edge, the rank of that edge among its source vertex's
out-edges (sorted by edge id).  A DBG vertex has <= 4 out-edges, so the
choice alphabet is tiny; zipped storage is ~8x smaller than the dense
(R, MP) int32 edge matrix before npz compression even helps.

Paths that are not graph-adjacent (possible across re-pathing edge cases)
are kept raw in a fallback list — the zip is lossless by construction.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.ragged import Ragged


def _adjacency(bg):
    """Out-edges of every vertex, sorted by (vertex, edge id):
    -> (adj_edges, adj_offsets, key_all) with key_all = v * E + e sorted."""
    E = bg.n_edges
    from_v = np.asarray(bg.from_v, np.int64)
    order = np.lexsort((np.arange(E), from_v))
    adj_edges = order.astype(np.int64)
    counts = np.bincount(from_v, minlength=bg.n_vertices)
    adj_offsets = np.zeros(bg.n_vertices + 1, np.int64)
    np.cumsum(counts, out=adj_offsets[1:])
    key_all = from_v[adj_edges] * np.int64(E) + adj_edges
    return adj_edges, adj_offsets, key_all


def zip_paths(
    bg, edges: np.ndarray, plen: np.ndarray
) -> Tuple[np.ndarray, Ragged, np.ndarray, np.ndarray]:
    """-> (first_edge (R,), choices CSR (one uint8 per edge after the
    first), raw_rows (ids of non-adjacent fallback reads), raw_edges
    (K, MP) for those rows).  Vectorized per path slot."""
    edges = np.asarray(edges)
    r, mp = edges.shape
    plen = np.asarray(plen)[:r].astype(np.int64)
    E = bg.n_edges
    to_v = np.asarray(bg.to_v, np.int64)
    adj_edges, adj_offsets, key_all = _adjacency(bg)

    first = np.where(plen > 0, edges[:, 0], -1).astype(np.int64)
    choice = np.zeros((r, max(mp - 1, 1)), np.uint8)
    bad = np.zeros(r, bool)
    for j in range(mp - 1):
        active = plen > j + 1
        if not active.any():
            break
        e = edges[active, j].astype(np.int64)
        e2 = edges[active, j + 1].astype(np.int64)
        v = to_v[np.clip(e, 0, E - 1)]
        key = v * np.int64(E) + e2
        idx = np.searchsorted(key_all, key)
        found = (idx < len(key_all)) & (key_all[np.minimum(idx, len(key_all) - 1)] == key)
        c = idx - adj_offsets[v]
        ok = found & (c >= 0) & (c < 256)
        rows = np.nonzero(active)[0]
        choice[rows[ok], j] = c[ok].astype(np.uint8)
        bad[rows[~ok]] = True

    good = ~bad
    nch = np.where(good, np.maximum(plen - 1, 0), 0)
    # CSR over ALL reads (empty rows for bad/short paths); row-major
    # boolean indexing preserves (read, slot) order
    mask = (np.arange(max(mp - 1, 1))[None, :] < nch[:, None])
    values = choice[mask]
    offsets = np.zeros(r + 1, np.int64)
    np.cumsum(nch, out=offsets[1:])
    choices = Ragged(values, offsets)

    raw_rows = np.nonzero(bad)[0]
    raw_edges = edges[raw_rows].astype(np.int32)
    first[bad] = np.where(plen[bad] > 0, edges[bad, 0], -1)
    return first, choices, raw_rows.astype(np.int64), raw_edges


def unzip_paths(
    bg,
    first: np.ndarray,
    plen: np.ndarray,
    choices: Ragged,
    raw_rows: np.ndarray,
    raw_edges: np.ndarray,
    mp: int,
) -> np.ndarray:
    """Reconstruct the dense (R, MP) edge matrix."""
    r = len(first)
    plen = np.asarray(plen)[:r].astype(np.int64)
    to_v = np.asarray(bg.to_v, np.int64)
    adj_edges, adj_offsets, _ = _adjacency(bg)

    edges = np.full((r, mp), -1, np.int32)
    has = plen > 0
    edges[has, 0] = first[has]
    offs = choices.offsets
    isbad = np.zeros(r, bool)
    isbad[np.asarray(raw_rows, np.int64)] = True
    for j in range(mp - 1):
        active = (plen > j + 1) & has & ~isbad
        if not active.any():
            break
        e = edges[active, j].astype(np.int64)
        v = to_v[np.clip(e, 0, bg.n_edges - 1)]
        c = choices.values[offs[:-1][active] + j].astype(np.int64)
        edges[active, j + 1] = adj_edges[adj_offsets[v] + c]
    if len(raw_rows):
        k, kmp = raw_edges.shape
        edges[raw_rows, : min(mp, kmp)] = raw_edges[:, : min(mp, kmp)]
    return edges


def save_zipped(path, bg, edges, plen, offset, extra=None):
    """Write paths in zipped form (+ any extra arrays)."""
    first, choices, raw_rows, raw_edges = zip_paths(bg, edges, plen)
    np.savez_compressed(
        path,
        zip_first=first,
        zip_plen=np.asarray(plen, np.int64),
        zip_choices_values=choices.values,
        zip_choices_offsets=choices.offsets,
        zip_raw_rows=raw_rows,
        zip_raw_edges=raw_edges,
        zip_mp=np.int64(np.asarray(edges).shape[1]),
        offset=np.asarray(offset),
        **(extra or {}),
    )


def load_zipped(z, bg):
    """-> (edges, plen, offset) from an npz saved by save_zipped."""
    choices = Ragged(z["zip_choices_values"], z["zip_choices_offsets"])
    plen = z["zip_plen"]
    edges = unzip_paths(
        bg,
        z["zip_first"],
        plen,
        choices,
        z["zip_raw_rows"],
        z["zip_raw_edges"],
        int(z["zip_mp"]),
    )
    return edges, plen, z["offset"]
