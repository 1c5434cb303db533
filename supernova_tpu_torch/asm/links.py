"""Barcode-link triples: the AllTinksCore analogue as a sparse sort-join.

The port's own copy of supernova_tpu/asm/links.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (SecretOps.cc:807-867 AllTinksCore): for every "good"
barcode, every pair of items (edges there, lines here) that both carry reads
of that barcode scores one shared barcode; pairs with >= MIN_SHARED (4)
shared barcodes become link triples (i1, i2, n_shared) = the `qept` /
`a.bc_links` file.  The reference builds this with 20 batched passes over an
inverted barcode->edge index; here it is one vectorized all-pairs-per-run
expansion over the sorted (barcode, item) incidence list — O(sum_b k_b^2)
work with no Python loops, replacing the O(L^2) set-intersection fallback
(which is quadratic in the number of LINES regardless of barcode sparsity).

The device/mesh formulation lives in parallel/sharded_scaffold.py (SURVEY
§5.8: the barcode-link accumulation as owner-shard exchanges) and is tested
equal to this one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def incidence_from_sets(
    sets: List[np.ndarray], ids: Sequence[int] | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-item barcode sets -> flat (barcode, item) incidence rows.

    `sets[i]` must be deduplicated (each barcode at most once per item —
    a barcode contributes at most 1 to a pair's shared count)."""
    if ids is None:
        ids = range(len(sets))
    lens = [len(s) for s in sets]
    if sum(lens) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bcv = np.concatenate([np.asarray(s, np.int64) for s in sets if len(s)])
    item = np.repeat(
        np.fromiter(ids, np.int64, len(sets)), np.asarray(lens, np.int64)
    )
    return bcv, item


def link_triples_np(
    bcv: np.ndarray,
    item: np.ndarray,
    min_shared: int = 1,
    max_per_bc: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(barcode, item) incidence rows -> link triples (i1, i2, shared),
    i1 < i2, shared >= min_shared, sorted by (i1, i2).

    `max_per_bc`: drop barcodes touching more than this many items (hot
    barcodes carry little positional signal and cost k^2 work; the
    reference's good-barcode read-count gate serves the same purpose)."""
    bcv = np.asarray(bcv, np.int64)
    item = np.asarray(item, np.int64)
    z = (np.zeros(0, np.int64),) * 3
    if len(bcv) == 0:
        return z
    order = np.lexsort((item, bcv))
    b = bcv[order]
    v = item[order]
    starts = np.r_[True, b[1:] != b[:-1]]
    run_id = np.cumsum(starts) - 1
    run_start = np.flatnonzero(starts)
    q = np.arange(len(b), dtype=np.int64) - run_start[run_id]
    if max_per_bc is not None:
        # run length at every row = q at the run's last row + 1
        last = np.r_[run_start[1:], len(b)] - 1
        klen = (q[last] + 1)[run_id]
        ok = klen <= max_per_bc
        b, v = b[ok], v[ok]
        if len(b) == 0:
            return z
        starts = np.r_[True, b[1:] != b[:-1]]
        run_id = np.cumsum(starts) - 1
        run_start = np.flatnonzero(starts)
        q = np.arange(len(b), dtype=np.int64) - run_start[run_id]
    n_pairs = int(q.sum())
    if n_pairs == 0:
        return z
    # row r at in-run position q pairs with the q earlier rows of its run
    i2 = np.repeat(v, q)
    excl = np.cumsum(q) - q
    j = np.arange(n_pairs, dtype=np.int64) - np.repeat(excl, q) + np.repeat(
        run_start[run_id], q
    )
    i1 = v[j]  # v ascending within a run => i1 < i2
    m = int(v.max()) + 1
    key = i1 * m + i2
    uk, counts = np.unique(key, return_counts=True)
    keep = counts >= min_shared
    uk, counts = uk[keep], counts[keep]
    return uk // m, uk % m, counts.astype(np.int64)


def links_as_dict(i1, i2, s) -> Dict[Tuple[int, int], int]:
    return {(int(a), int(b)): int(c) for a, b, c in zip(i1, i2, s)}


def neighbors_ranked(
    i1, i2, s, max_view: int | None = None
) -> Dict[int, List[Tuple[int, int]]]:
    """Triples -> per-item candidate list [(shared, other), ...] ranked by
    shared desc then id asc (the LineProx `lhood` shape)."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    for a, b, c in zip(i1, i2, s):
        out.setdefault(int(a), []).append((int(c), int(b)))
        out.setdefault(int(b), []).append((int(c), int(a)))
    for k in out:
        out[k].sort(key=lambda t: (-t[0], t[1]))
        if max_view is not None:
            out[k] = out[k][:max_view]
    return out
