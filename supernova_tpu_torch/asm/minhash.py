"""MinHash sketches of barcode sets — the `tada` min-hash experiment
analogue (lib/tada/src/min_hash/, SURVEY §2.1 "graph stats / exports").

The port's own copy of supernova_tpu/asm/minhash.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The reference sketches each scaffold/line's barcode set with k minimum
hash values so Jaccard similarity (the barcode-overlap signal behind
scaffolding) can be estimated in O(k) instead of a full set intersection.
Useful as a pre-filter in front of the exact AllTinks join when the number
of lines is very large.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SKETCH_K = 24


def _mix(x: np.ndarray, seed: np.uint32) -> np.ndarray:
    x = (x.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(29)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(32)
    return x


def sketch(bcs: np.ndarray, k: int = SKETCH_K, seed: int = 1) -> np.ndarray:
    """Barcode id set -> k smallest hash values (padded with u64 max)."""
    out = np.full(k, np.uint64(0xFFFFFFFFFFFFFFFF))
    if len(bcs):
        h = np.sort(_mix(np.asarray(bcs), np.uint32(seed)))[:k]
        out[: len(h)] = h
    return out


def jaccard_estimate(sa: np.ndarray, sb: np.ndarray) -> float:
    """Jaccard similarity estimate from two k-min sketches (merged-k rule:
    the k smallest DISTINCT values of the union — duplicates must collapse
    or shared minima occupy two slots and cap the estimate at ~0.5)."""
    k = len(sa)
    merged = np.unique(np.concatenate([sa, sb]))[:k]
    merged = merged[merged != np.uint64(0xFFFFFFFFFFFFFFFF)]
    if len(merged) == 0:
        return 0.0
    inter = len(np.intersect1d(merged, np.intersect1d(sa, sb)))
    return inter / len(merged)


def sketch_sets(sets: Sequence[np.ndarray], k: int = SKETCH_K) -> np.ndarray:
    """(L, k) sketch matrix for per-line barcode sets."""
    return np.stack([sketch(s, k) for s in sets]) if len(sets) else np.zeros(
        (0, k), np.uint64
    )


def candidate_pairs(
    sketches: np.ndarray, min_shared_hashes: int = 2
) -> List[Tuple[int, int]]:
    """Lines sharing >= min_shared_hashes sketch values — the cheap
    pre-filter: every pair with meaningful Jaccard shares sketch minima.
    Sort-join over (hash, line) rows; O(total sketch size)."""
    L, k = sketches.shape
    h = sketches.reshape(-1)
    item = np.repeat(np.arange(L, dtype=np.int64), k)
    real = h != np.uint64(0xFFFFFFFFFFFFFFFF)
    from .links import link_triples_np

    i1, i2, s = link_triples_np(
        h[real].astype(np.int64), item[real], min_shared=min_shared_hashes
    )
    return list(zip(i1.tolist(), i2.tolist()))
