"""Inverted path indexes: edge -> reads, edge -> barcodes.

The port's own copy of supernova_tpu/align/index.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of the reference's PathsIndex (10X/PathsIndex.cc: per-edge read-id
lists, `writePathsIndex`) and computeEdgeToBarcodeX (edge -> barcode multiset
`ebcx`, 10X/PathsIndex.cc:297).  Host-side numpy sorts at stage granularity;
the scaffolding stage consumes these as CSR arrays.
"""
from __future__ import annotations

import numpy as np

from ..core.ragged import Ragged, lengths_to_offsets


def _pairs_from_paths(paths_edges: np.ndarray, path_len: np.ndarray):
    """(R, MAX_PATH) padded edge ids -> (edge, read) pair arrays."""
    r, mp = paths_edges.shape
    read_ids = np.repeat(np.arange(r, dtype=np.int64), mp)
    edges = paths_edges.reshape(-1).astype(np.int64)
    slot = np.tile(np.arange(mp), r)
    keep = (edges >= 0) & (slot < np.repeat(path_len, mp))
    return edges[keep], read_ids[keep]


def paths_index(paths_edges: np.ndarray, path_len: np.ndarray, n_edges: int) -> Ragged:
    """edge -> sorted read ids (one entry per traversal)."""
    e, r = _pairs_from_paths(paths_edges, path_len)
    order = np.lexsort((r, e))
    e, r = e[order], r[order]
    counts = np.bincount(e, minlength=n_edges)
    return Ragged(r, lengths_to_offsets(counts))


def edge_barcodes(
    paths_edges: np.ndarray, path_len: np.ndarray, read_bc: np.ndarray, n_edges: int
) -> Ragged:
    """ebcx analogue: edge -> sorted multiset of barcode ids (>0 only)."""
    e, r = _pairs_from_paths(paths_edges, path_len)
    bc = read_bc[r]
    keep = bc > 0
    e, bc = e[keep], bc[keep]
    order = np.lexsort((bc, e))
    e, bc = e[order], bc[order]
    counts = np.bincount(e, minlength=n_edges)
    return Ragged(bc, lengths_to_offsets(counts))


def edge_read_counts(paths_edges, path_len, n_edges: int) -> np.ndarray:
    """countsb analogue: reads supporting each edge."""
    e, _ = _pairs_from_paths(paths_edges, path_len)
    return np.bincount(e, minlength=n_edges).astype(np.int64)
