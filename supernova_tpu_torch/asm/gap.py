"""First-class gap edges in the supergraph D.

The port's own copy of supernova_tpu/asm/gap.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of 10X/Gap.h: D-edges whose epath row starts with a negative code
are special "gap" edges instead of base-edge paths:

  * (-1)                       read-pair captured gap (IsPairGap, Gap.h:21)
  * (-2[, size])               barcode-only gap, optional predicted size
                               (IsBarcodeOnlyGap, Gap.h:26)
  * (-3, ltrim, rtrim, n, w..) sequence gap: n bases packed 16/word that
                               overlap the abutting edges by K-1 AFTER those
                               edges are trimmed by ltrim/rtrim bases
                               (IsSequence + SeqToGap/GapToSeq, Gap.h:28-43,
                               Gap.cc:179-200)
  * (-4, left, right, nv, ne,  captured cell: an abstracted subgraph with
     (from,to,len,path..)*)    entry/exit vertices (IsCell + cell class,
                               Gap.h:45-100; our encoding, not BINWRITE)

FASTA representation constants follow FastaEdgeWriter/ScafLinePrinter:
pair gaps print 100 Ns (_gap_repr_size, ScafLinePrinter.h:23), barcode-only
gaps without a size print 3000 Ns (bc_gap_repr, ScafLinePrinter.cc:106).

The involution image of a gap edge is computed by `rc_gap` (pair/bc gaps are
self-rc payloads; sequence gaps reverse-complement and swap trims — the rule
ValidateGapEdges enforces, Gap.cc:235-246).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core import dna

PAIR_GAP_REPR = 100  # Ns printed for a {-1} gap (ScafLinePrinter.h:23)
BC_GAP_REPR = 3000  # Ns for a sizeless {-2} gap (ScafLinePrinter.cc:106)
CELL_GAP_REPR = 10  # Ns when a cell can't be walked

_PER_WORD = 16  # bases packed per int (SeqToGap packs 16 2-bit bases/int)


# ------------------------------------------------------------- constructors


def pair_gap() -> np.ndarray:
    return np.array([-1], dtype=np.int64)


def bc_gap(size: int | None = None) -> np.ndarray:
    if size is None:
        return np.array([-2], dtype=np.int64)
    return np.array([-2, int(size)], dtype=np.int64)


def seq_to_gap(codes: np.ndarray, ltrim: int = 0, rtrim: int = 0) -> np.ndarray:
    """Pack a base-code vector into a {-3} row (SeqToGap, Gap.cc:179-188)."""
    codes = np.asarray(codes, dtype=np.int64)
    n = len(codes)
    assert n > 0 and ltrim >= 0 and rtrim >= 0
    nw = (n + _PER_WORD - 1) // _PER_WORD
    row = np.zeros(4 + nw, dtype=np.int64)
    row[0], row[1], row[2], row[3] = -3, ltrim, rtrim, n
    pos = np.arange(n)
    np.bitwise_or.at(row[4:], pos // _PER_WORD, codes << (2 * (pos % _PER_WORD)))
    return row


def gap_to_seq(row: np.ndarray) -> Tuple[int, int, np.ndarray]:
    """Unpack a {-3} row -> (ltrim, rtrim, codes) (GapToSeq, Gap.cc:190-200)."""
    row = np.asarray(row, dtype=np.int64)
    assert row[0] == -3 and len(row) >= 5
    ltrim, rtrim, n = int(row[1]), int(row[2]), int(row[3])
    pos = np.arange(n)
    codes = (row[4 + pos // _PER_WORD] >> (2 * (pos % _PER_WORD))) & 3
    return ltrim, rtrim, codes.astype(np.uint8)


# --------------------------------------------------------------- predicates


def is_gap(row) -> bool:
    return len(row) > 0 and int(row[0]) < 0


def is_pair_gap(row) -> bool:
    return int(row[0]) == -1


def is_bc_gap(row) -> bool:
    return int(row[0]) == -2


def is_seq_gap(row) -> bool:
    return int(row[0]) == -3


def is_cell_gap(row) -> bool:
    return int(row[0]) == -4


def overlaps_neighbors(row) -> bool:
    """Only {-3} sequence gaps carry the K-1 overlap with abutting edges."""
    return is_seq_gap(row)


def gap_repr_len(row) -> int:
    """Bases this gap contributes to emitted sequence (N run or seq len)."""
    c = int(row[0])
    if c == -1:
        return PAIR_GAP_REPR
    if c == -2:
        return int(row[1]) if len(row) >= 2 else BC_GAP_REPR
    if c == -3:
        return int(row[3])
    if c == -4:
        return CELL_GAP_REPR
    raise ValueError(f"not a gap row: {row!r}")


def rc_gap(row: np.ndarray, binv=None) -> np.ndarray:
    """Involution image of a gap row.  For {-4} cells the constituent paths
    reference base edges, so the rc cell maps each path through the base
    involution `binv` (required for cells; the other codes ignore it)."""
    c = int(row[0])
    if c in (-1, -2):
        return np.asarray(row, dtype=np.int64).copy()
    if c == -3:
        ltrim, rtrim, codes = gap_to_seq(row)
        return seq_to_gap(dna.revcomp(codes), rtrim, ltrim)
    if c == -4:
        left, right, nv, edges = cell_decode(row)
        if binv is None:
            raise ValueError("rc_gap of a {-4} cell needs the base involution")
        binv = np.asarray(binv, dtype=np.int64)
        redges = [
            (nv - 1 - t, nv - 1 - f, binv[np.asarray(p, np.int64)[::-1]])
            for f, t, p in edges
        ]
        return cell_encode(nv - 1 - right, nv - 1 - left, nv, redges)
    raise ValueError(f"not a gap row: {row!r}")


# -------------------------------------------------------------------- cells


def cell_encode(
    left: int, right: int, n_vertices: int, edges: List[Tuple[int, int, np.ndarray]]
) -> np.ndarray:
    """Encode a captured cell (cell::CellEncode analogue, Gap.cc:168-170;
    our layout: [-4, left, right, nv, ne, (from, to, len, path...)*])."""
    parts = [np.array([-4, left, right, n_vertices, len(edges)], dtype=np.int64)]
    for f, t, p in edges:
        p = np.asarray(p, dtype=np.int64)
        parts.append(np.array([f, t, len(p)], dtype=np.int64))
        parts.append(p)
    return np.concatenate(parts)


def cell_decode(row: np.ndarray):
    """-> (left, right, n_vertices, [(from, to, path)])."""
    row = np.asarray(row, dtype=np.int64)
    assert row[0] == -4
    left, right, nv, ne = int(row[1]), int(row[2]), int(row[3]), int(row[4])
    edges = []
    i = 5
    for _ in range(ne):
        f, t, n = int(row[i]), int(row[i + 1]), int(row[i + 2])
        edges.append((f, t, row[i + 3 : i + 3 + n].copy()))
        i += 3 + n
    return left, right, nv, edges


def cell_find_path(row: np.ndarray) -> List[np.ndarray] | None:
    """cell::FindPath analogue (Gap.cc:202-230): a left->right walk through
    the cell covering as many edges as possible (each edge used <= 2 times);
    returns the base-edge paths of the walked cell edges, or None."""
    left, right, nv, edges = cell_decode(row)
    out_adj: dict = {}
    for i, (f, t, p) in enumerate(edges):
        out_adj.setdefault(f, []).append((t, i))
    best: List[int] | None = None
    # bounded DFS preferring longer edge coverage (MAX_COPIES=2 per edge)
    stack: List[Tuple[int, List[int]]] = [(left, [])]
    iters = 0
    while stack and iters < 10_000:
        iters += 1
        v, acc = stack.pop()
        if v == right and acc:
            if best is None or len(acc) > len(best):
                best = acc
            continue
        if len(acc) > 2 * len(edges):
            continue
        for t, i in sorted(out_adj.get(v, [])):
            if acc.count(i) < 2:
                stack.append((t, acc + [i]))
    if best is None:
        return None
    return [edges[i][2] for i in best]


# ------------------------------------------------------------------- walker


class GapAwareWalker:
    """Accumulates a scaffold sequence from alternating non-gap stretches and
    gap edges, implementing FastaEdgeWriter's splice semantics: non-gap
    neighbors overlap by K-1; {-1}/{-2}/{-4} gaps break the overlap and
    splice N runs; {-3} gaps trim ltrim bases off the running sequence,
    splice their own bases with a K-1 overlap, and ask rtrim + K-1 off the
    next stretch."""

    def __init__(self, k: int):
        self.k = k
        self.parts: List[str] = []
        self._overlap = False  # next stretch overlaps K-1 with current end
        self._rtrim = 0

    def add_seq(self, s: str):
        if self._rtrim:
            s = s[self._rtrim :]
            self._rtrim = 0
        if self.parts and self._overlap:
            s = s[self.k - 1 :]
        self.parts.append(s)
        self._overlap = True

    def add_gap(self, row, seq_of_path=None):
        if is_seq_gap(row):
            ltrim, rtrim, codes = gap_to_seq(row)
            if ltrim:
                self._chop(ltrim)
            self.add_seq(dna.codes_to_seq(codes))
            self._rtrim = rtrim
            return
        if is_cell_gap(row) and seq_of_path is not None:
            paths = cell_find_path(row)
            if paths is not None:
                self.add_seq(seq_of_path(paths))
                return
        self.parts.append("N" * gap_repr_len(row))
        self._overlap = False
        self._rtrim = 0

    def _chop(self, n: int):
        while n > 0 and self.parts:
            last = self.parts[-1]
            if len(last) > n:
                self.parts[-1] = last[: len(last) - n]
                return
            n -= len(last)
            self.parts.pop()

    def sequence(self) -> str:
        return "".join(self.parts)
