"""Barcode molecules: cluster read placements per (barcode, line) into
inferred long molecules; gap-size estimation from molecule spans.

The port's own copy of supernova_tpu/asm/molecules.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogues: barcode positions on lines `lbpx` (10X/LineOO.h:14
BarcodePos), the molecule-length histogram + lw_mean_mol_len stat
(CP.cc:952-972), and Gaprika's barcode-only gap sizing (10X/Gaprika.cc,
CP.cc:1578).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.kmer_codec import K

MOL_GAP = 50_000  # reads farther apart than this are different molecules
READ_LEN_TAIL = 150


@dataclass
class Molecule:
    bc: int
    line: int
    lo: int  # line coordinate span
    hi: int

    @property
    def length(self) -> int:
        return self.hi - self.lo + READ_LEN_TAIL


def element_offsets(D, line) -> List[int]:
    """Start coordinate of each element along the line (longest cell path;
    gap-aware junction arithmetic via cell_path_len)."""
    from .gap import is_seq_gap

    epaths = getattr(D, "epaths", None)  # test fakes carry edge_len only
    pos = [0]
    for el in line.elements:
        best = 0
        for p in el.paths:
            total = 0
            prev_no_ov = True  # no subtraction before the first edge
            for d in p:
                row = epaths.row(int(d)) if epaths is not None else np.zeros(0)
                no_ov = len(row) > 0 and row[0] < 0 and not is_seq_gap(row)
                total += D.edge_len(int(d))
                if not (prev_no_ov or no_ov):
                    total -= K - 1
                prev_no_ov = no_ov
            best = max(best, total)
        pos.append(pos[-1] + best)
    return pos


def edge_line_starts(D, lines) -> Tuple[np.ndarray, np.ndarray]:
    """-> (line_of (ED,), start_of (ED,)): per D-edge, its line id and its
    base start coordinate within the line (element offset + within-element
    walk position; first occurrence wins for edges on several cell paths)."""
    from .gap import is_seq_gap

    nd = D.n_edges
    line_of = np.full(nd, -1, np.int64)
    start_of = np.zeros(nd, np.int64)
    for li, ln in enumerate(lines.lines):
        offs = element_offsets(D, ln)
        for j, el in enumerate(ln.elements):
            for p in el.paths:
                cursor = offs[j]
                prev_no_ov = True
                for d in p:
                    d = int(d)
                    row = D.epaths.row(d)
                    no_ov = len(row) > 0 and row[0] < 0 and not is_seq_gap(row)
                    if not (prev_no_ov or no_ov):
                        cursor -= K - 1
                    if line_of[d] < 0:
                        line_of[d] = li
                        start_of[d] = cursor
                    cursor += D.edge_len(d)
                    prev_no_ov = no_ov
    return line_of, start_of


def base_prefix_table(D) -> Tuple[np.ndarray, np.ndarray]:
    """-> sorted (keys, prefixes): key = d * n_base + base_edge, prefix =
    base offset of that base edge within D-edge d's spelled sequence (first
    occurrence).  Lookup via np.searchsorted."""
    blens = D.bg.edges.lengths()
    n_base = D.bg.n_edges
    keys: List[np.ndarray] = []
    prefs: List[np.ndarray] = []
    for d in range(D.n_edges):
        p = D.epaths.row(d)
        if len(p) == 0 or p[0] < 0:
            continue
        steps = blens[p].astype(np.int64) - (K - 1)
        pref = np.concatenate([[0], np.cumsum(steps[:-1])])
        keys.append(d * np.int64(n_base) + p.astype(np.int64))
        prefs.append(pref)
    if not keys:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k = np.concatenate(keys)
    v = np.concatenate(prefs)
    order = np.argsort(k, kind="stable")  # stable: first occurrence first
    k, v = k[order], v[order]
    first = np.concatenate([[True], k[1:] != k[:-1]])
    return k[first], v[first]


def read_line_positions(
    D,
    lines,
    dpaths: np.ndarray,
    dlen: np.ndarray,
    read_bc: np.ndarray,
    base_paths=None,
) -> Dict[Tuple[int, int], List[int]]:
    """(barcode, line) -> read positions in line coordinates.  With
    `base_paths=(edges, plen, offset)` (the base-graph read paths),
    positions are base-resolution: D-edge line start + the first base
    edge's prefix within the D-edge + the read's in-edge offset (the
    reference's BarcodePos/lbpx, 10X/LineOO.h:14).  Without, positions
    fall back to the D-edge start coordinate."""
    line_of_e, start_of_e = edge_line_starts(D, lines)
    nd = D.n_edges
    line_of = np.concatenate([line_of_e, [-1]])
    pos_of = np.concatenate([start_of_e, [0]])
    n = dpaths.shape[0]
    bc = np.asarray(read_bc)[:n]
    d0 = np.where(np.asarray(dlen)[:n] > 0, dpaths[:n, 0], nd).astype(np.int64)
    d0 = np.clip(d0, 0, nd)
    li = line_of[d0]
    keep = (bc > 0) & (li >= 0)
    within = np.zeros(n, np.int64)
    if base_paths is not None:
        redges, rplen, roffset = base_paths
        redges = np.asarray(redges)[:n]
        rplen = np.asarray(rplen)[:n]
        roffset = np.asarray(roffset)[:n]
        has_base = rplen > 0
        e0 = np.where(has_base, redges[:, 0], 0).astype(np.int64)
        keys, prefs = base_prefix_table(D)
        if len(keys):
            want = d0 * np.int64(D.bg.n_edges) + e0
            idx = np.searchsorted(keys, want)
            idx = np.clip(idx, 0, len(keys) - 1)
            hit = (keys[idx] == want) & has_base & (d0 < nd)
            within = np.where(
                hit, prefs[idx] + np.maximum(roffset, 0), 0
            ).astype(np.int64)
    out: Dict[Tuple[int, int], List[int]] = {}
    kb, kl = bc[keep], li[keep]
    kp = pos_of[d0[keep]] + within[keep]
    order = np.lexsort((kp, kl, kb))
    kb, kl, kp = kb[order], kl[order], kp[order]
    if len(kb):
        starts = np.concatenate(
            [[True], (kb[1:] != kb[:-1]) | (kl[1:] != kl[:-1])]
        )
        idxs = np.nonzero(starts)[0].tolist() + [len(kb)]
        for a, b in zip(idxs, idxs[1:]):
            out[(int(kb[a]), int(kl[a]))] = kp[a:b].tolist()
    return out


def infer_molecules(positions: Dict[Tuple[int, int], List[int]], gap: int = MOL_GAP) -> List[Molecule]:
    mols: List[Molecule] = []
    for (bc, li), pos in positions.items():
        pos = sorted(pos)
        lo = prev = pos[0]
        for p in pos[1:]:
            if p - prev > gap:
                mols.append(Molecule(bc, li, lo, prev))
                lo = p
            prev = p
        mols.append(Molecule(bc, li, lo, prev))
    return mols


def lw_mean_length(mols: List[Molecule]) -> float:
    """Length-weighted mean molecule length (the lw_mean_mol_len stat)."""
    if not mols:
        return 0.0
    ls = np.array([m.length for m in mols], dtype=np.float64)
    return float((ls**2).sum() / ls.sum())


def estimate_gap(
    mols_by_bc_line: Dict[Tuple[int, int], List[Molecule]],
    line_a: int,
    len_a: int,
    line_b: int,
    default: int = 100,
    max_gap: int = 10_000,
) -> int:
    """Gaprika-style {-2} gap estimate between scaffolded lines a -> b:
    for barcodes with molecules on BOTH lines, the unspanned remainder of
    the molecule length bounds the gap.  Falls back to `default`."""
    ests = []
    bcs_a = {bc for (bc, li) in mols_by_bc_line if li == line_a}
    for bc in bcs_a:
        ma = mols_by_bc_line.get((bc, line_a))
        mb = mols_by_bc_line.get((bc, line_b))
        if not ma or not mb:
            continue
        # molecule reaching the end of line a and the start of line b:
        end_a = max(m.hi for m in ma)
        start_b = min(m.lo for m in mb)
        slack_a = max(len_a - end_a, 0)
        total = max(m.length for m in ma) + max(m.length for m in mb)
        est = max(total - (end_a - min(m.lo for m in ma)) - start_b - slack_a, 0)
        ests.append(min(est, max_gap))
    if not ests:
        return default
    return int(np.median(ests)) or default
