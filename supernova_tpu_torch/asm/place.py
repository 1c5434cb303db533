"""PlaceReads / PlaceReadsSmart: lift base-graph read paths onto D.

The port's own copy of supernova_tpu/asm/place.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of 10X/PlaceReads.cc (Align/Align2 place compressed read paths on
D; PlaceReadsSmart refines ambiguous placements with barcode context).
Because nucleation (asm/nucleate.py) duplicates repeat base edges into
multiple D-edges, base->D is multivalued; placement is:

  pass 1 (vectorized): reads whose path touches only uniquely-mapped base
    edges lift directly (run-compressed through the unique map);
  pass 2 (smart): reads touching duplicated base edges enumerate their
    consistent lifts (a lift walks one D epath and crosses D junctions
    only where the graph allows) and pick the lift with the most support
    from same-barcode pass-1 placements (ties -> smallest D-edge id,
    deterministic) — the barcode-aware choice of PlaceReadsSmart.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def base_to_super_map(D) -> Dict[int, Tuple[int, int]]:
    """base edge -> (D edge, index within its path); last wins when a base
    edge is duplicated (use build_base_candidates for the full map)."""
    out: Dict[int, Tuple[int, int]] = {}
    for d in range(D.n_edges):
        if D.is_gap(d):
            continue
        for j, e in enumerate(D.epaths.row(d)):
            out[int(e)] = (d, j)
    return out


def build_base_candidates(D, n_base: int):
    """-> (cand: base edge -> [(D edge, pos), ...], n_cand (E,) int64)."""
    cand: Dict[int, List[Tuple[int, int]]] = {}
    for d in range(D.n_edges):
        if D.is_gap(d):
            continue
        for j, e in enumerate(D.epaths.row(d)):
            cand.setdefault(int(e), []).append((d, j))
    n_cand = np.zeros(n_base, np.int64)
    for e, cs in cand.items():
        n_cand[e] = len(cs)
    return cand, n_cand


def super_of_base_array(D, n_base: int) -> np.ndarray:
    """base edge -> D edge id; -1 if uncovered or duplicated (ambiguous)."""
    return _unique_map(D, n_base)


def _unique_map(D, n_base: int):
    """base edge -> D edge where unique, -1 where uncovered or duplicated."""
    out = np.full(n_base, -1, np.int64)
    count = np.zeros(n_base, np.int8)
    for d in range(D.n_edges):
        if D.is_gap(d):
            continue
        row = np.unique(D.epaths.row(d))
        out[row] = d
        count[row] = np.minimum(count[row] + 1, 2)
    # a base edge appearing twice within ONE D-edge is still a unique map
    out[count > 1] = -1
    return out


def _lift_read(
    p: List[int],
    D,
    cand: Dict[int, List[Tuple[int, int]]],
    bc_score,
) -> List[int]:
    """All-consistent-lifts DP over one base path; returns the chosen
    D-edge sequence (run-compressed)."""
    # split into graph-adjacent runs
    runs: List[List[int]] = []
    cur = [p[0]]
    for a, b in zip(p, p[1:]):
        if D.bg.to_v[a] == D.bg.from_v[b]:
            cur.append(b)
        else:
            runs.append(cur)
            cur = [b]
    runs.append(cur)

    out: List[int] = []
    for run in runs:
        # DP states: (d, pos); score = # same-barcode supporting placements
        states: List[Tuple[Tuple[int, int], float, List[int]]] = [
            ((d, q), bc_score(d), [d]) for d, q in cand.get(run[0], [])
        ]
        for e in run[1:]:
            opts = cand.get(e, [])
            new: Dict[Tuple[int, int], Tuple[float, List[int]]] = {}
            for (d, q), sc, seq in states:
                plen_d = len(D.epaths.row(d))
                for d2, q2 in opts:
                    ok = (d2 == d and q2 == q + 1) or (
                        q == plen_d - 1
                        and q2 == 0
                        and D.to_v[d] == D.from_v[d2]
                    )
                    if not ok:
                        continue
                    seq2 = seq if d2 == d else seq + [d2]
                    sc2 = sc + (bc_score(d2) if d2 != d else 0.0)
                    key = (d2, q2)
                    if key not in new or sc2 > new[key][0] or (
                        sc2 == new[key][0] and seq2 < new[key][1]
                    ):
                        new[key] = (sc2, seq2)
            states = [(k, v[0], v[1]) for k, v in sorted(new.items())]
            if not states:
                break
        if states:
            best = max(states, key=lambda s: (s[1], [-x for x in s[2]]))
            seq = best[2]
        else:
            seq = []
        for d in seq:
            if not out or out[-1] != d:
                out.append(d)
    return out


MAX_BC_GAP = 100_000  # PlaceReads.cc:1233 group gap
MIN_BC_GROUP = 3  # PlaceReads.cc:1234 placements per group
TERRITORY_EXT = 25_000  # PlaceReads.cc:1284 window extension
TERRITORY_BONUS = 1_000.0  # dominates support-count tie-breaks


def barcode_territories(
    D,
    lines,
    dpaths: np.ndarray,
    dlen: np.ndarray,
    read_bc: np.ndarray,
    max_bc_gap: int = MAX_BC_GAP,
    min_group: int = MIN_BC_GROUP,
    ext: int = TERRITORY_EXT,
) -> Dict[int, set]:
    """Territory of each barcode: cluster its unambiguous placements into
    (line, position) groups (>= min_group placements, gaps <= max_bc_gap),
    extend each group's element window by ~ext bases both ways, and return
    the D-edges inside (PlaceReadsSmart, PlaceReads.cc:1200-1330; both
    strands included)."""
    from .molecules import element_offsets

    eline = np.asarray(lines.line_of_edge)
    nd = D.n_edges
    cached = getattr(lines, "_territory_maps", None)
    if cached is not None and cached[0] == nd:
        (_, epos, eunit, off_flat, off_line, line_base, n_el_arr,
         eoffs_abs, el_base, evals_g) = cached
    else:
        epos = np.full(nd, -1, np.int64)
        eunit = np.full(nd, -1, np.int64)
        L = len(lines.lines)
        # global per-element start offsets (off_flat, keyed by off_line for
        # composite-key searchsorted), per-line bases, and a global element
        # CSR (eoffs_abs -> evals_g) holding each element's edges + dinv
        off_chunks, offline_chunks = [], []
        eoffs_chunks, evals_chunks = [], []
        line_base = np.zeros(L + 1, np.int64)
        el_base = np.zeros(L + 1, np.int64)
        n_el_arr = np.zeros(L, np.int64)
        vbase = 0
        for li, ln in enumerate(lines.lines):
            offs = element_offsets(D, ln)
            n_el = len(ln.elements)
            vals = []
            eoffs = [0]
            for j, el in enumerate(ln.elements):
                ee = np.asarray(list(el.edge_ids()), np.int64)
                epos[ee] = offs[j]
                eunit[ee] = j
                both = np.concatenate([ee, D.dinv[ee]]) if len(ee) else ee
                vals.append(both)
                eoffs.append(eoffs[-1] + len(both))
            off_chunks.append(np.asarray(offs[:n_el], np.int64))
            offline_chunks.append(np.full(n_el, li, np.int64))
            line_base[li + 1] = line_base[li] + n_el
            n_el_arr[li] = n_el
            eoffs_chunks.append(np.asarray(eoffs, np.int64) + vbase)
            el_base[li + 1] = el_base[li] + n_el + 1
            v = np.concatenate(vals) if vals else np.zeros(0, np.int64)
            evals_chunks.append(v)
            vbase += len(v)
        z = np.zeros(0, np.int64)
        off_flat = np.concatenate(off_chunks) if off_chunks else z
        off_line = np.concatenate(offline_chunks) if offline_chunks else z
        eoffs_abs = np.concatenate(eoffs_chunks) if eoffs_chunks else z
        evals_g = np.concatenate(evals_chunks) if evals_chunks else z
        try:  # memoize: Lines/D are immutable between placement passes
            object.__setattr__(
                lines, "_territory_maps",
                (nd, epos, eunit, off_flat, off_line, line_base, n_el_arr,
                 eoffs_abs, el_base, evals_g),
            )
        except Exception:
            pass

    r, mp = dpaths.shape
    bc = np.asarray(read_bc)[:r]
    dl = np.asarray(dlen)[:r]
    valid = (np.arange(mp)[None, :] < dl[:, None]) & (dpaths >= 0)
    rows, cols = np.nonzero(valid)
    ds = dpaths[rows, cols].astype(np.int64)
    sel = (bc[rows] > 0) & (eline[np.clip(ds, 0, nd - 1)] >= 0)
    rows, ds = rows[sel], ds[sel]
    b = bc[rows].astype(np.int64)
    li = eline[ds]
    po = epos[ds]
    un = eunit[ds]
    order = np.lexsort((po, li, b))
    b, li, po, un = b[order], li[order], po[order], un[order]

    n = len(b)
    if n == 0:
        return {}
    # group breaks: new (barcode, line) or a position gap > max_bc_gap
    brk = np.ones(n, bool)
    brk[1:] = (
        (b[1:] != b[:-1]) | (li[1:] != li[:-1])
        | ((po[1:] - po[:-1]) > max_bc_gap)
    )
    gstart = np.nonzero(brk)[0]
    gcnt = np.diff(np.append(gstart, n))
    keep = gcnt >= min_group
    if not keep.any():
        return {}
    gs, gc = gstart[keep], gcnt[keep]
    bg = b[gs]
    lg = li[gs]
    un_min = np.minimum.reduceat(un, gstart)[keep]
    un_max = np.maximum.reduceat(un, gstart)[keep]
    un_first = un[gs]  # unit of the group's smallest position
    un_last = un[gs + gc - 1]
    # element-window extension by ~ext bases, via composite-key searchsorted
    # over the global (line, offset) array (offsets are sorted per line)
    m = np.int64(int(off_flat.max(initial=0)) + ext + 2)
    key = off_line * m + off_flat
    base_g = line_base[lg]
    off_first = off_flat[base_g + un_first]
    off_last = off_flat[base_g + un_last]
    lo = np.searchsorted(key, lg * m + (off_first - ext), side="right") - base_g
    start = np.maximum(np.minimum(un_min, lo), 0)
    hi = np.searchsorted(key, lg * m + (off_last + ext), side="left") - 1 - base_g
    stop = np.minimum(np.maximum(un_max, hi), n_el_arr[lg] - 1)
    # gather each group's element-window edges from the global CSR
    a0 = eoffs_abs[el_base[lg] + start]
    a1 = eoffs_abs[el_base[lg] + stop + 1]
    lens = a1 - a0
    tot = int(lens.sum())
    if tot == 0:
        return {}
    first = np.repeat(np.cumsum(lens) - lens, lens)
    gidx = np.repeat(a0, lens) + (np.arange(tot, dtype=np.int64) - first)
    pair = np.repeat(bg, lens) * np.int64(nd) + evals_g[gidx]
    uk = np.unique(pair)
    ub = uk // nd
    uv = uk % nd
    cut = np.nonzero(np.diff(ub))[0] + 1
    heads = np.concatenate([[0], cut])
    territories: Dict[int, set] = {
        int(ub[h]): set(block.tolist())
        for h, block in zip(heads, np.split(uv, cut))
    }
    return territories


def place_reads(
    D,
    paths_edges: np.ndarray,
    path_len: np.ndarray,
    read_bc: np.ndarray | None = None,
    lines=None,
):
    """-> (dpaths (R, MP) int32 D-edge ids -1-padded, dpath_len (R,)).
    With `lines` given (and barcodes), ambiguous reads resolve smart:
    candidates inside their barcode's territory dominate support-count
    tie-breaks (PlaceReadsSmart semantics)."""
    r, mp = paths_edges.shape
    n_base = D.bg.n_edges
    d_of = _unique_map(D, n_base)
    cand, n_cand = build_base_candidates(D, n_base)
    plen = np.asarray(path_len)[:r]

    slot_ok = np.arange(mp)[None, :] < plen[:, None]
    safe = np.clip(paths_edges, 0, n_base - 1)
    valid = slot_ok & (paths_edges >= 0)
    ambiguous_row = (valid & (n_cand[safe] > 1)).any(axis=1)

    # pass 1: run-compression through the unique map, fully 2D-vectorized:
    # the "previous mapped edge" (skipping -1 slots) comes from a row-wise
    # cummax of slot indices at valid cells + take_along_axis
    mapped = np.where(valid, d_of[safe], -1)
    has = mapped >= 0
    slot_i = np.broadcast_to(np.arange(mp)[None, :], (r, mp))
    last_valid = np.maximum.accumulate(np.where(has, slot_i, -1), axis=1)
    prev_valid = np.concatenate(
        [np.full((r, 1), -1, last_valid.dtype), last_valid[:, :-1]], axis=1
    )
    prev_val = np.take_along_axis(mapped, np.maximum(prev_valid, 0), axis=1)
    prev_val = np.where(prev_valid >= 0, prev_val, -1)
    emit = has & (mapped != prev_val) & ~ambiguous_row[:, None]
    kpos = np.cumsum(emit, axis=1) - 1
    dpaths = np.full((r, mp), -1, np.int32)
    ok2 = emit & (kpos < mp)
    rows2, cols2 = np.nonzero(ok2)
    dpaths[rows2, kpos[rows2, cols2]] = mapped[rows2, cols2]
    dlen = np.minimum(emit.sum(axis=1), mp).astype(np.int32)

    # pass 2: smart resolution of ambiguous reads by barcode support (+
    # territory restriction when lines are supplied — PlaceReadsSmart)
    amb = np.nonzero(ambiguous_row)[0]
    if len(amb):
        territories: Dict[int, set] = {}
        if lines is not None and read_bc is not None:
            territories = barcode_territories(
                D, lines, dpaths, dlen, read_bc
            )
        support: Dict[Tuple[int, int], int] = {}
        if read_bc is not None:
            bc = np.asarray(read_bc)[:r]
            flat = dpaths.reshape(-1).astype(np.int64)
            rows2 = np.repeat(np.arange(r), mp)
            sel = (flat >= 0) & (bc[rows2] > 0)
            key = bc[rows2[sel]].astype(np.int64) * np.int64(D.n_edges + 1) + flat[sel]
            uk, uc = np.unique(key, return_counts=True)
            support = dict(
                zip(
                    zip(
                        (uk // (D.n_edges + 1)).tolist(),
                        (uk % (D.n_edges + 1)).tolist(),
                    ),
                    uc.tolist(),
                )
            )
        bc_arr = np.asarray(read_bc)[:r] if read_bc is not None else None
        pe_host = np.asarray(paths_edges)
        for rr in amb:
            p = [int(e) for e in pe_host[rr, : plen[rr]] if e >= 0]
            if not p:
                continue
            if bc_arr is not None and int(bc_arr[rr]) > 0:
                b = int(bc_arr[rr])
                terr = territories.get(b)

                def score(d, b=b, terr=terr):
                    s = float(support.get((b, d), 0))
                    if terr is not None and d in terr:
                        s += TERRITORY_BONUS
                    return s
            else:
                score = lambda d: 0.0
            seq = _lift_read(p, D, cand, score)
            dlen[rr] = min(len(seq), mp)
            dpaths[rr, : dlen[rr]] = seq[: dlen[rr]]
    return dpaths, dlen


def dpath_counts(D, dpaths: np.ndarray, dlen: np.ndarray) -> np.ndarray:
    """Reads supporting each D-edge (a.dpaths.counts analogue)."""
    out = np.zeros(D.n_edges, np.int64)
    r, mp = dpaths.shape
    flat = dpaths.reshape(-1)
    slot = np.tile(np.arange(mp), r)
    keep = (flat >= 0) & (slot < np.repeat(dlen, mp))
    np.add.at(out, flat[keep], 1)
    return out
