"""MarkBads + path extension.

The port's own copy of supernova_tpu/asm/bads.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.
K comes from the port's codec.

Reference analogues:
  * MarkBads (10X/SecretOps.h:22-35): a read is "bad" when it has more than
    MAX_Q30_MISMATCHES high-quality mismatches against the assembly; bad
    reads are excluded from closures and patching evidence.
  * ExtendPathsNew (10X/Extend.cc:15): extend read placements forward /
    backward through unambiguous graph walks when the read continues past
    its matched kmers (e.g. tail kmers were filtered), tolerating low-qual
    mismatches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.kmer_codec import K

MAX_Q30_MISMATCHES = 5  # SecretOps.h MarkBads threshold
Q_HI = 30


def spell_read_span(bg, edges, offset, length) -> np.ndarray | None:
    """Graph bases under a read placement (path edges overlap by K-1)."""
    if len(edges) == 0:
        return None
    seq = bg.edges.row(int(edges[0]))
    for e in edges[1:]:
        seq = np.concatenate([seq, bg.edges.row(int(e))[K - 1 :]])
    if offset < 0 or offset > len(seq):
        return None
    return seq[offset : offset + length]


def mark_bads(
    bg, rs, paths_edges, path_len, offset, max_mm: int = MAX_Q30_MISMATCHES
) -> np.ndarray:
    """-> bool (n_reads,): read disagrees with the assembly at > max_mm
    high-quality positions.

    Vectorized for single-edge placements (the vast majority); multi-edge
    placements fall back to per-read spelling."""
    n = rs.n_reads
    bad = np.zeros(n, dtype=bool)
    if n == 0:
        return bad
    plen = np.asarray(path_len[:n])
    off = np.asarray(offset[:n])
    rlen = np.diff(rs.offsets).astype(np.int64)
    lmax = int(rlen.max())
    gv = bg.edges.values
    goff = bg.edges.offsets

    single = np.nonzero(plen == 1)[0]
    if len(single):
        e = paths_edges[single, 0].astype(np.int64)
        span_start = goff[e] + off[single]
        span_len = np.minimum(rlen[single], goff[e + 1] - span_start)
        ok = (off[single] >= 0) & (span_len > 0)
        si = single[ok]
        if len(si):
            e = e[ok]
            span_start = span_start[ok]
            span_len = span_len[ok]
            cols = np.arange(lmax)
            gidx = span_start[:, None] + cols[None, :]
            inb = cols[None, :] < span_len[:, None]
            graph_b = gv[np.minimum(gidx, len(gv) - 1)]
            ridx = rs.offsets[si][:, None] + cols[None, :]
            rinb = cols[None, :] < rlen[si][:, None]
            read_b = rs.codes[np.minimum(ridx, len(rs.codes) - 1)]
            qual_b = rs.quals[np.minimum(ridx, len(rs.codes) - 1)]
            mm = (read_b != graph_b) & (qual_b >= Q_HI) & inb & rinb
            bad[si] = mm.sum(axis=1) > max_mm

    # multi-edge placements, vectorized over SLOTS (<= MAX_PATH) instead of
    # reads: per slot, the covered span window maps to one contiguous gv
    # range (edges overlap by K-1); chunked to bound the 2D temporaries
    multi = np.nonzero(plen > 1)[0]
    mp = paths_edges.shape[1]
    for c0 in range(0, len(multi), 131072):
        mi = multi[c0 : c0 + 131072]
        rm = len(mi)
        pe = paths_edges[mi].astype(np.int64)
        kk = plen[mi][:, None]
        slot = np.arange(mp)[None, :]
        live = slot < kk
        pes = np.clip(pe, 0, len(goff) - 2)
        el = (goff[pes + 1] - goff[pes]).astype(np.int64)
        seg = np.where(live, el - np.where(slot > 0, K - 1, 0), 0)
        cum = np.cumsum(seg, axis=1) - seg  # span offset of each segment
        total = seg.sum(axis=1)
        ok_read = (off[mi] >= 0) & (off[mi] <= total)
        cols = np.arange(lmax, dtype=np.int64)
        t_g = off[mi][:, None] + cols[None, :]
        ridx = rs.offsets[mi][:, None] + cols[None, :]
        rinb = cols[None, :] < rlen[mi][:, None]
        read_b = rs.codes[np.minimum(ridx, len(rs.codes) - 1)]
        qual_b = rs.quals[np.minimum(ridx, len(rs.codes) - 1)]
        graph_b = np.full((rm, lmax), -1, np.int16)
        for j in range(mp):
            lo = cum[:, j][:, None]
            m = (
                live[:, j][:, None]
                & (t_g >= lo)
                & (t_g < lo + seg[:, j][:, None])
                & rinb
                & ok_read[:, None]
            )
            if not m.any():
                continue
            src = (
                goff[pes[:, j]][:, None]
                + (K - 1 if j > 0 else 0)
                + (t_g - lo)
            )
            graph_b = np.where(
                m, gv[np.clip(src, 0, len(gv) - 1)].astype(np.int16), graph_b
            )
        mm = (read_b != graph_b) & (qual_b >= Q_HI) & (graph_b >= 0) & rinb
        bad[mi] = mm.sum(axis=1) > max_mm
    return bad


def unique_next_edges(bg) -> np.ndarray:
    """-> (E,) unique continuation edge after each edge, -1 if ambiguous."""
    outdeg = np.bincount(bg.from_v, minlength=bg.n_vertices)
    uniq_out = np.full(bg.n_vertices, -1, np.int64)
    uniq_out[bg.from_v] = np.arange(bg.n_edges)
    uniq_out[outdeg != 1] = -1
    return uniq_out[bg.to_v]


# qual-aware extension constants (ExtendReadPath.cc scoring shape: mismatch
# cost = capped base qual; a fork is taken only on a clear winner)
Q_CAP = 30  # per-mismatch penalty cap
WIN_MARGIN = 20  # fork winner must beat the runner-up by this much
_CHUNK = 1 << 16  # candidate rows scored per vectorized block


def _vertex_edge_table(heads: np.ndarray, n_vertices: int):
    """-> ((V, S) edge ids sorted by vertex, -1 pad).  S = max degree."""
    order = np.argsort(heads, kind="stable")
    sv = heads[order]
    first = np.concatenate([[True], sv[1:] != sv[:-1]])
    start = np.where(first, np.arange(len(sv)), 0)
    rank = np.arange(len(sv)) - np.maximum.accumulate(start)
    s = int(rank.max()) + 1 if len(sv) else 1
    tab = np.full((n_vertices, s), -1, np.int64)
    tab[sv, rank] = order
    return tab


def _score_steps(
    rs, flat_edge, elens, estarts, cand, cand_cov, cand_tail, succs, left: bool
):
    """Qual-weighted mismatch penalty of each candidate continuation edge.

    Returns (pen, take) of shape succs.shape; pen = +inf where invalid.
    `cand_cov`: for forward, read position where the new bases start; for
    backward, the count of uncovered read bases on the left (the window is
    read[cov-take : cov)).
    """
    nc, s = succs.shape
    pen = np.full((nc, s), np.inf, np.float32)
    body = elens[np.maximum(succs, 0)] - (K - 1)
    take = np.minimum(body, cand_tail[:, None]).astype(np.int64)
    valid = (succs >= 0) & (take > 0)
    w = int(take.max()) if valid.any() else 0
    if w == 0:
        return pen, take
    roff = rs.offsets[cand].astype(np.int64)
    for lo in range(0, nc, _CHUNK):
        hi = min(lo + _CHUNK, nc)
        j = np.arange(w, dtype=np.int64)[None, None, :]
        tk = take[lo:hi, :, None]
        ok = (j < tk) & valid[lo:hi, :, None]
        if left:
            # read window [cov-take, cov); edge window = body tail
            rpos = cand_cov[lo:hi, None, None] - tk + j
            epos = (
                estarts[np.maximum(succs[lo:hi], 0)][:, :, None]
                + body[lo:hi][:, :, None] - tk + j
            )
        else:
            rpos = cand_cov[lo:hi, None, None] + j
            epos = (
                estarts[np.maximum(succs[lo:hi], 0)][:, :, None]
                + (K - 1) + j
            )
        ridx = roff[lo:hi, None, None] + np.where(ok, rpos, 0)
        readb = rs.codes[ridx]
        readq = np.minimum(rs.quals[ridx], Q_CAP)
        edgeb = flat_edge[np.where(ok, epos, 0)]
        mm = (readb != edgeb) & ok
        pen[lo:hi] = np.where(
            valid[lo:hi],
            (mm * readq).sum(axis=2, dtype=np.int64).astype(np.float32),
            np.inf,
        )
    return pen, take


def _pick(pen: np.ndarray, take: np.ndarray, max_mm_frac: float):
    """Fork decision: winner index per row, or -1.

    A step is accepted when its penalty fits the window budget
    (max(1, max_mm_frac * take) mismatches at Q_CAP — the same tolerance the
    unambiguous-walk rule used) AND, at a fork, the winner beats the
    runner-up by WIN_MARGIN."""
    best = np.argmin(pen, axis=1)
    rows = np.arange(len(pen))
    bp = pen[rows, best]
    p2 = pen.copy()
    p2[rows, best] = np.inf
    second = p2.min(axis=1)
    bt = take[rows, best]
    budget = np.maximum(1, (max_mm_frac * bt).astype(np.int64)) * Q_CAP
    ok = np.isfinite(bp) & (bp <= budget)
    ok &= second >= bp + WIN_MARGIN  # inf runner-up always passes
    return np.where(ok, best, -1), bt


def extend_paths(
    bg, rs, paths_edges, path_len, offset, max_mm_frac: float = 0.1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Qual-aware bidirectional placement extension (ExtendPathsNew,
    10X/Extend.cc:15 + ExtendReadPath.cc scoring).

    When a read runs past its matched kmers (error/trimmed kmers were
    filtered from the dict), extend the placement through graph
    continuations: at forks each candidate edge is scored by the
    qual-capped sum of mismatches against the read window, and the winner
    is taken only when clearly better.  Backward extension prepends edges
    and shifts `offset` right.  Fully vectorized over candidate reads (one
    numpy pass per step), no per-read Python.

    Returns (paths_edges, path_len, offset, n_extended) — modified copies.
    """
    paths_edges = np.asarray(paths_edges).copy()
    path_len = np.asarray(path_len).copy()
    offset = np.asarray(offset).astype(np.int64).copy()
    n = rs.n_reads
    mp = paths_edges.shape[1]
    if n == 0:
        return paths_edges, path_len, offset, 0
    elens = bg.edges.lengths().astype(np.int64)
    estarts = bg.edges.offsets[:-1].astype(np.int64)
    flat_edge = bg.edges.values
    succ_tab = _vertex_edge_table(bg.from_v, bg.n_vertices)
    pred_tab = _vertex_edge_table(bg.to_v, bg.n_vertices)
    rlen = np.diff(rs.offsets).astype(np.int64)[:n]
    extended = np.zeros(n, bool)

    def chain_len(idx):
        pl = path_len[idx]
        slot_ok = np.arange(mp)[None, :] < pl[:, None]
        safe = np.clip(paths_edges[idx], 0, bg.n_edges - 1)
        return (
            np.where(slot_ok, elens[safe], 0).sum(axis=1)
            - np.maximum(pl - 1, 0) * (K - 1)
        )

    # ---- forward ----------------------------------------------------------
    live = np.nonzero((path_len[:n] >= 1) & (path_len[:n] < mp))[0]
    for _ in range(mp):
        if len(live) == 0:
            break
        tail = rlen[live] - (chain_len(live) - offset[live])
        live = live[tail > 0]
        tail = rlen[live] - (chain_len(live) - offset[live])
        if len(live) == 0:
            break
        last = paths_edges[live, path_len[live] - 1]
        succs = succ_tab[bg.to_v[np.clip(last, 0, None)]]
        cov = rlen[live] - tail  # first uncovered read position
        pen, take = _score_steps(
            rs, flat_edge, elens, estarts, live, cov, tail, succs, left=False
        )
        win, _ = _pick(pen, take, max_mm_frac)
        acc = win >= 0
        rows = live[acc]
        if len(rows):
            paths_edges[rows, path_len[rows]] = succs[acc, win[acc]]
            path_len[rows] += 1
            extended[rows] = True
        live = rows[path_len[rows] < mp]

    # ---- backward ---------------------------------------------------------
    live = np.nonzero(
        (path_len[:n] >= 1) & (path_len[:n] < mp) & (offset[:n] < 0)
    )[0]
    for _ in range(mp):
        if len(live) == 0:
            break
        left = -offset[live]
        first = paths_edges[live, 0]
        preds = pred_tab[bg.from_v[np.clip(first, 0, None)]]
        pen, take = _score_steps(
            rs, flat_edge, elens, estarts, live, left, left, preds, left=True
        )
        win, _ = _pick(pen, take, max_mm_frac)
        acc = win >= 0
        rows = live[acc]
        if len(rows):
            chosen = preds[acc, win[acc]]
            paths_edges[rows, 1:] = paths_edges[rows, :-1]
            paths_edges[rows, 0] = chosen
            path_len[rows] += 1
            offset[rows] += elens[chosen] - (K - 1)
            extended[rows] = True
        live = rows[(path_len[rows] < mp) & (offset[rows] < 0)]

    return paths_edges, path_len, offset, int(extended.sum())
