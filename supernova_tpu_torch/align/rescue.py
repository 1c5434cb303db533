"""Qual-tolerant seed rescue for unplaced reads.

The port's own copy of supernova_tpu/align/rescue.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.
K, JITTER and MAX_PATH come from the port's codec and pather.

Reference behavior: HBVPather::algorithmTwo seeds reads on the kmer dict
but tolerates errors at low-quality bases when seeding/extending
(BuildReadQGraph48.cc:1185-1438 + ExtendReadPath.cc qual scoring) — a read
whose every 48-mer window covers a sequencing error still paths.  The main
TPU pather (align/pather.py) uses exact dictionary seeds, which places
>99.9% of reads at typical error rates; this module recovers the residue
the reference would have placed: reads with ZERO exact kmer hits.

Design (host-side on purpose): the unplaced set is tiny, and a device
program here would add a new XLA program shape per run for microseconds of
compute.  For each unplaced read we substitute each of the
RESCUE_MAX_POSITIONS lowest-quality bases with its 3 alternatives (the
most-probable single-error corrections under the qual model), re-seed every
variant against the kmer dictionary with one vectorized numpy join, build
seed chains under the SAME rules as path_reads (captured-gap delta
agreement within JITTER, graph-adjacency + junction-position validation,
best-supported run wins), and accept the best variant chain iff its kmer
support reaches MIN_RESCUE_SUPPORT (guards against chance matches of a
corrected kmer).
"""
from __future__ import annotations

import numpy as np

from ..core.kmer_codec import K
from .pather import JITTER, MAX_PATH

# heuristic constants (addin-overridable; read at call time)
RESCUE_MAX_POSITIONS = 3  # lowest-qual positions to try correcting
MIN_RESCUE_SUPPORT = 2  # min kmer hits backing an accepted chain
RESCUE_MAX_READS = 1_000_000  # skip rescue above this many unplaced reads


# ------------------------------------------------------------ dict lookup

def _pack_windows(m: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(V, L) uint8 base codes -> three (V, L-K+1) uint32 word matrices
    (the W3 layout of every length-K window, vectorized over variants)."""
    v, L = m.shape
    cols = L - K + 1
    mu = m.astype(np.uint32)
    words = []
    for w in range(3):
        acc = np.zeros((v, cols), np.uint32)
        for i in range(16):
            c0 = w * 16 + i
            acc = (acc << np.uint32(2)) | mu[:, c0 : c0 + cols]
        words.append(acc)
    return words[0], words[1], words[2]


def _canonical_windows(m: np.ndarray):
    """Canonical (min of fwd/rc) words of every window + flipped flag."""
    fa, fb, fc = _pack_windows(m)
    rcm = (3 - m)[:, ::-1]
    ra3, rb3, rc3 = _pack_windows(rcm)
    # rc of fwd window j is rc-read window (cols-1-j): flip columns back
    ra3, rb3, rc3 = ra3[:, ::-1], rb3[:, ::-1], rc3[:, ::-1]
    flip = (ra3 < fa) | (
        (ra3 == fa) & ((rb3 < fb) | ((rb3 == fb) & (rc3 < fc)))
    )
    ca = np.where(flip, ra3, fa)
    cb = np.where(flip, rb3, fb)
    cc = np.where(flip, rc3, fc)
    return ca, cb, cc, flip


def lookup_words_np(table: np.ndarray, qa, qb, qc):
    """Exact lookup of query words in the sorted (M,3) uint32 kmer table.

    Vectorized two-level binary search: 64-bit (a,b) prefix runs first,
    then a composite (run_id, c) key — exact, no per-query loops.  Returns
    (row (N,) int64, found (N,) bool).
    """
    ta = table[:, 0].astype(np.uint64)
    tb = table[:, 1].astype(np.uint64)
    tc = table[:, 2].astype(np.uint32)
    hi = (ta << np.uint64(32)) | tb
    m = len(hi)
    if m == 0:
        n = len(qa)
        return np.zeros(n, np.int64), np.zeros(n, bool)
    starts = np.ones(m, bool)
    starts[1:] = hi[1:] != hi[:-1]
    run_id = np.cumsum(starts) - 1
    uh = hi[starts]
    key2 = (run_id.astype(np.uint64) << np.uint64(32)) | tc
    qhi = (qa.astype(np.uint64) << np.uint64(32)) | qb.astype(np.uint64)
    qrun = np.searchsorted(uh, qhi)
    qrun_safe = np.minimum(qrun, len(uh) - 1)
    run_ok = uh[qrun_safe] == qhi
    qkey2 = (qrun_safe.astype(np.uint64) << np.uint64(32)) | qc.astype(
        np.uint64
    )
    idx = np.searchsorted(key2, qkey2)
    idx_safe = np.minimum(idx, m - 1)
    found = (
        run_ok
        & (idx < m)
        & (table[idx_safe, 0] == qa)
        & (table[idx_safe, 1] == qb)
        & (table[idx_safe, 2] == qc)
    )
    return idx_safe.astype(np.int64), found


# ----------------------------------------------------------- chain builder

def _best_chains(vid, j, edge, epos, bg, max_path):
    """Per-variant best seed chain under path_reads' rules, vectorized.

    Inputs are the found-hit rows in (variant, window) order.  Returns a
    dict vid -> (edges list, support, p0, e0)."""
    if len(vid) == 0:
        return {}
    delta = epos.astype(np.int64) - j
    first = np.ones(len(vid), bool)
    first[1:] = vid[1:] != vid[:-1]
    new_slot = first.copy()
    new_slot[1:] |= (edge[1:] != edge[:-1]) | (
        np.abs(delta[1:] - delta[:-1]) > JITTER
    )
    slot_id = np.cumsum(new_slot) - 1
    n_slots = slot_id[-1] + 1
    support = np.bincount(slot_id, minlength=n_slots)
    s_start = np.flatnonzero(new_slot)
    s_vid = vid[s_start]
    s_edge = edge[s_start]
    s_p = j[s_start]  # entry_p: read pos of the slot's first hit
    s_e = epos[s_start]  # entry_e
    # junction validation between consecutive slots of the same variant
    ekm = bg.edges.lengths().astype(np.int64) - (K - 1)
    o = s_p.astype(np.int64) - s_e  # read coord where the slot's edge starts
    same = s_vid[1:] == s_vid[:-1]
    adj = bg.to_v[s_edge[:-1]] == bg.from_v[s_edge[1:]]
    pos_ok = np.abs(o[1:] - (o[:-1] + ekm[s_edge[:-1]])) <= JITTER
    valid_j = same & adj & pos_ok
    run_start = np.ones(n_slots, bool)
    run_start[1:] = ~valid_j
    run_id = np.cumsum(run_start) - 1
    n_runs = run_id[-1] + 1
    run_sup = np.bincount(run_id, weights=support, minlength=n_runs).astype(
        np.int64
    )
    r_start = np.flatnonzero(run_start)
    r_vid = s_vid[r_start]
    # best run per variant: support desc, then earliest run
    order = np.lexsort((np.arange(n_runs), -run_sup, r_vid))
    keep = np.ones(n_runs, bool)
    keep[1:] = r_vid[order][1:] != r_vid[order][:-1]
    best = order[keep]
    out = {}
    r_end = np.concatenate([r_start[1:], [n_slots]])
    for rn in best:
        s0, s1 = int(r_start[rn]), int(r_end[rn])
        s1 = min(s1, s0 + max_path)
        out[int(r_vid[rn])] = (
            s_edge[s0:s1].astype(np.int32),
            int(run_sup[rn]),
            int(s_p[s0]),
            int(s_e[s0]),
        )
    return out


# ----------------------------------------------------------------- rescue

def rescue_unplaced(bg, rs, edges, plen, offset, first_skip=None,
                    max_positions=None, min_support=None):
    """Rescue zero-hit reads by low-qual single-base correction.

    Returns (edges, plen, offset, n_rescued) — same contract as
    asm/bads.extend_paths (arrays copied iff anything was rescued)."""
    if max_positions is None:
        max_positions = RESCUE_MAX_POSITIONS
    if min_support is None:
        min_support = MIN_RESCUE_SUPPORT
    if bg.kmer_words is None or bg.n_kmers == 0:
        return edges, plen, offset, 0
    lens = rs.lengths()
    unplaced = np.flatnonzero((plen[: rs.n_reads] == 0) & (lens >= K))
    if len(unplaced) == 0 or len(unplaced) > RESCUE_MAX_READS:
        return edges, plen, offset, 0
    if not edges.flags.writeable:
        edges = edges.copy()
    if not plen.flags.writeable:
        plen = plen.copy()
    if not offset.flags.writeable:
        offset = offset.copy()
    table = np.asarray(bg.kmer_words[: bg.n_kmers])
    node_edge = np.asarray(bg.node_edge)
    node_pos = np.asarray(bg.node_pos)
    max_path = edges.shape[1]

    n_rescued = 0
    # group by read length so each group is a dense (V, L) matrix
    for L in np.unique(lens[unplaced]):
        rids = unplaced[lens[unplaced] == L]
        # variant matrix: per read, `max_positions` lowest-qual positions
        # x 3 alternative bases (deterministic: qual asc, position asc)
        reads = np.stack([rs.read(r) for r in rids])
        quals = np.stack([rs.qual(r) for r in rids])
        npos = min(max_positions, int(L))
        # argsort by (qual, position) — stable sort on position-major keys
        pos_sorted = np.argsort(quals, axis=1, kind="stable")[:, :npos]
        n_var = npos * 3
        vm = np.repeat(reads, n_var, axis=0)  # (U*n_var, L)
        rows = np.arange(len(rids) * n_var)
        p_of_v = pos_sorted[:, np.repeat(np.arange(npos), 3)].reshape(-1)
        a_of_v = np.tile(np.arange(1, 4, dtype=np.uint8), npos * len(rids))
        orig = vm[rows, p_of_v]
        vm[rows, p_of_v] = (orig + a_of_v) % 4
        ca, cb, cc, flip = _canonical_windows(vm)
        row, found = lookup_words_np(
            table, ca.ravel(), cb.ravel(), cc.ravel()
        )
        cols = int(L) - K + 1
        vflat = np.repeat(np.arange(len(rows)), cols)
        jflat = np.tile(np.arange(cols), len(rows))
        node = 2 * row + flip.ravel().astype(np.int64)
        f = np.flatnonzero(found)
        edge_h = node_edge[node[f]]
        ok = edge_h >= 0
        f = f[ok]
        chains = _best_chains(
            vflat[f],
            jflat[f],
            node_edge[node[f]],
            node_pos[node[f]],
            bg,
            max_path,
        )
        # best variant per read (support desc, variant index asc)
        for u, r in enumerate(rids):
            best = None
            for v in range(u * n_var, (u + 1) * n_var):
                ch = chains.get(v)
                if ch and (best is None or ch[1] > best[1]):
                    best = ch
            if best is None or best[1] < min_support:
                continue
            elist, _sup, p0, e0 = best
            plen[r] = len(elist)
            edges[r, : len(elist)] = elist
            edges[r, len(elist):] = -1
            offset[r] = e0 - p0
            if first_skip is not None:
                first_skip[r] = p0
            n_rescued += 1
    return edges, plen, offset, n_rescued
