"""Unvoid: barcode-restricted local assembly across line-end gaps.

The port's own copy of supernova_tpu/asm/local.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.
The supergraph stage calls compute_mult; the scaffold stage calls unvoid
and unvoid_voids.

Analogue of 10X/BuildLocal.{h,cc} (GetBarcodes / BuildLocal1/2 / Unvoid,
called from CP's gap-capture and patch stages, CP.cc:790,1017-1023).  The
reference walks back GRAB=10000 kmers from a line end collecting barcodes
on unique base edges (BuildLocal.cc:83-95), pulls EVERY read of those
barcodes (placed or not — that is the point: reads inside the gap never
placed anywhere), builds a local assembly from them, and walks it from
the left flank to the right flank; closures are grafted back by Surgery.

The local assembly runs at the global K (48) as a host-side unitig
graph over the barcode reads — the analogue of BuildLocal's standard
local assembly + ClosuresToGraph (BuildLocal.cc:419-447).  The closure
between the two flank anchors is extracted as a sub-DAG; a linear
closure upgrades the {-2} gap edge to a {-3} sequence edge in place,
while a branched closure (e.g. a het SNP inside the gap) is grafted as
a subgraph of parallel {-3} edges — the analogue of Surgery appending
the local digraph Dl into D (BuildLocal.cc:895-1050, AppendWithUpdate
+ TransferEdgesWithUpdate).  Unlike Stackaroo the read set comes from
barcode membership, not placements, so reads that never placed
anywhere (the gap interior) participate.  The small-k majority walk
(asm/patch) remains as a fallback for read sets too thin to unitig.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.kmer_codec import K
from .patch import PATCH_K

import os

GRAB = 10_000  # kmers of line-end context to harvest barcodes from
LOCAL_THREADS = max(1, (os.cpu_count() or 4) - 1)  # local-assembly pool


def _parallel_map(fn, items):
    """Thread-parallel map preserving item order.  The per-gap local
    assemblies are dominated by GIL-releasing numpy (window packing,
    lexsort, bincounts), so threads scale on the 10 Mb+ walls without the
    fork hazards of a live JAX runtime (the reference runs these loops
    under OpenMP, BuildLocal.cc: #pragma omp)."""
    if len(items) <= 1 or LOCAL_THREADS == 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=LOCAL_THREADS) as pool:
        return list(pool.map(fn, items))
MAX_BARCODES = 1000  # promiscuous-edge and total-set gate
MIN_KMERS_PASSES = (1, 10)  # escalate the per-edge kmer gate if oversubscribed
MAX_READS = 8000  # local-assembly read budget (ref: 1M; our sims are smaller)
MAX_LOCAL_WALK = 20_000  # walk budget in bases (multi-read-length gaps)


def compute_mult(D) -> np.ndarray:
    """Multiplicity of each base edge across D's epaths (ComputeMult).
    Vectorized: one bincount over all non-gap rows' path entries (the
    per-edge Python loop was a wall at 1e6 D-edges)."""
    n_base = D.bg.n_edges
    gm = D.gap_mask()
    vals = np.asarray(D.epaths.values, np.int64)
    lens = np.asarray(D.epaths.lengths(), np.int64)
    if len(vals) == 0 or D.n_edges == 0:
        return np.zeros(n_base, np.int64)
    keep = np.repeat(~gm, lens)
    return np.bincount(vals[keep], minlength=n_base).astype(np.int64)


def build_adjacency(D):
    """(out-edges by from_v, in-edges by to_v) dicts for get_barcodes —
    build ONCE per pass and share: rebuilding per gap was O(E x gaps)."""
    inn: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        inn.setdefault(int(D.from_v[e]), []).append(e)
    into: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        into.setdefault(int(D.to_v[e]), []).append(e)
    return inn, into


def get_barcodes(
    D,
    d_end: int,
    ebcx,
    mult: np.ndarray,
    min_kmers: int,
    grab: int = GRAB,
    max_barcodes: int = MAX_BARCODES,
    adj=None,
) -> np.ndarray:
    """Barcodes on unique, well-behaved base edges within `grab` kmers
    walking backward from the end of D-edge `d_end` along its chain
    (GetBarcodes, BuildLocal.h:15-75; bubbles and gap edges are skipped
    over like the reference's 2-in/1-out walk).  `adj` = build_adjacency(D)
    shared across calls."""
    kmers = D.bg.edges.lengths() - (K - 1)
    inn, into = adj if adj is not None else build_adjacency(D)

    out: List[int] = []
    total = 0
    sc = d_end
    seen = set()
    while True:
        if sc in seen:
            break
        seen.add(sc)
        row = D.epaths.row(sc)
        if len(row) and int(row[0]) < 0:
            break
        for e in np.asarray(row, np.int64):
            e = int(e)
            if mult[e] != 1 or kmers[e] < min_kmers:
                continue
            bcs = ebcx.row(e)
            if len(bcs) > max_barcodes:
                continue
            out.extend(int(b) for b in bcs)
        total += int(kmers[np.asarray(row, np.int64)].sum())
        if total >= grab:
            break
        w = int(D.from_v[sc])
        ins = into.get(w, [])
        outs = inn.get(w, [])
        if len(ins) == 1 and len(outs) == 1 and D.is_gap(ins[0]):
            # skip over a gap edge (BuildLocal.h:48-52)
            x = int(D.from_v[ins[0]])
            if len(inn.get(x, [])) == 1 and len(into.get(x, [])) == 1:
                sc = into[x][0]
                continue
            break
        if len(ins) == 1 and len(outs) == 1:
            sc = ins[0]
            continue
        if len(ins) == 2 and len(outs) == 1:
            # bubble: harvest both arms, continue from before it
            d1, d2 = ins
            if D.from_v[d1] != D.from_v[d2]:
                break
            v = int(D.from_v[d1])
            if len(inn.get(v, [])) != 2 or len(into.get(v, [])) != 1:
                break
            for d in (d1, d2):
                rowd = D.epaths.row(d)
                if len(rowd) and int(rowd[0]) < 0:
                    continue
                for e in np.asarray(rowd, np.int64):
                    e = int(e)
                    if mult[e] != 1 or kmers[e] < min_kmers:
                        continue
                    bcs = ebcx.row(e)
                    if len(bcs) > max_barcodes:
                        continue
                    out.extend(int(b) for b in bcs)
                total += int(kmers[np.asarray(rowd, np.int64)].sum())
            if total >= grab:
                break
            sc = into[v][0]
            continue
        break
    return np.unique(np.asarray(out, np.int64)) if out else np.zeros(0, np.int64)


def _kmer_spectrum(seqs, k: int):
    """Both-strand kmer spectrum of the read set: sorted unique kmers packed
    big-endian base-4 into two uint64 halves (hi = first k//2 bases), with
    multiplicities.  Computed ONCE per read set and shared across the
    min_count escalation ladder (BuildLocal re-runs its local assembly with
    relaxed gates; the window extraction + sort is the shared 90%)."""
    assert k <= 64
    k1 = k // 2
    k2 = k - k1
    arrs = [np.asarray(s, np.uint8) for s in seqs if len(s) >= k]
    z = np.zeros(0, np.uint64)
    if not arrs:
        return z, z, np.zeros(0, np.int64)
    cat8 = np.concatenate(arrs)
    lens = np.array([len(s) for s in arrs], np.int64)
    # rc strand = complement of the whole stream reversed: read order also
    # reverses, but the multiset of within-read windows is identical, and
    # boundary windows are masked by the same ends logic below
    cat8 = np.concatenate([cat8, (cat8[::-1] ^ np.uint8(3))])
    lens = np.concatenate([lens, lens[::-1]])
    ends = np.cumsum(lens)
    # pack the stream into 32-base uint64 words (big-endian in-word), then
    # extract each window half as a 64-bit aligned segment — O(1) vector ops
    # per window instead of an (N, k) reduction
    pad = (-len(cat8)) % 32
    m = np.concatenate([cat8, np.zeros(pad + 32, np.uint8)]).reshape(-1, 32)
    words = np.zeros(len(m), np.uint64)
    for j in range(32):
        words <<= np.uint64(2)
        words |= m[:, j].astype(np.uint64)

    def _extract(pos: np.ndarray, kk: int) -> np.ndarray:
        """Packed kk-mer (kk <= 32) starting at each base position."""
        q, r = np.divmod(pos, 32)
        b = (r.astype(np.uint64)) * np.uint64(2)
        w0 = words[q]
        w1 = words[q + 1]
        # (w1 >> (63-b)) >> 1 is 0 at b == 0 (two shifts, each < 64)
        seg = (w0 << b) | ((w1 >> (np.uint64(63) - b)) >> np.uint64(1))
        return seg >> np.uint64(64 - 2 * kk)

    # window at flat position p is in-read iff p + k <= end of p's read
    n_win = len(cat8) - k + 1
    p = np.arange(n_win)
    owner_end = ends[np.searchsorted(ends, p, side="right")]
    p = p[p + k <= owner_end]
    hi = _extract(p, k1)
    lo = _extract(p + k1, k2)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    starts = np.r_[True, (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]
    sidx = np.flatnonzero(starts)
    cnt = np.diff(np.r_[sidx, len(hi)])
    return hi[sidx], lo[sidx], cnt


def _decode_codes(hi: np.ndarray, lo: np.ndarray, k1: int, k2: int) -> np.ndarray:
    """(n,) packed halves -> (n, k1+k2) uint8 base codes, vectorized."""
    out = np.empty((len(hi), k1 + k2), np.uint8)
    for j in range(k1):
        out[:, k1 - 1 - j] = (hi >> np.uint64(2 * j)) & np.uint64(3)
    for j in range(k2):
        out[:, k1 + k2 - 1 - j] = (lo >> np.uint64(2 * j)) & np.uint64(3)
    return out


def _unitig_edges_packed(hi: np.ndarray, lo: np.ndarray, k: int):
    """Unitig edges over a kept kmer set (packed halves, sorted unique).
    Integer-native throughout — node keys are packed (k-1)-mers, degrees
    come from bincounts, and the chain walk follows int successor arrays;
    only the final unitig sequences are decoded to strings (the per-kmer
    string decode + dict-of-strings walk was THE 10 Mb scaffold wall)."""
    from ..core import dna

    n = len(hi)
    if n == 0:
        return []
    k1 = k // 2
    k2 = k - k1
    u3 = np.uint64(3)
    mask1 = np.uint64((1 << (2 * (k1 - 1))) - 1)
    mask2 = np.uint64((1 << (2 * (k2 - 1))) - 1)
    # (k-1)-mer node keys in the (first k1 bases, last k2-1 bases) packing:
    # prefix = bases[0:k-1], suffix = bases[1:k]
    pre_a = hi
    pre_b = lo >> np.uint64(2)
    suf_a = ((hi & mask1) << np.uint64(2)) | (lo >> np.uint64(2 * (k2 - 1)))
    suf_b = lo & mask2
    nodes_a = np.concatenate([pre_a, suf_a])
    nodes_b = np.concatenate([pre_b, suf_b])
    order = np.lexsort((nodes_b, nodes_a))
    sa, sb = nodes_a[order], nodes_b[order]
    new = np.r_[True, (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])]
    uid_sorted = np.cumsum(new) - 1
    uid = np.empty(2 * n, np.int64)
    uid[order] = uid_sorted
    pre_id, suf_id = uid[:n], uid[n:]
    n_nodes = int(uid_sorted[-1]) + 1
    outdeg = np.bincount(pre_id, minlength=n_nodes)
    indeg = np.bincount(suf_id, minlength=n_nodes)
    simple = (outdeg == 1) & (indeg == 1)
    node_out = np.full(n_nodes, -1, np.int64)
    node_out[pre_id] = np.arange(n)  # valid where outdeg == 1
    starts = np.flatnonzero(~simple[pre_id])
    head_codes = _decode_codes(hi[starts], lo[starts], k1, k2)
    last_base = (lo & u3).astype(np.uint8)
    simple_l = simple.tolist()
    suf_l = suf_id.tolist()
    out_l = node_out.tolist()
    edges = []
    for si, i in enumerate(starts.tolist()):
        chain = []
        cur = suf_l[i]
        # only simple nodes are crossed, so no node repeats (re-entry would
        # need in-degree >= 2); termination is guaranteed
        while simple_l[cur]:
            j = out_l[cur]
            chain.append(j)
            cur = suf_l[j]
        if chain:
            seq = dna.codes_to_seq(
                np.concatenate([head_codes[si], last_base[chain]])
            )
        else:
            seq = dna.codes_to_seq(head_codes[si])
        edges.append((seq[: k - 1], seq[-(k - 1):], seq))
    return edges


class LocalAssembly:
    """Per-gap local assembly context: one kmer spectrum, unitig graphs
    materialized lazily per min_count gate (the escalation ladder reuses
    the spectrum instead of re-extracting every window)."""

    def __init__(self, seqs, k: int = K):
        self.k = k
        self.hi, self.lo, self.cnt = _kmer_spectrum(seqs, k)
        self._edges: Dict[int, list] = {}

    def edges(self, min_count: int):
        got = self._edges.get(min_count)
        if got is None:
            m = self.cnt >= min_count
            got = _unitig_edges_packed(self.hi[m], self.lo[m], self.k)
            self._edges[min_count] = got
        return got


def local_unipath_edges(seqs, k: int = K, min_count: int = 2):
    """Host-side unitig graph over the read set at kmer size k, both strands
    (the standalone analogue of BuildLocal's local assembly,
    BuildLocal.cc:419-447).  Returns [(from_node, to_node, seq)] where nodes
    are (k-1)-mer strings; adjacent unitigs overlap by k-1 bases — exactly
    the {-3} sequence-gap splice convention (GapAwareWalker)."""
    return LocalAssembly(seqs, k).edges(min_count)


def _compress_chain(cl, k: int):
    """Merge consecutive closure edges through nodes with unique in/out
    (side-branch pruning leaves unitig breaks with no surviving branch)."""
    while True:
        ins: Dict[str, List[int]] = {}
        outs: Dict[str, List[int]] = {}
        for i, (x, y, _s) in enumerate(cl):
            outs.setdefault(x, []).append(i)
            ins.setdefault(y, []).append(i)
        merged = False
        for node in list(ins):
            if node in ("L", "R"):
                continue
            if len(ins.get(node, ())) == 1 and len(outs.get(node, ())) == 1:
                i, j = ins[node][0], outs[node][0]
                if i == j:
                    continue
                x1, _y1, s1 = cl[i]
                _x2, y2, s2 = cl[j]
                cl = [e for t, e in enumerate(cl) if t not in (i, j)]
                cl.append((x1, y2, s1 + s2[k - 1 :]))
                merged = True
                break
        if not merged:
            return cl


def _extract_closure(edges, pat_l: str, pat_r: str, k: int,
                     max_bases: int, max_edges: int):
    """Sub-DAG of the local unitig graph from the left anchor kmer to the
    right anchor kmer (the Dl/d1/p1/d2/p2 match of BuildLocal.cc:930-950).
    Returns [(x, y, seq)] with x/y node ids or 'L'/'R' attachment marks;
    the first/last edges are trimmed so the closure starts with the left
    flank's last k-1 bases and ends with the right flank's first k-1."""
    loc_l = [(i, e[2].find(pat_l)) for i, e in enumerate(edges) if pat_l in e[2]]
    loc_r = [(i, e[2].find(pat_r)) for i, e in enumerate(edges) if pat_r in e[2]]
    if len(loc_l) != 1 or len(loc_r) != 1:
        return None  # anchors absent or ambiguously placed
    (i1, p1), (i2, p2) = loc_l[0], loc_r[0]
    if i1 == i2:
        if p2 <= p1:
            return None
        return [("L", "R", edges[i1][2][p1 + 1 : p2 + k - 1])]
    by_from: Dict[str, List[int]] = {}
    by_to: Dict[str, List[int]] = {}
    for j, (x, y, _s) in enumerate(edges):
        by_from.setdefault(x, []).append(j)
        by_to.setdefault(y, []).append(j)
    fwd = set()
    stack = [i1]
    while stack:
        j = stack.pop()
        if j in fwd:
            continue
        fwd.add(j)
        stack.extend(by_from.get(edges[j][1], ()))
    if i2 not in fwd:
        return None
    bwd = set()
    stack = [i2]
    while stack:
        j = stack.pop()
        if j in bwd:
            continue
        bwd.add(j)
        stack.extend(by_to.get(edges[j][0], ()))
    kept = fwd & bwd
    if len(kept) > max_edges:
        return None
    if sum(len(edges[j][2]) for j in kept) > max_bases + 2 * k:
        return None
    # cycle check (Kahn); in a DAG i1 is the unique source, i2 the sink
    succ = {
        j: [nj for nj in by_from.get(edges[j][1], ()) if nj in kept]
        for j in kept
    }
    indeg = {j: 0 for j in kept}
    for j in kept:
        for nj in succ[j]:
            indeg[nj] += 1
    queue = [j for j in kept if indeg[j] == 0]
    seen = 0
    while queue:
        j = queue.pop()
        seen += 1
        for nj in succ[j]:
            indeg[nj] -= 1
            if indeg[nj] == 0:
                queue.append(nj)
    if seen != len(kept):
        return None
    out = []
    for j in kept:
        x, y, s = edges[j]
        if j == i1:
            out.append(("L", y, s[p1 + 1 :]))
        elif j == i2:
            out.append((x, "R", s[: p2 + k - 1]))
        else:
            out.append((x, y, s))
    return _compress_chain(out, k)


def closure_graph(
    seqs,
    seq_l: str,
    seq_r: str,
    k: int = K,
    min_counts=(2, 1),
    max_bases: int = MAX_LOCAL_WALK,
    max_edges: int = 64,
):
    """Local-assembly closure between flank sequences: unitig the reads at
    the global K and extract the anchor-to-anchor sub-DAG, escalating to
    min_count=1 when the strict graph loses an anchor or the path."""
    pat_l, pat_r = seq_l[-k:], seq_r[:k]
    if len(pat_l) < k or len(pat_r) < k:
        return None
    la = LocalAssembly(seqs, k)
    for mc in min_counts:
        res = _extract_closure(la.edges(mc), pat_l, pat_r, k, max_bases, max_edges)
        if res is not None:
            return res
    return None


def barcode_reads(rs, barcodes: np.ndarray, max_reads: int = MAX_READS) -> np.ndarray:
    """All read ids of the given barcodes via the bci CSR index
    (BuildLocal.cc:99-123; barcode 0 = unbarcoded block is never grabbed)."""
    bci = np.asarray(rs.bci, np.int64)
    ids: List[np.ndarray] = []
    total = 0
    for b in barcodes:
        b = int(b)
        if b <= 0 or b + 1 >= len(bci):
            continue
        lo, hi = bci[b], bci[b + 1]
        if hi <= lo:
            continue
        ids.append(np.arange(lo, hi, dtype=np.int64))
        total += int(hi - lo)
        if total >= max_reads:
            break
    if not ids:
        return np.zeros(0, np.int64)
    return np.concatenate(ids)[:max_reads]


def _flanks(D) -> Dict[int, tuple]:
    """Canonical {-2} gap edge -> (eL, eR): unique non-gap in/out flanks."""
    from . import gap as agap

    into: Dict[int, List[int]] = {}
    outof: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        into.setdefault(int(D.to_v[e]), []).append(e)
        outof.setdefault(int(D.from_v[e]), []).append(e)
    out = {}
    for d in range(D.n_edges):
        if int(D.dinv[d]) <= d or not agap.is_bc_gap(D.epaths.row(d)):
            continue
        lefts = [
            e for e in into.get(int(D.from_v[d]), [])
            if e != d and not D.is_gap(e)
        ]
        rights = [
            e for e in outof.get(int(D.to_v[d]), [])
            if e != d and not D.is_gap(e)
        ]
        if len(lefts) == 1 and len(rights) == 1:
            out[d] = (lefts[0], rights[0])
    return out


def _apply_closures(D, linear: Dict[int, np.ndarray], grafts):
    """Apply closure edits: `linear` rows replace {-2} payloads in place;
    each graft (v, w, rv, rw, closure_edges, dels) appends the local
    sub-DAG as {-3} D-edges on both strands between v->w (rc strand
    rv->rw) and deletes the `dels` edges (Surgery, BuildLocal.cc:895-1050:
    AppendWithUpdate + TransferEdgesWithUpdate + gap deletion).  Returns
    (D', n_grafted); edge ids are only renumbered when a graft happened."""
    from ..core import dna
    from . import gap as agap
    from .capture import GraphEditor
    from .inversion import delete_edges

    g = GraphEditor(D)
    for d, row in linear.items():
        g.rows[d] = row
    n_grafted = 0
    edited_v = set()
    for v, w, rv, rw, cl, dels in grafts:
        if len({v, w, rv, rw}) != 4:
            continue  # degenerate/palindromic attachment
        if {v, w, rv, rw} & edited_v:
            continue  # edited-vertex guard (BuildLocal.cc:925-929)
        fmap = {"L": v, "R": w}
        rmap = {"L": rw, "R": rv}  # rc graft runs rv -> ... -> rw
        for x, y, _s in cl:
            for node in (x, y):
                if node not in fmap:
                    fmap[node] = g.add_vertex()
                    rmap[node] = g.add_vertex()
        for x, y, s in cl:
            codes = dna.seq_to_codes(s)
            row = agap.seq_to_gap(codes)
            a = g.add_edge(fmap[x], fmap[y], row)
            b = g.add_edge(rmap[y], rmap[x], agap.seq_to_gap(dna.revcomp(codes)))
            g.dinv[a] = b
            g.dinv[b] = a
        g.dels.extend(dels)
        edited_v |= {v, w, rv, rw}
        n_grafted += 1
    if not linear and n_grafted == 0:
        return D, 0
    D2 = g.build()
    if n_grafted or g.dels:
        D2 = delete_edges(D2, sorted(set(g.dels)), force=True)
    return D2, n_grafted


def unvoid(
    D,
    rs,
    ebcx,
    k: int = PATCH_K,
    max_reads: int = MAX_READS,
    ownership=None,
):
    """Close remaining {-2} gaps by barcode-restricted local assembly
    (Unvoid, BuildLocal.cc:1055-1233).  Linear closures upgrade the gap
    payload to {-3} in place; branched closures (het variation inside the
    gap) graft the local sub-DAG as parallel {-3} edges.  Returns
    (D', n_closed)."""
    from ..core import dna
    from . import gap as agap
    from .patch import _mini_dbg_walk

    if not getattr(rs, "barcoded", False):
        return D, 0
    flanks = _flanks(D)
    if not flanks:
        return D, 0
    mult = compute_mult(D)
    adj = build_adjacency(D)

    def work(item):
        d, eL, eR = item
        # barcode harvest from both sides (use_rights), with gate escalation
        bcs = np.zeros(0, np.int64)
        for min_kmers in MIN_KMERS_PASSES:
            bL = get_barcodes(D, eL, ebcx, mult, min_kmers, adj=adj)
            bR = get_barcodes(
                D, int(D.dinv[eR]), ebcx, mult, min_kmers, adj=adj
            )  # right side walks its rc strand backward
            bcs = np.union1d(bL, bR)
            if len(bcs) <= MAX_BARCODES:
                break
        if len(bcs) == 0 or len(bcs) > MAX_BARCODES:
            return None
        rids = barcode_reads(rs, bcs, max_reads)
        if len(rids) < 2:
            return None
        # closure anchors need only K bases of context; full edge_seq is
        # O(edge length) and was a scaffold wall at 10 Mb
        seq_l = dna.codes_to_seq(D.edge_tail_bases(eL, K))
        seq_r = dna.codes_to_seq(D.edge_head_bases(eR, K))
        if len(seq_l) < K or len(seq_r) < K:
            return None
        from .stackaroo import _fill_contradicts_estimate

        seqs = [rs.read(int(r)) for r in rids]

        def _pairs_ok(novel_seq: str) -> bool:
            # content fills must carry read-PAIR support through the fill
            # (wrong-copy fills are linking-invisible; asm/fillcheck.py)
            if not novel_seq:
                return True  # overlap/butt join: no novel content to judge
            from . import fillcheck as afc

            ok, _info = afc.verify_fill(
                D.edge_tail_bases(eL, 1000),
                dna.seq_to_codes(novel_seq),
                D.edge_head_bases(eR, 1000),
                rs, [int(r) for r in rids],
                ownership=ownership,
            )
            return ok

        cl = closure_graph(seqs, seq_l, seq_r)
        if cl is not None and len(cl) == 1 and cl[0][0] == "L" and cl[0][1] == "R":
            if _fill_contradicts_estimate(len(cl[0][2]), D.epaths.row(d)):
                return None  # repeat-flank bridge skipping real genome
            if not _pairs_ok(cl[0][2][K - 1 : max(K - 1, len(cl[0][2]) - (K - 1))]):
                return None
            return ("linear", d, cl[0][2])
        if cl is not None:
            rd = int(D.dinv[d])
            if d == rd:
                return None
            return (
                "graft",
                (
                    int(D.from_v[d]),
                    int(D.to_v[d]),
                    int(D.from_v[rd]),
                    int(D.to_v[rd]),
                    cl,
                    [d, rd],
                ),
            )
        # fallback: small-k majority walk (thin read sets)
        fill = _mini_dbg_walk(
            seqs, seq_l[-400:], seq_r[:400], k, max_walk=MAX_LOCAL_WALK
        )
        if fill is None or len(fill) < k:
            return None
        if _fill_contradicts_estimate(len(fill), D.epaths.row(d)):
            return None  # repeat-flank bridge skipping real genome
        if not _pairs_ok(fill[:-k]):
            return None
        gseq = seq_l[-(K - 1) :] + fill + seq_r[k : K - 1]
        return ("linear0", d, gseq)

    items = [(d, eL, eR) for d, (eL, eR) in flanks.items()]
    cap = int(os.environ.get("SN_UNVOID_CAP", "0"))  # profiling-only cap
    if cap:
        items = items[:cap]
    linear: Dict[int, np.ndarray] = {}
    grafts = []
    for res in _parallel_map(work, items):
        if res is None:
            continue
        if res[0] == "graft":
            grafts.append(res[1])
            continue
        kind, d, seq = res
        row = (
            agap.seq_to_gap(dna.seq_to_codes(seq))
            if kind == "linear"
            else agap.seq_to_gap(dna.seq_to_codes(seq), 0, 0)
        )
        linear[d] = row
        linear[int(D.dinv[d])] = agap.rc_gap(row)

    D2, n_grafted = _apply_closures(D, linear, grafts)
    return D2, len(linear) // 2 + n_grafted


MIN_LINE_TO_WALK = 1000  # CP.cc:731
NHOOD_DEPTH = 3  # CP.cc:732
MIN_AD = 0.9  # ChooseClosure advantage gate (BuildLocal.cc:1299)
LCONTENT_CAP = 5000  # bases of candidate-line front used for containment


def choose_closure(cands, line_fronts: Dict[int, str], k: int = K):
    """If two closures compete for one line end, pick a clear winner by
    kmer-content containment (ChooseClosure, BuildLocal.cc:1263-1308):
    frac[j] = fraction of candidate line j's front kmers contained in the
    OTHER closure's assembly; a >= MIN_AD advantage decides.  Returns the
    winning (s2, closure_edges) or None (ambiguous / >2 candidates)."""
    if len(cands) == 1:
        return cands[0]
    if len(cands) != 2:
        return None

    def kmer_set(cl):
        st = set()
        for _x, _y, s in cl:
            for i in range(len(s) - k + 1):
                st.add(s[i : i + k])
        return st

    dcontent = [kmer_set(c[1]) for c in cands]
    frac = []
    for j in (0, 1):
        seq = line_fronts.get(int(cands[j][0]), "")
        n_km = len(seq) - k + 1
        if n_km <= 0:
            return None
        present = sum(
            1 for i in range(n_km) if seq[i : i + k] in dcontent[1 - j]
        )
        frac.append(present / n_km)
    if frac[0] - frac[1] >= MIN_AD:
        return cands[0]
    if frac[1] - frac[0] >= MIN_AD:
        return cands[1]
    return None


def unvoid_voids(
    D,
    rs,
    ebcx,
    lines,
    line_bcs,
    llens,
    max_reads: int = MAX_READS,
    ownership=None,
):
    """First Unvoid call site (CP.cc:660-790): close VOIDS — line right
    ends that extend nowhere (no gap edge at all) — by walking the
    barcode-local assembly from the line's last edge toward the front
    edges of its barcode-neighborhood lines (lhood, NHOOD_DEPTH
    orientations each way).  Competing closures are arbitrated by
    ChooseClosure; the winner is grafted as a {-3} sub-DAG joining the
    two line-end vertices (Surgery).  Returns (D', n_closed)."""
    from ..core import dna
    from . import star as astar

    if not getattr(rs, "barcoded", False):
        return D, 0
    n = lines.n_lines
    if n == 0:
        return D, 0
    linv = np.asarray(lines.linv, np.int64)
    lhood = astar.line_prox(line_bcs, list(range(n)))
    indeg = np.bincount(D.to_v, minlength=D.n_vertices)
    outdeg = np.bincount(D.from_v, minlength=D.n_vertices)
    mult = compute_mult(D)
    adj = build_adjacency(D)
    gm = D.gap_mask()

    def last_edge(li):
        return int(lines.lines[li].elements[-1].paths[0][-1])

    def first_edge(li):
        return int(lines.lines[li].elements[0].paths[0][0])

    # cheap serial eligibility pass: find void line ends + their candidate
    # partner line starts (CP.cc:740-768)
    items = []
    for l1 in range(n):
        if llens[l1] < MIN_LINE_TO_WALK:
            continue
        s1 = last_edge(l1)
        if gm[s1]:
            continue  # "very weird thing" guard (CP.cc:740)
        v = int(D.to_v[s1])
        if outdeg[v] != 0 or indeg[v] > 1:
            continue  # not a void (CP.cc:742-743)
        # candidate partner lines: both orientations of the NHOOD_DEPTH
        # nearest neighbors (CP.cc:749-758)
        l2s = []
        for _s, l2 in lhood.get(l1, ())[:NHOOD_DEPTH]:
            for cand in (int(l2), int(linv[l2])):
                # the rc twin shares every barcode and always ranks high
                # in lhood; it is never a legitimate rightward partner
                if cand in (l1, int(linv[l1])):
                    continue
                if cand not in l2s:
                    l2s.append(cand)
        s2s = []
        overlaps = False
        for l2 in l2s:
            s2 = first_edge(l2)
            if len({s1, s2, int(D.dinv[s1]), int(D.dinv[s2])}) != 4:
                overlaps = True  # IsUnique fail (CP.cc:763-768)
                break
            if gm[s2]:
                continue
            w = int(D.from_v[s2])
            if indeg[w] != 0 or outdeg[w] != 1:
                continue  # partner start is not itself a void end
            s2s.append(s2)
        if overlaps or not s2s:
            continue
        items.append((s1, v, s2s))
    cap = int(os.environ.get("SN_UNVOID_CAP", "0"))  # profiling-only cap
    if cap:
        items = items[:cap]

    def work(item):
        s1, v, s2s = item
        # one barcode harvest + one local assembly per l1 (use_rights=False:
        # barcodes come from the s1 side only, CP.cc:787)
        bcs = np.zeros(0, np.int64)
        for min_kmers in MIN_KMERS_PASSES:
            bcs = get_barcodes(D, s1, ebcx, mult, min_kmers, adj=adj)
            if len(bcs) <= MAX_BARCODES:
                break
        if len(bcs) == 0 or len(bcs) > MAX_BARCODES:
            return None
        rids = barcode_reads(rs, bcs, max_reads)
        if len(rids) < 2:
            return None
        seq_l = dna.codes_to_seq(D.edge_tail_bases(s1, K))
        if len(seq_l) < K:
            return None
        seqs = [rs.read(int(r)) for r in rids]
        la = LocalAssembly(seqs, K)
        cands = []
        for mc in (2, 1):
            local_edges = la.edges(mc)
            cands = []
            for s2 in s2s:
                seq_r = dna.codes_to_seq(D.edge_head_bases(s2, K))
                if len(seq_r) < K:
                    continue
                cl = _extract_closure(
                    local_edges, seq_l[-K:], seq_r[:K], K,
                    MAX_LOCAL_WALK, 64,
                )
                if cl is not None:
                    cands.append((s2, cl))
            if cands:
                break
        if not cands:
            return None
        fronts = {
            s2: dna.codes_to_seq(D.edge_head_bases(s2, LCONTENT_CAP))
            for s2, _cl in cands
        }
        win = choose_closure(cands, fronts)
        if win is None:
            return None
        s2, cl = win
        if len(cl) == 1 and cl[0][0] == "L" and cl[0][1] == "R":
            # linear void closure inserts novel sequence between two line
            # ends: demand read-pair support through it (asm/fillcheck.py)
            novel = cl[0][2][K - 1 : max(K - 1, len(cl[0][2]) - (K - 1))]
            if novel:
                from . import fillcheck as afc

                ok, _info = afc.verify_fill(
                    D.edge_tail_bases(s1, 1000),
                    dna.seq_to_codes(novel),
                    D.edge_head_bases(s2, 1000),
                    rs, [int(r) for r in rids],
                    ownership=ownership,
                )
                if not ok:
                    return None
        return (
            v,
            int(D.from_v[s2]),
            int(D.to_v[int(D.dinv[s2])]),
            int(D.from_v[int(D.dinv[s1])]),
            cl,
            [],
        )

    grafts = [g for g in _parallel_map(work, items) if g is not None]
    if not grafts:
        return D, 0
    D2, n_grafted = _apply_closures(D, {}, grafts)
    return D2, n_grafted
