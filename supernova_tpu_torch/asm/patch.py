"""Gap patching: close dead-end edge pairs with local assemblies.

The port's own copy of supernova_tpu/asm/patch.py, kept equal to it by
tests/test_torch_hostcopies.py, apart from the rebuild: insert_patches and
patch_graph take the device the rebuild's count and build run on (the
port's K1-K4 on a CUDA device); the reference's CPU-device context, a
workaround for remote-compile time on a TPU, is left out.

Reference behavior (SURVEY.md §2.1 "Gap patching" + §3.2):
  * FindEdgePairs: pairs of dead-end edges linked by read pairs/barcodes
    (10X/Closomatic.cc);
  * per-pair local closure from the supporting reads (Stackster read-stack
    consensus / CloseGap2, 10X/Stackster.cc, paths/long/ReadStack.cc);
  * StageInsertPatch: append closures to the edge set and rebuild the K=48
    graph, then re-path (RunStages.cc:177-232, kmers/BigKPather.cc).

v1 design: candidate discovery is vectorized over the path arrays; each
gap's local assembly is a small-k (k=25) DBG walk over the supporting reads
(host-side — gaps are few and tiny; the batched Pallas read-stack consensus
replaces this later).  Insertion rebuilds the graph from edge+closure
sequences via the standard count/build path with min_freq=1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import dna
from ..core.kmer_codec import K

PATCH_K = 25  # local-assembly kmer size (gap-fill only; final graph is K=48)
MIN_PAIR_SUPPORT = 2
MAX_GAP_WALK = 2000


@dataclass
class GapPair:
    e1: int  # dead-end edge whose END needs extension
    e2: int  # dead-end edge whose START needs extension
    support: int  # read pairs linking them
    read_ids: List[int]  # supporting reads (both mates)


def find_edge_pairs(
    bg, paths_edges, path_len, dup, min_support: int = MIN_PAIR_SUPPORT
) -> List[GapPair]:
    """Dead-end edge pairs linked by read pairs (FindEdgePairs analogue)."""
    E = bg.n_edges
    outdeg = np.bincount(bg.from_v, minlength=bg.n_vertices)
    indeg = np.bincount(bg.to_v, minlength=bg.n_vertices)
    dead_end = outdeg[bg.to_v] == 0  # edge's end extends nowhere
    dead_start = indeg[bg.from_v] == 0

    n_reads = paths_edges.shape[0]
    n_pairs = n_reads // 2
    plen = np.asarray(path_len)
    E = bg.n_edges

    # vectorized pair-link extraction: r1's last path edge x inv of r2's
    r1 = np.arange(0, 2 * n_pairs, 2)
    r2 = r1 + 1
    l1 = plen[r1]
    l2 = plen[r2]
    ok = (l1 > 0) & (l2 > 0)
    if dup is not None:
        ok &= ~np.asarray(dup)[:n_pairs]
    e1 = np.where(ok, paths_edges[r1, np.maximum(l1 - 1, 0)], -1)
    e2v = np.where(ok, paths_edges[r2, np.maximum(l2 - 1, 0)], -1)
    e2 = np.where(e2v >= 0, bg.inv[np.clip(e2v, 0, E - 1)], -1)
    ok &= (e1 >= 0) & (e2 >= 0) & (e1 != e2)
    ok &= dead_end[np.clip(e1, 0, E - 1)] & dead_start[np.clip(e2, 0, E - 1)]

    pairs_idx = np.nonzero(ok)[0]
    links: Dict[Tuple[int, int], List[int]] = {}
    for p in pairs_idx:
        links.setdefault((int(e1[p]), int(e2[p])), []).extend(
            (int(r1[p]), int(r2[p]))
        )

    # reads touching either flanking edge also feed the local assembly
    # (RunStages.cc:270-330); index only the edges that flank a gap
    flank = {e for pair in links for e in pair}
    touch: Dict[int, List[int]] = {e: [] for e in flank}
    if flank:
        mp = paths_edges.shape[1]
        slot_ok = np.arange(mp)[None, :] < plen[:, None]
        fe = paths_edges.copy()
        fe[~slot_ok] = -1
        flat = fe.reshape(-1)
        rows = np.repeat(np.arange(n_reads), mp)
        in_flank = np.isin(flat, list(flank))
        for e, r in zip(flat[in_flank], rows[in_flank]):
            lst = touch[int(e)]
            if len(lst) < 200:
                lst.append(int(r))

    out = []
    for (a, b), rids in sorted(links.items()):
        if len(rids) // 2 >= min_support:
            extra = touch.get(a, []) + touch.get(b, [])
            all_rids = sorted(set(rids) | set(extra))
            out.append(GapPair(a, b, len(rids) // 2, all_rids))
    return out


def _mini_dbg_walk(
    seqs: List[np.ndarray],
    left_anchor: str,
    right_anchor: str,
    k: int = PATCH_K,
    max_walk: int = MAX_GAP_WALK,
) -> Optional[str]:
    """Small-k DBG over the gap reads; walk from left_anchor's end kmer to
    right_anchor's start kmer following unambiguous majority extensions."""
    nxt: Dict[str, Dict[str, int]] = {}
    for s in seqs:
        t = dna.codes_to_seq(s)
        for strand in (t, dna.codes_to_seq(dna.revcomp(dna.seq_to_codes(t)))):
            for i in range(len(strand) - k):
                km = strand[i : i + k]
                nxt.setdefault(km, {}).setdefault(strand[i + k], 0)
                nxt[km][strand[i + k]] += 1
    cur = left_anchor[-k:]
    target = right_anchor[:k]
    built = []
    seen = set()
    for _ in range(max_walk):
        if cur == target:
            return "".join(built)
        if cur in seen:
            return None  # cycle
        seen.add(cur)
        exts = nxt.get(cur)
        if not exts:
            return None
        best = max(exts.items(), key=lambda kv: kv[1])
        # require clear majority to avoid chimeric fills
        if sum(exts.values()) - best[1] > best[1]:
            return None
        built.append(best[0])
        cur = cur[1:] + best[0]
    return None


def close_gaps(bg, rs, pairs: List[GapPair]) -> List[np.ndarray]:
    """Produce closure base sequences spanning each gap (closures.fastb
    analogue).  A closure is e1's terminal K-1 bases + fill + e2's leading
    K-1 bases, so reinsertion glues onto both edges.

    Primary closer is the read-stack consensus (Stackster/CloseGap2
    analogue, asm/stackster.py) — qual-weighted column votes tolerate read
    errors the exact-kmer DBG walk below fragments on; the walk remains as
    fallback for stacks too thin to vote."""
    from . import stackster as astk

    closures = []
    for gp in pairs:
        left = bg.edge_seq(gp.e1)
        right = bg.edge_seq(gp.e2)
        fill = astk.close_gap_stack(bg, rs, gp)
        if fill is not None:
            closure = left[-(2 * K):] + fill + right[: 2 * K]
        else:
            seqs = [rs.read(r) for r in gp.read_ids]
            walk = _mini_dbg_walk(seqs, left, right)
            if walk is None:
                continue
            # the walk stops when its window equals right[:PATCH_K], so the
            # fill already ends with those bases — append right AFTER them
            closure = left[-(2 * K):] + walk + right[PATCH_K : 2 * K]
        closures.append(dna.seq_to_codes(closure))
    return closures


def patch_readset(bg, closures: List[np.ndarray]):
    """The rebuild's reads: one strand of each edge (counting canonicalizes)
    plus the closures, padded to pairs with a zero-length mate, qual 37,
    unbarcoded (the reference's insert_patches, asm/patch.py:189-205)."""
    from ..ingest.reads import build_readset

    seqs: List[np.ndarray] = []
    for e in range(bg.n_edges):
        if e <= int(bg.inv[e]):  # one strand is enough; counting canonicalizes
            seqs.append(bg.edges.row(e))
    seqs.extend(closures)
    # pad to pairs (the ReadSet contract is paired); a zero-length mate is fine
    if len(seqs) % 2:
        seqs.append(np.zeros(0, dtype=np.uint8))
    quals = [np.full(len(s), 37, np.uint8) for s in seqs]
    return build_readset(
        seqs, quals, np.zeros(len(seqs) // 2, np.int32), n_barcodes=0,
        barcoded=False,
    )


def insert_patches(bg, closures: List[np.ndarray], device):
    """Rebuild the K=48 graph from current edges + closures
    (StageInsertPatch / buildBigKHBVFromReads_sleek analogue: all sequences
    re-kmerized with min_freq=1 and min_read_len=K, so single-kmer edges
    survive, then the standard unipath build), on `device`."""
    if not closures:
        return bg
    from ..dbg import build as dbuild
    from ..dbg import graph as dgraph
    from ..kmer import count as kcount

    prs = patch_readset(bg, closures)
    table = kcount.count_readset(prs, device, min_freq=1, min_read_len=K)
    table = dbuild.trim_table(table)
    dg = dbuild.build_graph(table)
    return dgraph.from_device(dg, table)


def patch_graph(bg, rs, paths_edges, path_len, dup, device):
    """Full DF patch stage: find pairs -> close -> rebuild.  Returns
    (new BaseGraph, n_pairs_found, n_closed)."""
    pairs = find_edge_pairs(bg, paths_edges, path_len, dup)
    closures = close_gaps(bg, rs, pairs)
    new_bg = insert_patches(bg, closures, device)
    return new_bg, len(pairs), len(closures)
