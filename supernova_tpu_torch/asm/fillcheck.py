"""Fill-content verification by spanning read PAIRS.

The port's own copy of supernova_tpu/asm/fillcheck.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The 10 Mb realistic rung's one residual misassembly class (pseudohap ori
0.23-0.49% across round-4 rephases) was wrong-copy gap fills: local
assembly at a repeat-flanked gap spells the OTHER repeat copy's
continuation, or bridges flank-to-flank through the repeat and skips real
genome.  Those fills are position-correct and barcode-continuous, so no
linking or discontinuity statistic can see them (asm/fixint.py measured a
healthy bridge fraction 0.66 at a known-wrong fill).  What does
distinguish them is read-pair CONTENT through the fill:

  * a CORRECT fill collects proper pairs (FR orientation, sane fragment
    length) whose fragments cross each flank/fill junction — the reads
    that spell the junction pair with mates anchored in unique flank;
  * against a WRONG fill, reads anchored in the unique flank have mates
    that spell the TRUE gap content — those mates fail to place anywhere
    in the filled junction, showing up as one-mate-mapped contradictions
    whose expected mate window lies inside the fill.

The reference never emits a fill without consensus support from the reads
it stacked (10X/Stackaroo.cc, 10X/BuildLocal.cc:192); this module is the
pair-resolution version of that rule: verify the CONTENT, reject on mixed
support, and let rejected gaps stay open as calibrated {-2} rows.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core import dna

SEED_K = 21  # mapping seed length (fills are built at PATCH_K=25)
# Thresholds separate SEQUENCING ERROR from REPEAT-COPY DIVERGENCE: a
# 150 bp read at 1.5% error matches ~0.985 of bases, while reads of the
# true locus laid against a ~93%-identical wrong-copy fill match ~0.93.
# The first cut (0.88 / 0.60) tolerated divergence, so true-locus mates
# "weakly placed" on wrong fills and contradictions never fired — the
# exact escape of the 10 Mb diverged-repeat {-3} windows.
MIN_MAP_FRAC = 0.96  # a read "places" when >= this fraction matches
CONTRA_FRAC = 0.94  # an expected mate matching below this contradicts
FRAG_MIN = 120  # proper-pair fragment bounds (sim inserts ~350;
FRAG_MAX = 1200  # reference ideal 350-400, alarms at <300/>100 extremes)
ANCHOR = 50  # bases a crossing fragment must extend past a junction
MIN_OVERLAP = 60  # min read/J overlap for a frac to be meaningful
# fills short enough that a typical (~350 bp) fragment can span them
# flank-to-flank MUST show such a pair: at a wrong join sealed by a short
# repeat-seam fill, both junctions verify locally (the repeat is genuinely
# continuous in both copies) but no fragment connects the two UNIQUE
# flanks, because in truth they sit megabases apart
SPAN_REQ_MAX = 250


MAX_OWNED_FRAC = 0.5  # fill kmers owned by LONG placed lines -> reject


def _sliding_words_np(codes: np.ndarray):
    """Numpy sliding 48-mer packing: (N,) codes -> 3 x (N-K+1,) uint32."""
    from ..core.kmer_codec import BASES_PER_WORD, K, KWORDS

    n = len(codes) - K + 1
    if n <= 0:
        return (np.zeros(0, np.uint32),) * 3
    c = codes.astype(np.uint32)
    words = []
    for w in range(KWORDS):
        acc = np.zeros(n, np.uint32)
        for i in range(BASES_PER_WORD):
            off = w * BASES_PER_WORD + i
            acc = (acc << np.uint32(2)) | c[off : off + n]
        words.append(acc)
    return tuple(words)


def fill_owned_frac(novel: np.ndarray, ownership) -> float | None:
    """Fraction of the fill's canonical 48-mers OWNED by a long placed
    line of the assembly.

    `ownership` = (wa, wb, wc, row_long) — the graph kmer dictionary's
    sorted word columns plus a bool per dict row marking kmers whose
    owning base edge lives in a LONG line (>= ~20 kb).  A wrong-copy or
    skip-genome fill duplicates the INTERIOR of a long line assembled and
    placed elsewhere; a TRUE fill spells either novel sequence (the
    assembly could not build it) or the content of SHORT fragments that
    merely failed to join — both score low.  None when the fill is too
    short to judge (< K+8 bases)."""
    from ..core.kmer_codec import K
    from ..kmer.count import _canon_np

    if isinstance(ownership, dict):
        (wa, wb, wc), row_long = ownership["words"], ownership["row_long"]
    else:
        wa, wb, wc, row_long = ownership
    if len(novel) < K + 8 or len(wa) == 0:
        return None
    a, b, c = _sliding_words_np(np.asarray(novel, np.uint8))
    qa, qb, qc = _canon_np(a, b, c)
    t1 = (wa.astype(np.uint64) << np.uint64(32)) | wb
    q1 = (qa.astype(np.uint64) << np.uint64(32)) | qb
    # row lookup (not just membership): walk the (rare) 64-bit prefix ties
    lo = np.searchsorted(t1, q1, side="left")
    hi = np.searchsorted(t1, q1, side="right")
    owned = np.zeros(len(q1), bool)
    cur = lo.copy()
    active = np.flatnonzero(cur < hi)
    while len(active):
        cv = wc[cur[active]]
        qv = qc[active]
        hit = cv == qv
        owned[active[hit]] = row_long[cur[active[hit]]]
        step = active[(~hit) & (cv < qv)]
        cur[step] += 1
        active = step[cur[step] < hi[step]]
    return float(owned.mean())


MIN_CONS_COVER = 3  # votes needed before a fill position is judged
MAX_CONS_MISMATCH = 0.03  # consensus disagreeing above this -> wrong copy


def fill_read_consensus(
    left_ctx: np.ndarray,
    novel: np.ndarray,
    right_ctx: np.ndarray,
    rs,
    rids: Sequence[int],
) -> Tuple[float | None, dict]:
    """Position-wise read consensus over the fill vs the fill itself.

    The one failure class junction/contradiction statistics cannot see is
    a fill spelling the WRONG copy of a diverged repeat pair (10 Mb r5
    localization: a 400-base ~93%-identical pair) — the pair's identity
    runs outspan a read, so every window statistic looks healthy.  But
    the placement-local reads at the gap come from the TRUE locus: piling
    them on the fill (mapped loosely, >= 0.85, so diverged reads still
    anchor) and taking a per-position majority exposes it — the consensus
    contradicts the fill exactly at the copy-diverged positions.
    Returns (mismatch_frac over covered positions, info); None frac when
    too little of the fill is read-covered to judge."""
    J = np.concatenate([left_ctx, novel, right_ctx]).astype(np.uint8)
    fill_lo = len(left_ctx)
    n = len(novel)
    if n < SEED_K + 8:
        return None, {"reason": "fill too short"}
    idx = _seed_index(J)
    votes = np.zeros((n, 4), np.int32)
    for rid in sorted({int(r) for r in rids})[:2000]:
        read = rs.read(rid)
        s, st, f = _best_placement(J, idx, read)
        if f < 0.85:
            continue
        rc = read if st == 1 else dna.revcomp(read)
        lo = max(0, fill_lo - s)
        hi = min(len(rc), fill_lo + n - s)
        if hi <= lo:
            continue
        pos = (s + np.arange(lo, hi)) - fill_lo
        votes[pos, rc[lo:hi]] += 1
    cover = votes.sum(axis=1)
    tot_c = votes.max(axis=1)
    judged = (cover >= MIN_CONS_COVER) & (tot_c * 3 >= cover * 2)
    if judged.sum() < n // 2:
        return None, {"reason": "fill under-covered", "judged": int(judged.sum())}
    cons = votes.argmax(axis=1)
    mism = float((cons[judged] != novel[judged]).mean())
    return mism, {
        "judged": int(judged.sum()), "mismatch_frac": round(mism, 4),
    }


def _seed_index(J: np.ndarray, k: int = SEED_K) -> Dict[bytes, List[int]]:
    idx: Dict[bytes, List[int]] = {}
    jb = J.tobytes()
    for i in range(0, len(J) - k + 1):
        idx.setdefault(jb[i : i + k], []).append(i)
    return idx


def _best_placement(
    J: np.ndarray, idx: Dict[bytes, List[int]], read: np.ndarray,
    k: int = SEED_K,
) -> Tuple[int, int, float]:
    """-> (start, strand, frac): best ungapped placement of `read` on J
    over both strands; start is the (possibly negative) offset of the
    read's first base, frac the match fraction over the J-overlapping
    part (0.0 when overlap < MIN_OVERLAP or no seed hits)."""
    n = len(J)
    best = (0, 0, 0.0)
    for strand, rc in ((1, read), (-1, dna.revcomp(read))):
        rl = len(rc)
        if rl < k:
            continue
        rb = rc.tobytes()
        votes: Dict[int, int] = {}
        for off in (0, rl // 2, rl - k):
            for p in idx.get(rb[off : off + k], ()):
                s = p - off
                votes[s] = votes.get(s, 0) + 1
        for s in sorted(votes, key=lambda t: -votes[t])[:3]:
            lo = max(0, s)
            hi = min(n, s + rl)
            ovl = hi - lo
            if ovl < MIN_OVERLAP:
                continue
            frac = float(np.mean(rc[lo - s : hi - s] == J[lo:hi]))
            if frac > best[2]:
                best = (s, strand, frac)
    return best


def verify_fill(
    left_ctx: np.ndarray,
    novel: np.ndarray,
    right_ctx: np.ndarray,
    rs,
    rids: Sequence[int],
    min_junction_pairs: int = 1,
    frag_max: int = FRAG_MAX,
    ownership=None,
) -> Tuple[bool, dict]:
    """Judge a candidate gap fill by read-pair support.

    left_ctx/right_ctx: flank base codes abutting the gap (a few hundred
    bases each); novel: the inserted fill content between them (may be
    empty for a butt join).  rids: the read ids the local assembly drew
    from; mates are rid^1 (ingest preserves pair adjacency).

    Accept iff proper pairs cross BOTH junctions (>= min_junction_pairs
    each) and one-mate contradictions pointing into the fill do not
    outnumber the supporting pairs.  With `ownership` (see
    fill_owned_frac), the fill must additionally not duplicate the
    interior of a LONG placed line: pair checks at a repeat-flanked
    junction cannot see a wrong copy whose repeat outspans the fragment
    length, but that content is owned by a line living elsewhere.
    -> (ok, info)."""
    if ownership is not None:
        kf = fill_owned_frac(np.asarray(novel, np.uint8), ownership)
        if kf is not None and kf > MAX_OWNED_FRAC:
            return False, {
                "reason": "fill duplicates a long placed line",
                "owned_frac": round(kf, 3), "fill_len": len(novel),
            }
        if rs is not None and len(novel) >= SEED_K + 8:
            mism, pinfo = fill_read_consensus(
                np.asarray(left_ctx, np.uint8), np.asarray(novel, np.uint8),
                np.asarray(right_ctx, np.uint8), rs, rids,
            )
            if mism is not None and mism > MAX_CONS_MISMATCH:
                return False, {
                    "reason": "local read consensus contradicts the fill",
                    **pinfo,
                }
    J = np.concatenate([left_ctx, novel, right_ctx]).astype(np.uint8)
    fill_lo = len(left_ctx)
    fill_hi = fill_lo + len(novel)
    n = len(J)
    if n < 2 * SEED_K:
        return False, {"reason": "context too short"}
    idx = _seed_index(J)

    pair_ids = sorted({int(r) // 2 for r in rids})
    if len(pair_ids) > 2000:  # judgment is ratio-based; a sample suffices
        pair_ids = pair_ids[:2000]
    placements: Dict[int, Tuple[int, int, float, int]] = {}

    def place(rid: int):
        if rid not in placements:
            read = rs.read(rid)
            s, st, f = _best_placement(J, idx, read)
            placements[rid] = (s, st, f, len(read))
        return placements[rid]

    left_cross = right_cross = interior = 0
    full_span = 0
    contra = 0
    for p in pair_ids:
        r1, r2 = 2 * p, 2 * p + 1
        s1, st1, f1, l1 = place(r1)
        s2, st2, f2, l2 = place(r2)
        m1, m2 = f1 >= MIN_MAP_FRAC, f2 >= MIN_MAP_FRAC
        # single well-placed reads crossing a junction are content
        # evidence too (a wrong-copy switch breaks read continuity at
        # some point; a full read matching across the boundary vouches
        # for it even when its mate falls outside J)
        for s, m, ln in ((s1, m1, l1), (s2, m2, l2)):
            if not m or s < 0 or s + ln > n:
                continue
            if s <= fill_lo - ANCHOR and s + ln >= min(fill_lo + ANCHOR, fill_hi):
                left_cross += 1
            if s + ln >= fill_hi + ANCHOR and s <= max(fill_hi - ANCHOR, fill_lo):
                right_cross += 1
            if s <= fill_lo - ANCHOR and s + ln >= fill_hi + ANCHOR:
                full_span += 1
        if m1 and m2:
            if st1 == st2:
                continue  # same-strand: not a proper pair
            # plus-strand mate must be leftmost (FR)
            (sp, lp), (sm, lm) = (
                ((s1, l1), (s2, l2)) if st1 == 1 else ((s2, l2), (s1, l1))
            )
            fs, fe = sp, sm + lm
            if fe <= fs or not (FRAG_MIN <= fe - fs <= frag_max):
                continue
            crossed = False
            if fs <= fill_lo - ANCHOR and fe >= min(fill_lo + ANCHOR, fill_hi):
                left_cross += 1
                crossed = True
            if fe >= fill_hi + ANCHOR and fs <= max(fill_hi - ANCHOR, fill_lo):
                right_cross += 1
                crossed = True
            if fs <= fill_lo - ANCHOR and fe >= fill_hi + ANCHOR:
                full_span += 1
            if not crossed and fs >= fill_lo and fe <= fill_hi:
                interior += 1
        elif m1 != m2:
            # one mate placed: does its expected mate window sit fully
            # inside J and intersect the fill?  then the unplaced mate
            # CONTRADICTS the fill content.
            s, st, _f, ln = (s1, st1, f1, l1) if m1 else (s2, st2, f2, l2)
            fo = f2 if m1 else f1
            if fo >= CONTRA_FRAC:
                continue  # weakly places — ambiguous, don't count
            if st == 1:
                w_lo, w_hi = s, s + frag_max
            else:
                w_lo, w_hi = s + ln - frag_max, s + ln
            if w_lo < 0 or w_hi > n:
                continue  # window exits J: mate may be legitimately outside
            if w_hi <= fill_lo or w_lo >= fill_hi:
                continue  # expected mate is pure flank — not a fill verdict
            contra += 1
    support = left_cross + right_cross + interior
    ok = (
        left_cross >= min_junction_pairs
        and right_cross >= min_junction_pairs
        and contra <= max(1, support // 4)
    )
    if len(novel) <= SPAN_REQ_MAX:
        ok = ok and full_span >= 1
    return ok, {
        "left_cross": left_cross, "right_cross": right_cross,
        "interior": interior, "full_span": full_span, "contra": contra,
        "fill_len": len(novel),
    }
