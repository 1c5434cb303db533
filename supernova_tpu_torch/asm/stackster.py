"""Read-stack consensus for gap closure — the Stackster / ReadStack /
CloseGap2 analogue.

The port's own copy of supernova_tpu/asm/stackster.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior (SURVEY.md §2.1 "Gap patching"): per dead-end edge pair,
gather the supporting reads, align them into a common coordinate frame (a
"read stack"), and call a quality-weighted per-column consensus across the
gap (10X/Stackster.cc, paths/long/ReadStack.cc, CloseGap2 in
10X/Closomatic.cc).

TPU-native shape: a stack is a dense (reads x columns) matrix of base codes
plus a parallel capped-qual matrix; the consensus is a one-hot
qual-weighted vote per column — pure batched matrix ops (vectorized numpy
here; the same expression lifts to a (gaps x reads x columns) jnp batch on
device when gap counts reach production scale).  Read placement anchors on
exact shared k-mers with the flank sequence (host-side; read sets per gap
are bounded).

Closure strategy: grow a consensus extension rightward from e1's end and
leftward from e2's start, then join the two extensions on an exact overlap
(>= JOIN_OVERLAP) — the two-sided walk of CloseGap2.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core import dna
from ..core.kmer_codec import K

ANCHOR_K = 21  # seed k for placing reads on the flank
QCAP = 30  # per-base qual cap in the vote (ReadStack caps quals)
MIN_WIN_Q = 60  # winner must lead the runner-up by ~2 confident bases
JOIN_OVERLAP = 30  # exact overlap to join the two extensions
FLANK_W = 200  # flank window the stack is anchored on
MAX_EXT = 600  # max consensus extension per side
# ReadStack.cc:422-427 — a runner-up with this much qual weight and >= 2
# confident readers means real divergence (het arm / repeat copy), not noise
MAX_QCOMP = 100
MIN_ALT_Q30 = 2
# branching bound: <= 2 forks -> <= 4 candidate extensions per side
# (Consensuses1-style multi-candidate closure, ReadStack.cc:846)
MAX_FORKS = 2
# HighQualDiff founder filter (ReadStack.cc:489): a stacked read with >= 2
# confident disagreements against the flank is a misplaced repeat-copy read
FOUNDER_MAX_DIFFS = 2


# CleanColumns thresholds (ReadStack.cc:498-515)
CLEAN_MIN_Q = 20
CLEAN_MIN_COUNT = 3
# PairWeak1 thresholds (ReadStack.cc:727-748)
PAIRWEAK_MIN_WIN = 100
PAIRWEAK_RATIO = 10
# MotifDiff stripe width / multiplicity (ReadStack.cc:800-845)
MOTIF_WIDTH = 10
MOTIF_MIN_MULT = 10
MOTIF_MIN_Q = 20
# Raise1 window / thresholds (ReadStack.cc:645-712)
RAISE_WINDOW = 11
RAISE_MIN_AGREE = 3
RAISE_CRITICAL_Q = 30
# FlagNoise glue rule (ReadStack.cc:1730-1762)
NOISE_MIN_GLUE = 20
NOISE_MAX_HOMOPOL = 10
# IdentifyShifters (ReadStack.cc:1764-1788)
SHIFT_MIN_RUN = 15
SHIFT_MIN_ERR_DIFF = 5
# Defenestrate stripe grouping (ReadStack.cc:1790-1838)
DEFEN_WIDTH = 10
DEFEN_MIN_MULT = 2
DEFEN_MIN_DIFFS = 3
DEFEN_MIN_COMP = 3
# CorrectAll column vote (ReadStack.cc:1069-1117)
CORRECT_MIN_WIN = 50
CORRECT_WIN_RATIO = 10
CORRECT_MAX_LOSE = 100


def _kmer_index(seq: str, k: int = ANCHOR_K) -> dict:
    idx: dict = {}
    for i in range(len(seq) - k + 1):
        idx.setdefault(seq[i : i + k], i)
    return idx


def _place_read(codes: np.ndarray, idx: dict, k: int = ANCHOR_K) -> Optional[int]:
    """Offset of the read in flank coordinates via the first shared kmer
    (exact; error kmers simply don't match)."""
    s = dna.codes_to_seq(codes)
    for i in range(0, max(1, len(s) - k + 1), 4):
        p = idx.get(s[i : i + k])
        if p is not None:
            return p - i
    return None


def build_stack(
    reads: List[np.ndarray],
    quals: List[np.ndarray],
    flank: str,
    width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack reads (both orientations tried) onto `flank + gap` coords:
    column 0 = flank[0]; returns (R, width) base codes (-1 empty) and
    capped quals (0 where empty)."""
    b, q, _src = build_stack_src(reads, quals, flank, width)
    return b, q


def build_stack_src(
    reads: List[np.ndarray],
    quals: List[np.ndarray],
    flank: str,
    width: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """build_stack + the source read index of every stack row (for
    pair-aware passes: PairWeak1 keys on read-pair ids)."""
    idx = _kmer_index(flank)
    rows_b, rows_q, rows_s = [], [], []
    for ri, (codes, q) in enumerate(zip(reads, quals)):
        for cod, qq in ((codes, q), (dna.revcomp(codes), q[::-1])):
            off = _place_read(cod, idx)
            if off is None:
                continue
            b = np.full(width, -1, np.int8)
            w = np.zeros(width, np.int16)
            lo = max(0, off)
            hi = min(width, off + len(cod))
            if hi > lo:
                b[lo:hi] = cod[lo - off : hi - off]
                w[lo:hi] = np.minimum(qq[lo - off : hi - off], QCAP)
                rows_b.append(b)
                rows_q.append(w)
                rows_s.append(ri)
            break
    if not rows_b:
        return (
            np.zeros((0, width), np.int8),
            np.zeros((0, width), np.int16),
            np.zeros(0, np.int64),
        )
    return np.stack(rows_b), np.stack(rows_q), np.asarray(rows_s)


def _vote_weights(quals: np.ndarray) -> np.ndarray:
    """ReadStack's qual weighting (ReadStack.cc:411-418): Q0 counts 0.1,
    Q1/Q2 count 0.2, else the (capped) qual."""
    w = quals.astype(np.float64)
    w = np.where(quals <= 2, np.minimum(w, 0.2), w)
    w = np.where(quals == 0, 0.1, w)
    return w


def consensus(bases: np.ndarray, quals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Qual-weighted column vote: returns (consensus codes, trusted mask).
    A column is trusted when the winner leads the runner-up by at least
    MIN_WIN_Q (the lopsided-support margin rule), AND the runner-up is not
    itself strong evidence of real divergence — weight > MAX_QCOMP with
    >= 2 confident readers kills the column (ReadStack.cc:422-427)."""
    if bases.shape[0] == 0:
        w = bases.shape[1]
        return np.full(w, -1, np.int8), np.zeros(w, bool)
    onehot = (bases[:, :, None] == np.arange(4)[None, None, :])
    wt = (onehot * _vote_weights(quals)[:, :, None]).sum(axis=0)  # (W, 4)
    q30 = (onehot & (quals[:, :, None] >= QCAP)).sum(axis=0)  # (W, 4)
    order = np.argsort(wt, axis=1)
    win = order[:, -1]
    second = order[:, -2]
    win_w = np.take_along_axis(wt, order[:, -1:], axis=1)[:, 0]
    second_w = np.take_along_axis(wt, order[:, -2:-1], axis=1)[:, 0]
    sec_q30 = np.take_along_axis(q30, second[:, None], axis=1)[:, 0]
    divergent = (second_w > MAX_QCOMP) & (sec_q30 >= MIN_ALT_Q30)
    trusted = (win_w - second_w >= MIN_WIN_Q) & ~divergent
    return win.astype(np.int8), trusted


def filter_founder_diff(
    bases: np.ndarray, quals: np.ndarray, flank: str
) -> np.ndarray:
    """HighQualDiff vs the flank founder (ReadStack.cc:489-496): rows with
    >= FOUNDER_MAX_DIFFS confident disagreements against the known flank
    sequence are misplaced (another repeat copy / haplotype) — returns the
    keep mask."""
    if bases.shape[0] == 0:
        return np.zeros(0, bool)
    nf = min(len(flank), bases.shape[1])
    f = dna.seq_to_codes(flank[:nf])
    cover = bases[:, :nf] >= 0
    diff = cover & (bases[:, :nf] != f[None, :]) & (quals[:, :nf] >= QCAP)
    return diff.sum(axis=1) < FOUNDER_MAX_DIFFS


def _founder_rows(flank: str, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """The flank as a founder row in stack coordinates: (width,) codes with
    -1 past the flank, and capped quals (the flank is assembled sequence —
    trusted at QCAP everywhere it is defined)."""
    fb = np.full(width, -1, np.int8)
    fq = np.zeros(width, np.int16)
    nf = min(len(flank), width)
    fb[:nf] = dna.seq_to_codes(flank[:nf])
    fq[:nf] = QCAP
    return fb, fq


def clean_columns(
    bases: np.ndarray, quals: np.ndarray, founder_b: np.ndarray,
    founder_q: np.ndarray,
) -> np.ndarray:
    """CleanColumns (ReadStack.cc:498-515): in a column where >= 2 bases
    each have >= 3 readers at Q>=20 (a genuinely ambiguous column), a row
    that disagrees at Q>=20 with the founder — when the founder's base
    itself has >= 3 Q20 readers — is suspect.  Returns the suspect mask."""
    R, W = bases.shape
    if R == 0:
        return np.zeros(0, bool)
    covered = bases >= 0
    q20 = covered & (quals >= CLEAN_MIN_Q)
    onehot = q20[:, :, None] & (bases[:, :, None] == np.arange(4)[None, None, :])
    counts = onehot.sum(axis=0)  # (W, 4)
    called = (counts >= CLEAN_MIN_COUNT).sum(axis=1)
    fdef = founder_b >= 0
    fcount = np.where(
        fdef, np.take_along_axis(
            counts, np.maximum(founder_b, 0)[:, None].astype(np.int64), axis=1
        )[:, 0], 0,
    )
    col_active = (
        (called >= 2) & fdef & (founder_q >= CLEAN_MIN_Q)
        & (fcount >= CLEAN_MIN_COUNT)
    )
    diff = covered & (bases != founder_b[None, :]) & (quals >= CLEAN_MIN_Q)
    return (diff & col_active[None, :]).any(axis=1)


def pair_weak(
    bases: np.ndarray, quals: np.ndarray, pids: np.ndarray
) -> np.ndarray:
    """PairWeak1 (ReadStack.cc:727-748): columns where the rows belonging
    to FULL pairs (both mates present in the stack) agree overwhelmingly
    (winner qual-sum >= 100, > 10x the runner-up, runner-up < 100) make
    any Q30 dissenter suspect.  `pids` = pair id per row."""
    R, W = bases.shape
    if R == 0:
        return np.zeros(0, bool)
    pids = np.asarray(pids)
    u, cnt = np.unique(pids, return_counts=True)
    paired = np.isin(pids, u[cnt >= 2])
    covered = bases >= 0
    sel = covered & paired[:, None]
    onehot = sel[:, :, None] * (bases[:, :, None] == np.arange(4)[None, None, :])
    wsum = (onehot * quals[:, :, None]).sum(axis=0)  # (W, 4)
    order = np.argsort(wsum, axis=1)
    win = order[:, -1]
    w0 = np.take_along_axis(wsum, order[:, -1:], axis=1)[:, 0]
    w1 = np.take_along_axis(wsum, order[:, -2:-1], axis=1)[:, 0]
    strong = (
        (w0 >= PAIRWEAK_MIN_WIN) & (w0 > PAIRWEAK_RATIO * w1)
        & (w1 < PAIRWEAK_MIN_WIN)
    )
    dissent = covered & (bases != win[None, :]) & (quals >= RAISE_CRITICAL_Q)
    return (dissent & strong[None, :]).any(axis=1)


def motif_diff(
    bases: np.ndarray, quals: np.ndarray, founder_b: np.ndarray,
    founder_q: np.ndarray,
) -> np.ndarray:
    """MotifDiff (ReadStack.cc:800-845): per non-overlapping 10-column
    stripe, group rows by their fully-defined 10-mer; groups with
    multiplicity >= 10 are "bigs".  If the founder's 10-mer is itself a
    big, rows in OTHER bigs that differ from it at a position where the
    founder qual >= 20 are misplaced repeat copies — delete them."""
    R, W = bases.shape
    to_delete = np.zeros(R, bool)
    if R == 0:
        return to_delete
    wgt = MOTIF_WIDTH
    pw = (4 ** np.arange(wgt - 1, -1, -1)).astype(np.int64)
    for i in range(0, W - wgt + 1, wgt):
        wb = bases[:, i : i + wgt].astype(np.int64)
        full = (wb >= 0).all(axis=1)
        if not full.any():
            continue
        code = (np.maximum(wb, 0) * pw[None, :]).sum(axis=1)
        fb = founder_b[i : i + wgt].astype(np.int64)
        if (fb < 0).any():
            continue
        fcode = int((fb * pw).sum())
        codes_full = code[full]
        u, cnt = np.unique(codes_full, return_counts=True)
        bigs = u[cnt >= MOTIF_MIN_MULT]
        # the founder counts toward its own group's multiplicity (in the
        # reference it is a stack row); its group must itself be a big
        fmult = 1 + int(cnt[np.searchsorted(u, fcode)]) if fcode in u else 1
        if fmult < MOTIF_MIN_MULT:
            continue
        for g in bigs:
            if g == fcode:
                continue
            gb = np.array(
                [(g >> (2 * (wgt - 1 - l))) & 3 for l in range(wgt)],
                np.int64,
            )
            hq = (gb != fb) & (founder_q[i : i + wgt] >= MOTIF_MIN_Q)
            if hq.any():
                to_delete |= full & (code == g)
    return to_delete


def raise1(bases: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Raise1 (ReadStack.cc:645-712), vectorized over (row, window):
    a middle base with 0 < qual < 30 in a fully-defined 11-base window is
    raised to Q30 when >= 3 other rows carry the identical window with a
    Q30 middle (and no zero quals), UNLESS a viable alternate exists
    (>= 3 rows agreeing on everything but the middle, Q30 at a different
    middle base).  Returns the edited quals (input is not mutated).

    Divergence from the reference: one simultaneous pass over all rows and
    windows (the reference mutates left-to-right per read, letting earlier
    raises feed later windows — cascading only strengthens support, so the
    single pass is conservative)."""
    R, W = bases.shape
    quals = quals.copy()
    rw = RAISE_WINDOW
    if R == 0 or W < rw:
        return quals
    mid = rw // 2
    sw = np.lib.stride_tricks.sliding_window_view  # (R, W-rw+1, rw)
    wb = sw(bases, rw, axis=1)
    wq = sw(quals, rw, axis=1)
    C = wb.shape[1]
    full = (wb >= 0).all(axis=2)
    pw = (4 ** np.arange(rw - 1, -1, -1)).astype(np.int64)
    code = (np.maximum(wb, 0).astype(np.int64) * pw[None, None, :]).sum(axis=2)
    colk = np.arange(C, dtype=np.int64)[None, :]
    key = colk * (4**rw) + code  # unique per (window-start, content)
    mid_q = wq[:, :, mid]
    mid_b = wb[:, :, mid]
    no_zero = (wq > 0).all(axis=2)

    # supporters: identical full window, no zero quals, Q30 middle
    sup_rows = full & no_zero & (mid_q >= RAISE_CRITICAL_Q)
    sup_keys = key[sup_rows]
    su, sc = np.unique(sup_keys, return_counts=True)

    def _counts(u, c, k):
        if len(u) == 0:
            return np.zeros(k.shape, np.int64)
        p = np.clip(np.searchsorted(u, k), 0, len(u) - 1)
        return np.where(np.take(u, p) == k, np.take(c, p), 0)

    support = _counts(su, sc, key)

    # alternates: same window except the middle, Q30 at a DIFFERENT middle
    # base; reference checks non-middle quals > 0 and counts per alt base
    code_ex = code - np.maximum(mid_b, 0).astype(np.int64) * pw[mid]
    keyx = (colk * (4**rw) + code_ex) * 4 + np.maximum(mid_b, 0)
    no_zero_ex = (np.delete(wq, mid, axis=2) > 0).all(axis=2)
    alt_rows = full & no_zero_ex & (mid_q >= RAISE_CRITICAL_Q)
    au, ac = np.unique(keyx[alt_rows], return_counts=True)

    alt_max = np.zeros_like(support)
    for b in range(4):
        k = (colk * (4**rw) + code_ex) * 4 + b
        alt_max = np.maximum(
            alt_max, np.where(mid_b == b, 0, _counts(au, ac, k))
        )

    target = (
        full & (mid_q > 0) & (mid_q < RAISE_CRITICAL_Q)
        & (support >= RAISE_MIN_AGREE) & (alt_max < RAISE_MIN_AGREE)
    )
    rr, cc = np.nonzero(target)
    quals[rr, cc + mid] = RAISE_CRITICAL_Q
    return quals


def flag_noise(bases: np.ndarray, founder_b: np.ndarray) -> np.ndarray:
    """FlagNoise (ReadStack.cc:1730-1762): a stacked row must share at
    least one mismatch-free "glue" stretch with the founder of capped
    length >= 20, where any homopolymer (same founder base repeating)
    contributes at most 10 of those columns — otherwise the row is noise.
    Returns the delete mask."""
    R, W = bases.shape
    if R == 0:
        return np.zeros(0, bool)
    fdef = founder_b >= 0
    agree = (bases >= 0) & fdef[None, :] & (bases == founder_b[None, :])
    # homopolymer index: distance since the last column that does NOT
    # extend the current (agreeing) homopolymer stretch
    same_f = np.zeros(W, bool)
    same_f[1:] = fdef[1:] & fdef[:-1] & (founder_b[1:] == founder_b[:-1])
    ext = agree & same_f[None, :]
    ext[:, 0] = False
    idx_col = np.broadcast_to(np.arange(W)[None, :], (R, W))
    last_break = np.maximum.accumulate(np.where(~ext, idx_col, -1), axis=1)
    hp_idx = idx_col - last_break
    weight = agree & (hp_idx < NOISE_MAX_HOMOPOL)
    # capped run length via running sums reset at run starts: prefix-sum of
    # weight minus its value at the current run's start
    csum = np.cumsum(weight.astype(np.int64), axis=1)
    run_start = np.maximum.accumulate(np.where(~agree, idx_col, 0), axis=1)
    base_at = np.take_along_axis(csum, run_start, axis=1)
    # run_start normally points at the last non-agree column (weight 0);
    # when a run begins at column 0 it points INTO the run — re-add its
    # weight so the first column is not dropped
    start_in_run = np.take_along_axis(weight, run_start, axis=1)
    capped = np.where(
        agree, csum - base_at + start_in_run.astype(np.int64), 0
    )
    best = capped.max(axis=1)
    return best < NOISE_MIN_GLUE


def identify_shifters(bases: np.ndarray, founder_b: np.ndarray) -> np.ndarray:
    """IdentifyShifters (ReadStack.cc:1764-1788): when the founder opens a
    homopolymer run >= 15 at column p1, a row whose mismatch count vs the
    founder (scanned from p1 until either sequence becomes undefined) drops
    by >= 5 when the row is shifted one column left or right is an
    indel-shifted read — delete it.  (The reference accumulates the left
    shift into `errsp`; the intended per-direction comparison is
    implemented here.)"""
    R, W = bases.shape
    out = np.zeros(R, bool)
    if R == 0:
        return out
    fdef = founder_b >= 0
    # first founder homopolymer run >= SHIFT_MIN_RUN
    p1 = -1
    i = 0
    while i < W and fdef[i]:
        j = i + 1
        while j < W and fdef[j] and founder_b[j] == founder_b[i]:
            j += 1
        if j - i >= SHIFT_MIN_RUN:
            p1 = i
            break
        i = j
    if p1 < 0:
        return out

    def errs_from(shift: int) -> np.ndarray:
        cols = np.arange(p1, W - max(0, shift))
        rcols = cols + shift
        valid = rcols >= 0
        cols, rcols = cols[valid], rcols[valid]
        fd = fdef[cols]
        rd = bases[:, rcols] >= 0
        both = fd[None, :] & rd
        # prefix until the first undefined of either (reference `break`)
        alive = np.cumprod(both, axis=1).astype(bool)
        mism = alive & (bases[:, rcols] != founder_b[cols][None, :])
        return mism.sum(axis=1)

    errs = errs_from(0)
    errsp = errs_from(1)
    errsm = errs_from(-1)
    return np.maximum(errs - errsp, errs - errsm) >= SHIFT_MIN_ERR_DIFF


def defenestrate(bases: np.ndarray) -> np.ndarray:
    """Defenestrate (ReadStack.cc:1790-1838): per non-overlapping 10-column
    stripe, rows with a fully-defined stripe are grouped by content; the
    founder group is the lexicographically first group with multiplicity
    >= 2 and complexity >= 3 (complexity = 1 + #adjacent transitions).
    Every other group meeting the same multiplicity/complexity bar that
    differs from the founder group at >= 3 positions is thrown out the
    window (a stacked repeat copy)."""
    R, W = bases.shape
    out = np.zeros(R, bool)
    if R == 0:
        return out
    wgt = DEFEN_WIDTH
    for i in range(0, W - wgt + 1, wgt):
        stripe = bases[:, i : i + wgt]
        full = (stripe >= 0).all(axis=1)
        if full.sum() < 2 * DEFEN_MIN_MULT:
            continue
        rows = stripe[full].astype(np.int8)
        uniq, inv, cnt = np.unique(
            rows, axis=0, return_inverse=True, return_counts=True
        )
        comp = 1 + (uniq[:, 1:] != uniq[:, :-1]).sum(axis=1)
        qual_g = (cnt >= DEFEN_MIN_MULT) & (comp >= DEFEN_MIN_COMP)
        if not qual_g.any():
            continue
        founder = int(np.nonzero(qual_g)[0][0])  # lexicographically first
        diffs = (uniq != uniq[founder][None, :]).sum(axis=1)
        kill_g = qual_g & (diffs >= DEFEN_MIN_DIFFS)
        if kill_g.any():
            kill_rows = kill_g[inv]
            idx = np.nonzero(full)[0]
            out[idx[kill_rows]] = True
    return out


def correct_all(
    bases: np.ndarray, quals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """CorrectAll (ReadStack.cc:1055-1117): correct the founder (row 0)
    against the stack.  Per column, qual-sums per base (Q<=2 counts 0.2);
    each competitor's sum is discounted by its single best reader; the
    winner replaces the founder base (qual 0) when it wins by >= 50, by
    >= 10x the best competitor, and the competitor total is <= 100.
    Returns (corrected codes, quals, trim_to) where trim_to is the first
    untrustworthy column (= width when every column verifies)."""
    R, W = bases.shape
    b = bases[0].copy()
    q = quals[0].astype(np.int16).copy()
    if R == 0 or W == 0:
        return b, q, 0
    covered = bases >= 0
    onehot = covered[:, :, None] & (bases[:, :, None] == np.arange(4)[None, None, :])
    wt = np.where(quals <= 2, np.minimum(quals, 0.2), quals.astype(np.float64))
    sums = (onehot * wt[:, :, None]).sum(axis=0)  # (W, 4)
    tops = np.where(onehot, quals[:, :, None], 0).max(axis=0)  # (W, 4)
    order = np.argsort(sums, axis=1)
    win = order[:, -1]
    win_w = np.take_along_axis(sums, order[:, -1:], axis=1)[:, 0]
    # competitors lose their single best reader (ReadStack.cc:1092-1094)
    disc = sums - tops
    disc[np.arange(W), win] = -np.inf
    comp_w = disc.max(axis=1)
    ok = (
        (win_w >= CORRECT_MIN_WIN)
        & (win_w >= CORRECT_WIN_RATIO * np.maximum(comp_w, 0))
        & (comp_w <= CORRECT_MAX_LOSE)
    )
    trim_to = int(np.argmin(ok)) if not ok.all() else W
    change = ok & (b != win.astype(np.int8))
    b = np.where(change, win.astype(np.int8), b)
    q = np.where(change, np.int16(0), q)
    return b, q, trim_to


def edit_stack(
    bases: np.ndarray,
    quals: np.ndarray,
    flank: str,
    pids: Optional[np.ndarray] = None,
    min_survivors: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """The ReadStack editing pipeline ahead of consensus: founder
    HighQualDiff (filter_founder_diff), FlagNoise, IdentifyShifters,
    Defenestrate, CleanColumns, MotifDiff, PairWeak1 row removal, then
    Raise1 qual raising on the survivors.  Row-removal passes are only
    applied while >= min_survivors rows remain (the same survival guard
    the founder filter uses — with flat sim qual profiles a pass can nuke
    the whole stack)."""
    if bases.shape[0] == 0:
        return bases, quals
    fb, fq = _founder_rows(flank, bases.shape[1])
    keep = filter_founder_diff(bases, quals, flank)
    for mask in (
        ~flag_noise(bases, fb),
        ~identify_shifters(bases, fb),
        ~defenestrate(bases),
        ~clean_columns(bases, quals, fb, fq),
        ~motif_diff(bases, quals, fb, fq),
        ~pair_weak(bases, quals, pids) if pids is not None else None,
    ):
        if mask is None:
            continue
        cand = keep & mask
        if cand.sum() >= min_survivors:
            keep = cand
    if keep.sum() >= min_survivors:
        bases, quals = bases[keep], quals[keep]
    q2 = raise1(bases, quals.astype(np.int16))
    return bases, q2


def _extend(reads, quals, flank: str) -> str:
    """Single best consensus extension (first candidate of _extend_multi)."""
    cands = _extend_multi(reads, quals, flank)
    return cands[0] if cands else ""


def _extend_multi(reads, quals, flank: str, read_ids=None) -> List[str]:
    """Branch-aware consensus extensions beyond the flank.

    Per column, the qual-weighted vote runs over the rows consistent with
    the branch so far.  A trusted column extends; a column where BOTH top
    bases have >= MIN_ALT_Q30 confident readers is real divergence (het
    arm in the gap, or two repeat copies stacked together) — the extension
    FORKS, and each branch keeps only the rows that agree with it (plus
    rows not covering the column), which un-poisons every later column for
    that branch.  <= MAX_FORKS forks; candidates ordered
    strongest-branch-first (the Consensuses1 / Stackster multi-closure
    analogue, ReadStack.cc:846, 10X/Stackster.cc)."""
    width = len(flank) + MAX_EXT
    b, q, src = build_stack_src(reads, quals, flank, width)
    if b.shape[0] == 0:
        return []
    # ReadStack editing pipeline: founder HighQualDiff + CleanColumns +
    # MotifDiff + PairWeak1 row removal (each behind the >= 4-survivors
    # guard), then Raise1 qual raising (ReadStack.cc:489-845)
    pids = None if read_ids is None else np.asarray(read_ids)[src] // 2
    b, q = edit_stack(b, q, flank, pids)
    if b.shape[0] == 0:
        return []
    w = _vote_weights(q)
    done: List[Tuple[float, str]] = []
    # (priority, ext-so-far, row mask, column, forks used)
    live = [(0.0, "", np.ones(b.shape[0], bool), len(flank), 0)]
    while live:
        prio, ext, mask, j, forks = live.pop()
        forked = False
        while j < width:
            rows = mask & (b[:, j] >= 0)
            if not rows.any():
                break
            bb = b[rows, j]
            wt = np.bincount(bb, weights=w[rows, j], minlength=4)
            q30 = np.bincount(bb[q[rows, j] >= QCAP], minlength=4)
            order = np.argsort(wt)
            win, second = int(order[-1]), int(order[-2])
            divergent = wt[second] > MAX_QCOMP and q30[second] >= MIN_ALT_Q30
            if wt[win] - wt[second] >= MIN_WIN_Q and not divergent:
                ext += "ACGT"[win]
                j += 1
                continue
            if (
                forks < MAX_FORKS
                and q30[win] >= MIN_ALT_Q30
                and q30[second] >= MIN_ALT_Q30
            ):
                for base in (second, win):
                    bmask = mask & ((b[:, j] < 0) | (b[:, j] == base))
                    live.append(
                        (prio + wt[base], ext + "ACGT"[base], bmask, j + 1,
                         forks + 1)
                    )
                forked = True
            break
        if not forked:
            done.append((prio, ext))
    # strongest-branch-first, dedup, drop empties
    done.sort(key=lambda t: -t[0])
    seen = set()
    out = []
    for _, e in done:
        if e and e not in seen:
            seen.add(e)
            out.append(e)
    return out


def _join_exact(s1: str, s2: str, n_left: int, n_right: int) -> Optional[str]:
    """Longest exact suffix(s1)==prefix(s2) join -> fill, or None."""
    max_o = min(len(s1), len(s2))
    for o in range(max_o, JOIN_OVERLAP - 1, -1):
        if s1[-o:] == s2[:o]:
            joined = s1 + s2[o:]
            if len(joined) < n_left + n_right:
                return None  # negative gap: flanks overlap, not a fill
            return joined[n_left : len(joined) - n_right]
    return None


def close_gap_stack(bg, rs, gp) -> Optional[str]:
    """Two-sided stack consensus closure for one GapPair: extend right from
    e1's end and left from e2's start (each side may produce multiple
    branch candidates at divergent columns), join candidate pairs on an
    exact overlap, strongest-branch pair first.  Returns the FILL between
    e1's end and e2's start (may be empty), or None."""
    reads = [rs.read(r) for r in gp.read_ids]
    quals = [rs.qual(r) for r in gp.read_ids]
    left = bg.edge_seq(gp.e1)[-FLANK_W:]
    right = bg.edge_seq(gp.e2)[:FLANK_W]
    exts_r = _extend_multi(reads, quals, left, gp.read_ids) or [""]
    # right side: work in rc coords so "extension" is rightward again
    rc = lambda s: dna.codes_to_seq(dna.revcomp(dna.seq_to_codes(s)))
    exts_l = [
        rc(e)
        for e in _extend_multi(
            [dna.revcomp(r) for r in reads], [q[::-1] for q in quals],
            rc(right), gp.read_ids,
        )
    ] or [""]
    for er in exts_r:
        for el in exts_l:
            fill = _join_exact(left + er, el + right, len(left), len(right))
            if fill is not None:
                return fill
    return None
