"""Megabubble phasing: assign bubble arms to haplotypes using barcoded
molecules.

The port's own copy of supernova_tpu/asm/phasing.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of Flipper (10X/Flipper.cc:3-29): per line, find bubbles, infer
barcode molecules, local search maximizing the phasing score
score(x) = sum over molecules |#agree - #disagree| (== goods - bads in the
reference's Max/Min formulation, since goods + bads is the constant number
of nonzero matrix entries).  The full reference move sequence is
implemented (Flipper.cc:389-556): (1) rectify each molecule (flip its
minority columns), (2) pivot at each point (flip the whole prefix),
(3) fix individual columns, (4) reverse-rectify ("yikes" move,
Flipper.cc:500), (5) fix columns again; then ambiguous ("ugly") bubbles
with good/bad ratio < 4 are dropped (Flipper.cc:562), columns fixed once
more, and phase blocks are bounded at weak pivots where the pivot
advantage exceeds MAX_PIVOT_OK = -20 (Flipper.cc:612-652).  The bubble x
molecule support matrix is the BandedMatrix analogue (Flipper.cc:36-75) —
dense vectorized ops, TPU-friendly at scale; numpy here at line sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Bubble:
    element_idx: int  # position within the line's element list
    arms: List[np.ndarray]  # two D-edge paths (arm order = cell path order)


@dataclass
class LinePhasing:
    bubbles: List[Bubble]
    x: np.ndarray  # (B,) +1 / -1 arm orientation, 0 = unphased/dropped
    blocks: List[Tuple[int, int]]  # phase blocks: [start, end) bubble ranges
    score: float


def _arm_counts(
    arm: np.ndarray, edge_bc_counts: Dict[int, Dict[int, int]]
) -> Dict[int, int]:
    """Summed barcode read counts over an arm's constituent D-edges."""
    out: Dict[int, int] = {}
    for d in arm:
        for bc, n in edge_bc_counts.get(int(d), {}).items():
            out[bc] = out.get(bc, 0) + n
    return out


def _support_matrix(bubbles: List[Bubble], edge_bc_counts: Dict[int, Dict[int, int]]):
    """s[b, m] = reads(arm0) - reads(arm1) for molecule (barcode) m."""
    per_arm = [
        (_arm_counts(bub.arms[0], edge_bc_counts), _arm_counts(bub.arms[1], edge_bc_counts))
        for bub in bubbles
    ]
    all_bcs = sorted({bc for a0, a1 in per_arm for bc in {**a0, **a1}})
    bc_idx = {bc: i for i, bc in enumerate(all_bcs)}
    s = np.zeros((len(bubbles), len(all_bcs)), dtype=np.int32)
    for bi, (a0, a1) in enumerate(per_arm):
        for bc, n in a0.items():
            s[bi, bc_idx[bc]] += n
        for bc, n in a1.items():
            s[bi, bc_idx[bc]] -= n
    return s, all_bcs


def _score(x: np.ndarray, sgn: np.ndarray) -> float:
    # per-molecule |sum over bubbles of agreement|
    return float(np.abs((x[:, None] * sgn).sum(axis=0)).sum())


# Flipper.cc:616 — pivot uncertainty threshold: break the phasing wherever
# flipping the whole prefix would cost fewer than 20 units of score.
MAX_PIVOT_OK = -20
# Flipper.cc:562 — a bubble whose supporting molecules disagree with their
# own majority more than 1:4 is "ugly" and dropped from the phasing.
MIN_GOOD_BAD_RATIO = 4.0


def _rectify(A: np.ndarray, x: np.ndarray, c: np.ndarray, reverse: bool) -> None:
    """Molecule rectification (Flipper.cc:389-443; reverse variant :500-550).

    For each molecule m, flip every bubble where it shows its minority sign
    (reverse=True: majority sign), accepting when the global score improves.
    A is the oriented B x M support matrix (mutated in place along with x, c).
    """
    nb, nm = A.shape
    for m in range(nm):
        cm = c[m]
        # tie-handling mirrors the reference: forward takes plus >= minus
        # (Flipper.cc:395), reverse takes plus <= minus (Flipper.cc:504)
        if reverse:
            want = -1 if cm <= 0 else 1
        else:
            want = -1 if cm >= 0 else 1
        mask = A[:, m] == want
        if not mask.any():
            continue
        # flipping rows `mask` changes every molecule's column sum by
        # -2 * (sum of its entries on those rows)
        delta = A[mask].sum(axis=0)
        c_new = c - 2 * delta
        if np.abs(c_new).sum() > np.abs(c).sum():
            A[mask] *= -1
            x[mask] *= -1
            c[:] = c_new


def _pivot_pass(A: np.ndarray, x: np.ndarray, c: np.ndarray) -> None:
    """Prefix pivots (Flipper.cc:447-491): for each boundary i ascending,
    flip bubbles 0..i if that improves the score.  Incremental: `left[m]`
    tracks the prefix column sums."""
    nb = A.shape[0]
    left = np.zeros_like(c)
    base = np.abs(c).sum()
    for i in range(nb - 1):
        left = left + A[i]
        cand = np.abs(c - 2 * left).sum()
        if cand > base:
            A[: i + 1] *= -1
            x[: i + 1] *= -1
            c[:] = c - 2 * left
            left = -left
            base = cand


def _fix_columns(A: np.ndarray, x: np.ndarray, c: np.ndarray,
                 max_iters: int = 50) -> None:
    """FixColumns (Flipper.cc:123-161): flip individual bubbles while any
    single flip improves the score (delta_bad == -delta_good here, so the
    reference's two-part acceptance reduces to score improvement)."""
    nb = A.shape[0]
    for _ in range(max_iters):
        improved = False
        for b in range(nb):
            c_new = c - 2 * A[b]
            if np.abs(c_new).sum() > np.abs(c).sum():
                A[b] *= -1
                x[b] = -x[b]
                c[:] = c_new
                improved = True
        if not improved:
            break


def _split_chimeric(A: np.ndarray) -> np.ndarray:
    """Split same-GEM molecule collisions (not in the reference, which runs
    at >= 100 Mb where they are rare): a positional molecule cluster that
    merged two TRUE molecules from opposite haplotypes votes both ways —
    >= 2 entries of each sign after orientation.  Such a column is two real
    molecules, so split it into its sign-pure halves; leaving it merged
    makes every bubble it touches look ugly (good:bad ~ 1:1) and the ugly
    rule then drops well-supported het sites wholesale.  Hot barcodes
    produce the same artifact on real data at lower rates."""
    plus = (A > 0).sum(axis=0)
    minus = (A < 0).sum(axis=0)
    chim = (plus >= 2) & (minus >= 2)
    if not chim.any():
        return A
    Ac = A[:, chim]
    return np.concatenate(
        [A[:, ~chim], np.where(Ac > 0, Ac, 0), np.where(Ac < 0, Ac, 0)],
        axis=1,
    )


def _drop_ugly(A: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Ugly-bubble removal (Flipper.cc:560-586): per bubble, count molecules
    agreeing/disagreeing with their own majority; drop (zero the row) when
    good/max(1,bad) < MIN_GOOD_BAD_RATIO.  Returns the ugly mask."""
    maj = np.where(c >= 0, 1, -1).astype(A.dtype)
    agree = A * maj[None, :]
    good = (agree > 0).sum(axis=1)
    bad = (agree < 0).sum(axis=1)
    ugly = good / np.maximum(1, bad) < MIN_GOOD_BAD_RATIO
    if ugly.any():
        A[ugly] = 0
        c[:] = A.sum(axis=0)
    return ugly


def _weak_pivots(A: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Weak pivot points (Flipper.cc:612-652): boundary i is uncertain when
    the advantage of pivoting there exceeds MAX_PIVOT_OK; the phasing breaks
    after bubble i.  Vectorized over all boundaries via a prefix cumsum."""
    nb = A.shape[0]
    if nb < 2:
        return np.zeros(0, dtype=bool)
    cum = np.cumsum(A, axis=0)[:-1]  # (nb-1, M) prefix sums through row i
    adv = np.abs(c[None, :] - 2 * cum).sum(axis=1) - np.abs(c).sum()
    return adv > MAX_PIVOT_OK


def phase_line(
    line, edge_bc_counts: Dict[int, Dict[int, int]], max_iters: int = 20, dinv=None
) -> LinePhasing:
    """Phase one line.  edge_bc_counts: D-edge -> {barcode: read count}.
    Cells whose two arms are rc twins are inversion artifacts, not het sites
    (ZapInversionBubbles, 10X/Super.h), and are excluded."""
    bubbles = [
        Bubble(i, [el.paths[0].copy(), el.paths[1].copy()])
        for i, el in enumerate(line.elements)
        if len(el) == 2
        and (
            dinv is None
            or not np.array_equal(
                np.asarray(dinv)[el.paths[0][::-1]], el.paths[1]
            )
        )
    ]
    if not bubbles:
        return LinePhasing([], np.zeros(0, np.int8), [], 0.0)

    s, bcs = _support_matrix(bubbles, edge_bc_counts)
    sgn = np.sign(s).astype(np.int8)
    # molecules informative on >= 2 bubbles drive phasing (Flipper.cc:310)
    informative = (sgn != 0).sum(axis=0) >= 2
    sgn_i = sgn[:, informative]

    nb = len(bubbles)
    x = np.ones(nb, dtype=np.int8)
    # oriented support matrix; mutated in place by the moves (the reference
    # flips Q entries as it flips bubbles, Flipper.cc:442,486,549)
    A = sgn_i.astype(np.int32).copy()
    c = A.sum(axis=0)
    if A.shape[1]:
        # Flipper.cc move sequence: rectify -> pivot -> fix columns (alpha)
        # -> reverse rectify -> fix columns (beta)
        _rectify(A, x, c, reverse=False)
        _pivot_pass(A, x, c)
        _fix_columns(A, x, c, max_iters=max_iters)
        _rectify(A, x, c, reverse=True)
        _fix_columns(A, x, c, max_iters=max_iters)
        # split chimeric (same-GEM collision) columns, then re-polish
        A2 = _split_chimeric(A)
        if A2.shape[1] != A.shape[1]:
            A = A2
            c = A.sum(axis=0)
            _pivot_pass(A, x, c)
            _fix_columns(A, x, c, max_iters=max_iters)

    # drop ugly (ambiguous) bubbles, then fix columns once more (gamma)
    ugly = _drop_ugly(A, c) if A.shape[1] else np.ones(nb, bool)
    if A.shape[1]:
        _fix_columns(A, x, c, max_iters=max_iters)
    x_out = np.where(ugly, 0, x).astype(np.int8)

    # phase blocks bounded by weak (uncertain) pivots (Flipper.cc:612-652);
    # a boundary no molecule bridges has pivot advantage 0 > MAX_PIVOT_OK,
    # so the old no-bridge rule is subsumed.
    blocks: List[Tuple[int, int]] = []
    if nb:
        weak = (
            _weak_pivots(A, c)
            if A.shape[1]
            else np.ones(max(nb - 1, 0), bool)
        )
        start = 0
        for b in range(nb - 1):
            if weak[b]:
                blocks.append((start, b + 1))
                start = b + 1
        blocks.append((start, nb))

    score = float(np.abs(c).sum()) if A.shape[1] else 0.0
    return LinePhasing(bubbles, x_out, blocks, score)


def build_edge_bc_counts(D, dpaths, dlen, read_bc) -> Dict[int, Dict[int, int]]:
    """D-edge -> {barcode: supporting read count}, from the reads' D
    placements (dpaths).  Vectorized: unique (read, D-edge) pairs counted
    per (D-edge, barcode)."""
    r, mp = dpaths.shape
    mapped = np.where(
        np.arange(mp)[None, :] < np.asarray(dlen)[:r, None], dpaths, -1
    )
    read_ids = np.broadcast_to(np.arange(r)[:, None], (r, mp))
    bc = np.asarray(read_bc)[:r]
    keep = (mapped >= 0) & (bc[:, None] > 0)
    dd = mapped[keep]
    rr = read_ids[keep]
    # one support unit per distinct (read, D-edge)
    pair_key = rr.astype(np.int64) * (D.n_edges + 1) + dd
    uniq = np.unique(pair_key)
    ur = uniq // (D.n_edges + 1)
    ud = uniq % (D.n_edges + 1)
    ubc = bc[ur]
    db_key = ud * np.int64(2**32) + ubc
    keys, counts = np.unique(db_key, return_counts=True)
    out: Dict[int, Dict[int, int]] = {}
    for k, c in zip(keys, counts):
        d = int(k // 2**32)
        b = int(k % 2**32)
        out.setdefault(d, {})[b] = int(c)
    return out


def build_edge_molecule_counts(
    D, lines, dpaths, dlen, read_bc, gap: int = 50_000
) -> Dict[int, Dict[tuple, int]]:
    """D-edge -> {molecule: count} with molecules as (bc, line, k) — the
    barcode's reads on a line are clustered into molecules by position gaps
    (Flipper phases MOLECULES, not barcodes; a barcode with two molecules on
    one long line must not fake bridging evidence)."""
    from .molecules import element_offsets

    r, mp = dpaths.shape
    dlen = np.asarray(dlen)[:r]
    bc = np.asarray(read_bc)[:r]

    # per D-edge: line + element start coordinate
    nd = D.n_edges
    line_of = np.full(nd, -1, np.int64)
    pos_of = np.zeros(nd, np.int64)
    for li, ln in enumerate(lines.lines):
        offs = element_offsets(D, ln)
        for j, el in enumerate(ln.elements):
            for d in el.edge_ids():
                line_of[int(d)] = li
                pos_of[int(d)] = offs[j]

    d0 = np.where(dlen > 0, dpaths[:, 0], -1).astype(np.int64)
    ok = (d0 >= 0) & (bc > 0)
    safe = np.clip(d0, 0, nd - 1)
    li = np.where(ok, line_of[safe], -1)
    pos = np.where(ok, pos_of[safe], 0)
    keep = ok & (li >= 0)
    rid = np.nonzero(keep)[0]
    kb, kl, kp = bc[keep], li[keep], pos[keep]
    order = np.lexsort((kp, kl, kb))
    kb, kl, kp, rid = kb[order], kl[order], kp[order], rid[order]
    if len(kb) == 0:
        return {}
    new_grp = np.concatenate(
        [[True], (kb[1:] != kb[:-1]) | (kl[1:] != kl[:-1])]
    )
    far = np.concatenate([[False], (kp[1:] - kp[:-1]) > gap])
    new_mol = new_grp | far
    mol_idx = np.cumsum(new_mol) - 1  # global molecule serial

    # read -> global molecule serial (vectorized join through read ids)
    mol_of = np.full(r, -1, np.int64)
    mol_of[rid] = mol_idx
    mol_bc = np.zeros(int(mol_idx[-1]) + 1, np.int64)
    mol_li = np.zeros(int(mol_idx[-1]) + 1, np.int64)
    mol_bc[mol_idx] = kb
    mol_li[mol_idx] = kl

    rows, cols = np.nonzero(
        (np.arange(mp)[None, :] < dlen[:, None]) & (dpaths >= 0)
    )
    d_all = dpaths[rows, cols].astype(np.int64)
    m_all = mol_of[rows]
    sel = m_all >= 0
    # one support unit per (read, D-edge), counted per (D-edge, molecule)
    rk = rows[sel].astype(np.int64) * np.int64(nd + 1) + d_all[sel]
    _, first = np.unique(rk, return_index=True)
    d_u = d_all[sel][first]
    m_u = m_all[sel][first]
    key2 = d_u * np.int64(mol_bc.shape[0] + 1) + m_u
    uk, uc = np.unique(key2, return_counts=True)
    out: Dict[int, Dict[tuple, int]] = {}
    for k, c in zip(uk.tolist(), uc.tolist()):
        d = k // (mol_bc.shape[0] + 1)
        m = k % (mol_bc.shape[0] + 1)
        out.setdefault(int(d), {})[
            (int(mol_bc[m]), int(mol_li[m]), int(m))
        ] = int(c)
    return out


def phase_block_lengths(D, line, ph: LinePhasing) -> List[int]:
    """Approximate phase-block lengths in bases (distance between the first
    and last bubble of each block along the line)."""
    if not ph.bubbles:
        return []
    elens = {}

    def elen(d):
        if d not in elens:
            elens[d] = D.edge_len(int(d))
        return elens[d]

    # prefix positions of elements along the line (longest path per element)
    from ..core.kmer_codec import K

    pos = [0]
    for el in line.elements:
        pos.append(
            pos[-1]
            + max(
                sum(elen(d) for d in p) - (len(p) - 1) * (K - 1)
                for p in el.paths
            )
        )
    out = []
    for a, b in ph.blocks:
        lo = ph.bubbles[a].element_idx
        hi = ph.bubbles[b - 1].element_idx
        out.append(max(pos[hi + 1] - pos[lo], 1))
    return out
