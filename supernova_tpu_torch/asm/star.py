"""Star: join lines across barcode-only gaps by order-scoring advantage.

The port's own copy of supernova_tpu/asm/star.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogues (all behavior, no code, from 10X/Star.cc + LineOO.cc):
  * ScoreOrder (LineOO.cc:264-317): score an ordering of lines by merging
    their barcode positions into concatenated coordinates; each barcode's
    consecutive positions that jump across a line boundary add
    (position gap)/(barcode mean gap) when >= MIN_ADD=2 — lower is better.
  * Star (Star.cc:20-230): for each long line (MIN_STAR=5000) whose right
    end is a dead end, take its LineProx barcode neighbors (MAX_VIEW=10),
    drop CN-mismatched (MAX_CN_DIFF=0.5) or short (MIN_BAR_TO=2000)
    candidates, keep candidates whose best of the four orientation orders
    puts L1 first with advantage >= MIN_ADVANTAGE (60), cap at
    MAX_RIGHTS=6, pick the winner by order scoring with the same
    advantage gate, and join with a {-2} barcode-only gap.
  * BarcodePos BC_VIEW: only positions within 50 kb of line ends count.
  * LineProx (LineOO.cc): neighbor candidates ranked by shared barcodes.

Host-side; scoring arrays are small (lines x barcode positions).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MIN_STAR = 5000
MIN_BAR_TO = 2000
MAX_VIEW = 10
MAX_RIGHTS = 6
MAX_CN_DIFF = 0.5
BC_VIEW = 50_000
MIN_ADVANTAGE = 60.0
MIN_ADD = 2.0
# Join-point bridge veto: a real L1->R join is made by molecules that
# physically span it, so shared barcodes must appear within BRIDGE_VIEW of
# L1's right END and R's left START.  Repeat-mediated false joins (two loci
# sharing a repeat copy 0.6-6.5 Mb apart — the 10 Mb rung's 10 dis-class
# chimeras) trip LineProx and can win order scoring, but their shared
# barcodes sit at the repeat's interior position, not at the join point on
# both sides.  The 20 kb window matches the KillMisassembledCells flank
# scale (Super.cc:306-330) and the ~20-50 kb molecule length.
BRIDGE_VIEW = 20_000
MIN_BRIDGE = 2


def restrict_positions(
    lbp: Dict[int, List[Tuple[int, int]]], llens: np.ndarray, view: int = BC_VIEW
) -> Dict[int, List[Tuple[int, int]]]:
    """Keep positions within `view` of either line end (BarcodePos BC_VIEW)."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    for li, pairs in lbp.items():
        n = int(llens[li])
        out[li] = [
            (bc, p) for bc, p in pairs if p <= view or n - p <= view
        ]
    return out


def lbp_arrays(
    lbp: Dict[int, List[Tuple[int, int]]]
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Convert barcode-position lists to (bc, pos) array pairs once, so the
    per-candidate score_order calls skip per-call list conversion."""
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for li, pairs in lbp.items():
        if isinstance(pairs, tuple):
            out[li] = pairs
        elif len(pairs):
            a = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
            out[li] = (a[:, 0], a[:, 1])
        else:
            out[li] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return out


def score_order(
    order: Sequence[int],
    lbp,
    llens: np.ndarray,
) -> float:
    """ScoreOrder (LineOO.cc:264-317); lower is better.  Vectorized over
    the concatenated (bc, order-index, coord) records; `lbp` values may be
    [(bc, pos), ...] lists or (bc, pos) array pairs (lbp_arrays)."""
    parts_b, parts_i, parts_p = [], [], []
    pos = 0
    for i, li in enumerate(order):
        v = lbp.get(li)
        if v is not None and len(v):
            if isinstance(v, tuple):
                b, p = v
            else:
                a = np.asarray(v, dtype=np.int64).reshape(-1, 2)
                b, p = a[:, 0], a[:, 1]
            if len(b):
                parts_b.append(b)
                parts_i.append(np.full(len(b), i, np.int64))
                parts_p.append(p + pos)
        pos += int(llens[li])
    if not parts_b:
        return 0.0
    bcs = np.concatenate(parts_b)
    idx = np.concatenate(parts_i)
    ps = np.concatenate(parts_p)
    o = np.lexsort((ps, idx, bcs))
    b, ii, pp = bcs[o], idx[o], ps[o]
    n = len(b)
    if n < 2:
        return 0.0
    starts = np.r_[True, b[1:] != b[:-1]]
    gid = np.cumsum(starts) - 1
    sidx = np.flatnonzero(starts)
    lidx = np.r_[sidx[1:], n] - 1
    span = (pp[lidx] - pp[sidx])[gid]
    cnt = (lidx - sidx)[gid]  # group size - 1
    mean_gap = np.where((span > 0) & (cnt > 0), span / np.maximum(cnt, 1), 1.0)
    inc = np.r_[False, ii[1:] > ii[:-1]] & ~starts
    dpp = np.r_[0, np.diff(pp)]
    plus = np.where(inc, dpp / mean_gap, 0.0)
    return float(plus[plus >= MIN_ADD].sum())


def bridge_support(
    L1: int,
    R: int,
    lbp,
    llens: np.ndarray,
    view: int = BRIDGE_VIEW,
) -> int:
    """# distinct barcodes with a position within `view` of L1's right end
    AND within `view` of R's left start — the molecules that could span the
    join.  `lbp` values may be [(bc, pos), ...] lists or (bc, pos) array
    pairs (lbp_arrays); positions are oriented-line coordinates."""

    def arrays(li):
        v = lbp.get(li)
        if v is None or not len(v):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if isinstance(v, tuple):
            return v
        a = np.asarray(v, dtype=np.int64).reshape(-1, 2)
        return a[:, 0], a[:, 1]

    b1, p1 = arrays(L1)
    b2, p2 = arrays(R)
    if not len(b1) or not len(b2):
        return 0
    near_end = b1[p1 >= int(llens[L1]) - view]
    near_start = b2[p2 <= view]
    return len(np.intersect1d(near_end, near_start))


def bridge_jaccard(
    L1: int,
    R: int,
    lbp,
    llens: np.ndarray,
    view: int = BRIDGE_VIEW,
    min_points: int = 2,
) -> float | None:
    """Coverage-normalized join-point linkage: Jaccard of the barcode sets
    (>= min_points read positions each) in L1's last `view` bases and R's
    first `view` bases — the same statistic Gaprika's calibration curve is
    built from (asm/gaprika.py), so curve(gap) gives its expected value for
    a TRUE join at that gap.  Raw bridge COUNTS are noise-dominated on
    small rungs (every barcode's ~10 molecules tile a 1 Mb genome), but the
    Jaccard stays scale-invariant: same-GEM coincidences inflate numerator
    and denominator together.  None when both windows are empty."""

    def arrays(li):
        v = lbp.get(li)
        if v is None or not len(v):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if isinstance(v, tuple):
            return v
        a = np.asarray(v, dtype=np.int64).reshape(-1, 2)
        return a[:, 0], a[:, 1]

    def filtered(b):
        if len(b) < min_points:
            return np.zeros(0, np.int64)
        u, c = np.unique(b, return_counts=True)
        return u[c >= min_points]

    b1, p1 = arrays(L1)
    b2, p2 = arrays(R)
    L = filtered(b1[p1 >= int(llens[L1]) - view])
    Rb = filtered(b2[p2 <= view])
    union = len(np.union1d(L, Rb))
    if union == 0:
        return None
    return len(np.intersect1d(L, Rb)) / union


def line_prox(
    line_bcs: List[np.ndarray], canon: Sequence[int], max_view: int = MAX_VIEW
) -> Dict[int, List[Tuple[int, int]]]:
    """LineProx analogue: per line, candidate neighbors ranked by shared
    good-barcode count -> {line: [(shared, other), ...]}."""
    from .links import incidence_from_sets, link_triples_np, neighbors_ranked

    with_bc = [i for i in canon if len(line_bcs[i])]
    bcv, item = incidence_from_sets([line_bcs[i] for i in with_bc], with_bc)
    i1, i2, s = link_triples_np(bcv, item, min_shared=1)
    out: Dict[int, List[Tuple[int, int]]] = {i: [] for i in with_bc}
    out.update(neighbors_ranked(i1, i2, s, max_view=2 * max_view))
    return out


def line_coverage(llens: np.ndarray, lbp: Dict[int, List[Tuple[int, int]]]) -> np.ndarray:
    """LineCN-style relative coverage: barcode positions per base,
    normalized so the median long line sits at 1.0."""
    cov = np.zeros(len(llens))
    for li, pairs in lbp.items():
        # pairs may be [(bc, pos), ...] or an (bc_arr, pos_arr) pair
        n = len(pairs[0]) if isinstance(pairs, tuple) else len(pairs)
        if llens[li] > 0:
            cov[li] = n / llens[li]
    longs = cov[(llens >= MIN_BAR_TO) & (cov > 0)]
    med = np.median(longs) if len(longs) else 0.0
    return cov / med if med > 0 else cov


def right_dead_ends(lines, D) -> Dict[int, bool]:
    """line id -> True if the line's right end extends nowhere in D
    (Star's dead-end condition, Star.cc:104-108)."""
    indeg = np.bincount(D.to_v, minlength=D.n_vertices)
    outdeg = np.bincount(D.from_v, minlength=D.n_vertices)
    out: Dict[int, bool] = {}
    for li, ln in enumerate(lines.lines):
        last = int(ln.elements[-1].paths[0][-1])
        v = int(D.to_v[last])
        out[li] = outdeg[v] == 0 and indeg[v] == 1
    return out


def build_scaffolds(
    n_lines: int,
    linv: np.ndarray,
    joins: List[Tuple[int, int, float]],
    llens: np.ndarray,
    min_emit_len: int = 1,
):
    """Chain star joins into scaffolds (involution-consistent, best
    advantage wins conflicts, cycles refused).  -> List[Scaffold] over
    oriented line ids, one per rc pair."""
    from .scaffold import DEFAULT_GAP_N, Scaffold

    succ: Dict[int, int] = {}
    pred: Dict[int, int] = {}

    def reaches(a, b):
        seen = set()
        while a in succ and a not in seen:
            seen.add(a)
            a = succ[a]
            if a == b:
                return True
        return False

    for L1, R, ad in sorted(joins, key=lambda t: (-t[2], t[0], t[1])):
        rL1, rR = int(linv[L1]), int(linv[R])
        if L1 in succ or R in pred or rR in succ or rL1 in pred:
            continue
        if L1 == R or reaches(R, L1):
            continue
        succ[L1] = R
        pred[R] = L1
        if (rR, rL1) != (L1, R):
            succ[rR] = rL1
            pred[rL1] = rR

    emitted = set()
    scaffolds = []
    heads = [li for li in range(n_lines) if li in succ and li not in pred]
    singles = [
        li for li in range(n_lines) if li not in succ and li not in pred
    ]
    for h in heads:
        chain = [h]
        x = h
        while x in succ:
            x = succ[x]
            chain.append(x)
        mirror = tuple(int(linv[c]) for c in reversed(chain))
        if mirror in emitted:
            continue
        emitted.add(tuple(chain))
        scaffolds.append(Scaffold(chain, [DEFAULT_GAP_N] * (len(chain) - 1)))
    for li in singles:
        if li <= int(linv[li]) and llens[li] >= min_emit_len:
            scaffolds.append(Scaffold([li], []))
    return scaffolds


def filter_joins(
    joins: List[Tuple[int, int, float]], linv: np.ndarray
) -> List[Tuple[int, int, float]]:
    """Resolve join conflicts: best advantage wins, involution-consistent,
    one successor/predecessor per line end, cycles refused (the chaining
    rules of Star.cc applied to a join set)."""
    succ: Dict[int, int] = {}
    pred: Dict[int, int] = {}

    def reaches(a, b):
        seen = set()
        while a in succ and a not in seen:
            seen.add(a)
            a = succ[a]
            if a == b:
                return True
        return False

    out = []
    for L1, R, ad in sorted(joins, key=lambda t: (-t[2], t[0], t[1])):
        rL1, rR = int(linv[L1]), int(linv[R])
        if L1 in succ or R in pred or rR in succ or rL1 in pred:
            continue
        if L1 == R or reaches(R, L1):
            continue
        succ[L1] = R
        pred[R] = L1
        if (rR, rL1) != (L1, R):
            succ[rR] = rL1
            pred[rL1] = rR
        out.append((L1, R, ad))
    return out


def line_end_edges(lines, li: int) -> Tuple[int, int]:
    """(first D-edge, last D-edge) of a line's walked path."""
    ln = lines.lines[li]
    return (
        int(ln.elements[0].paths[0][0]),
        int(ln.elements[-1].paths[0][-1]),
    )


def insert_star_gaps(
    D,
    lines,
    joins: List[Tuple[int, int, float]],
    gap_sizes: Dict[Tuple[int, int], int],
):
    """Insert a {-2, size} barcode-only gap edge (+ rc partner) per accepted
    join L1 -> R, the reference's D update in Star (10X/Star.cc:8-27 +
    Gap.h:26).  Returns the new SuperGraph."""
    from . import gap as agap
    from .supergraph import append_gap_edges

    linv = lines.linv
    items = []
    for L1, R, _ad in joins:
        _, lastA = line_end_edges(lines, L1)
        firstB, _ = line_end_edges(lines, R)
        v, w = int(D.to_v[lastA]), int(D.from_v[firstB])
        _, lastRB = line_end_edges(lines, int(linv[R]))
        firstRA, _ = line_end_edges(lines, int(linv[L1]))
        vr, wr = int(D.to_v[lastRB]), int(D.from_v[firstRA])
        size = gap_sizes.get((L1, R), 100)
        items.append((v, w, agap.bc_gap(max(1, int(size))), vr, wr))
    return append_gap_edges(D, items)


def star_scaffold(
    lines,
    D,
    llens: np.ndarray,
    line_bcs: List[np.ndarray],
    line_positions: Dict[int, Dict[int, list]],
    min_advantage: float = MIN_ADVANTAGE,
):
    """Full Star scaffolding: neighbor candidates -> order-scored joins ->
    chains (the reference iterates passes over a D updated with {-2} gap
    edges; here chaining subsumes one round — multi-pass lands with the
    gap-edge representation)."""
    n = lines.n_lines
    linv = lines.linv
    lbp_all = {
        li: [(bc, p) for bc, ps in line_positions.get(li, {}).items() for p in ps]
        for li in range(n)
    }
    lbp = lbp_arrays(restrict_positions(lbp_all, llens))
    canon = list(range(n))
    lhood = line_prox(line_bcs, canon)
    rdead = right_dead_ends(lines, D)
    joins = star_joins(canon, llens, linv, lbp, lhood, rdead,
                       min_advantage=min_advantage)
    return build_scaffolds(n, linv, joins, llens)


def star_joins(
    canon: Sequence[int],
    llens: np.ndarray,
    linv: np.ndarray,
    lbp: Dict[int, List[Tuple[int, int]]],
    lhood: Dict[int, List[Tuple[int, int]]],
    right_dead: Dict[int, bool],
    min_star: int | None = None,       # None -> MIN_STAR at call time
    min_advantage: float | None = None,  # None -> MIN_ADVANTAGE (addin-able)
    min_bridge: int | None = None,     # None -> MIN_BRIDGE (addin-able)
    bridge_view: int | None = None,    # None -> BRIDGE_VIEW (addin-able)
    jaccard_floor: float | None = None,  # calibrated curve floor (run.py)
    jaccard_view: int | None = None,   # None -> bridge_view; MUST match the
    # window join_jaccard_floor calibrated with, or the veto measures a
    # systematically different statistic than the floor predicts
) -> List[Tuple[int, int, float]]:
    """One star pass -> [(L1, R, advantage)] right-joins.  `right_dead[li]`
    marks lines whose right end extends nowhere in D (oriented line ids).
    Winners must additionally pass the join-point bridge veto
    (bridge_support >= min_bridge within bridge_view of the join)."""
    if min_star is None:
        min_star = MIN_STAR  # read at call time: --addin overridable
    if min_advantage is None:
        min_advantage = MIN_ADVANTAGE
    if min_bridge is None:
        min_bridge = MIN_BRIDGE
    if bridge_view is None:
        bridge_view = BRIDGE_VIEW
    cov = line_coverage(llens, lbp)
    joins: List[Tuple[int, int, float]] = []
    order_ids = sorted(
        (li for li in canon if llens[li] >= min_star and right_dead.get(li, False)),
        key=lambda li: -int(llens[li]),
    )
    for L1 in order_ids:
        rights: List[Tuple[int, float]] = []
        for s, L2 in lhood.get(L1, ())[:MAX_VIEW]:
            if L2 == L1 or L2 == int(linv[L1]):
                continue
            if llens[L2] < MIN_BAR_TO:
                continue
            if cov[L1] > 0 and cov[L2] > 0 and abs(cov[L1] - cov[L2]) > MAX_CN_DIFF:
                continue
            rl2 = int(linv[L2])
            orders = [
                (score_order([L2, L1], lbp, llens), 0, L2),
                (score_order([rl2, L1], lbp, llens), 1, rl2),
                (score_order([L1, L2], lbp, llens), 2, L2),
                (score_order([L1, rl2], lbp, llens), 3, rl2),
            ]
            orders.sort()
            ad = orders[1][0] - orders[0][0]
            if ad < min_advantage:
                continue
            if orders[0][1] <= 1:  # winner puts L2 before L1
                continue
            rights.append((orders[0][2], ad))
        if not rights:
            continue
        # L2 and rc(L2) both resolve to the same oriented right neighbor;
        # dedupe (keep best advantage) or the tie-break sees a 0-advantage
        # duplicate pair and rejects the join
        best_by_r: Dict[int, float] = {}
        for rr, a in rights:
            if rr not in best_by_r or a > best_by_r[rr]:
                best_by_r[rr] = a
        rights = sorted(best_by_r.items(), key=lambda t: -int(llens[t[0]]))
        rights = rights[:MAX_RIGHTS]
        if len(rights) == 1:
            R, ad = rights[0]
        else:
            # leftmost right: the candidate scoring best directly after L1
            scored = sorted(
                (score_order([L1, r], lbp, llens), r, a) for r, a in rights
            )
            ad = scored[1][0] - scored[0][0] if len(scored) > 1 else scored[0][2]
            if ad < min_advantage:
                continue
            R = scored[0][1]
        if bridge_support(L1, R, lbp, llens, view=bridge_view) < min_bridge:
            continue
        if jaccard_floor is not None:
            bj = bridge_jaccard(
                L1, R, lbp, llens,
                view=bridge_view if jaccard_view is None else jaccard_view,
            )
            if bj is None or bj < jaccard_floor:
                continue
        joins.append((L1, R, float(ad)))
    return joins
