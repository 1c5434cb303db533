"""Interior barcode-discontinuity breaking.

The port's own copy of supernova_tpu/asm/fixint.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The junction-based misassembly killers (asm/misassembly.py — analogues of
KillMisassembledCells/Alt, Super.cc:306-470,802-901) judge CELLS: bubble /
gap / repeat elements between straights.  But a repeat-mediated false join
made by closure gluing (NucleateGraph overlap merge) is sequence-continuous
INSIDE one D-edge — there is no cell to judge, and all 13 surviving
dis-class breaks of the 30 Mb rung were of this class (diagnose:
supergraph-level, 1-24 Mb separations).

This pass scans line interiors with the calibrated bridge-fraction
statistic (asm/gaprika.py): at anchor x, the barcode Jaccard of windows
[x-W, x) and [x, x+W) should look like separation~0 on the dataset's own
curve; a deep dip with adequate coverage marks a join no molecule spans.
The break is applied by SPLITTING the containing D-edge at the base-edge
boundary nearest the dip (involution-consistent; both sides keep their
sequence, the false adjacency is removed).

Deviation from the reference, on purpose: the reference relies on the
window killers plus manual curation at this failure class; the calibrated
interior scan is scale-invariant and catches the in-edge case.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.kmer_codec import K
from . import gaprika as agk

WINDOW = 10_000
# stride must be << window: an anchor d bases off the junction mixes d
# bases of cross-material into one window, lifting the Jaccard by ~d/w —
# at stride w/2 the best anchor can sit w/4 off and the dip dilutes above
# the floor (observed at the 10 Mb rung: 2.7/6.3 Mb joins, 0 dips)
STRIDE = 2_500
MIN_POINTS = 2
MIN_WINDOW_POS = 12  # positions per window for a judgment (coverage gate)
MIN_WINDOW_BCS = 4  # distinct (>=2-point) barcodes per window
EDGE_MARGIN = 2_000  # do not split within this of a line end


def find_interior_breaks(
    D,
    lines,
    line_positions: Dict[int, Dict[int, list]],
    llens: np.ndarray,
    window: int = WINDOW,
    stride: int = STRIDE,
) -> Tuple[List[Tuple[int, int]], List[int], List[int], dict]:
    """-> (splits, gap_dels, detaches, info).

    Three surgeries, all driven by the same calibrated statistic:
      * splits [(d, j)]: dip inside a multi-base-edge D-edge — split it;
      * gap_dels [d]: a gap edge of ANY code whose across-the-gap bridge
        fraction fails the weak floor — delete it (generalizes the
        weak-{-2} breaker to {-1}/{-4} junctions, which the 10 Mb rung's
        escapee joins ran through);
      * detaches [d]: dip at the head of a single-base-edge D-edge —
        disconnect its head vertex (detach_edge_head).
    A dip must score below HALF the curve's max-gap value with both
    windows passing the coverage gates."""
    arrays = agk.line_arrays(line_positions)
    if not arrays:
        return [], [], [], {"reason": "no positions"}
    spans = agk.gap_spans_by_line(D, lines)
    grid = np.arange(0, agk.MAX_GAP + 1, 2_000)
    gaps, fracs = agk.calibrate(arrays, llens, spans, window=window, grid=grid)
    if len(gaps) < 3:
        return [], [], [], {"reason": "curve too sparse"}
    weak_floor = float(fracs[-1]) / 2.0

    from . import gap as agap
    from .molecules import edge_line_starts

    line_of, start_of = edge_line_starts(D, lines)
    gm = D.gap_mask()
    # per line: sorted edge intervals (gap edges carried with their code)
    by_line: Dict[int, List[Tuple[int, int, int, bool]]] = {}
    for d in range(D.n_edges):
        li = int(line_of[d])
        if li < 0:
            continue
        s = int(start_of[d])
        by_line.setdefault(li, []).append(
            (s, s + D.edge_len(d), d, bool(gm[d]))
        )
    for li in by_line:
        by_line[li].sort()

    blens = D.bg.edges.lengths()
    splits: Dict[int, int] = {}
    gap_dels: set = set()
    detaches: set = set()
    n_dips = n_gap_judged = 0

    def coverage_ok(pos, bc, a, b):
        n = int(np.searchsorted(pos, b) - np.searchsorted(pos, a))
        W = agk._window_bcs(pos, bc, a, b, MIN_POINTS)
        return (n >= MIN_WINDOW_POS and len(W) >= MIN_WINDOW_BCS), W

    # --- pass 1: judge EVERY gap edge across its own span (any code) ----
    for li, (pos, bc) in arrays.items():
        L = int(llens[li])
        for s, e, d, is_gap in by_line.get(li, ()):
            if not is_gap:
                continue
            row = D.epaths.row(d)
            if agap.is_bc_gap(row):
                continue  # {-2}: the gaprika weak breaker owns these
            if s - window < 0 or e + window > L:
                continue
            okL, Lw = coverage_ok(pos, bc, s - window, s)
            okR, Rw = coverage_ok(pos, bc, e, e + window)
            if not (okL and okR):
                continue
            n_gap_judged += 1
            union = len(np.union1d(Lw, Rw))
            f = len(np.intersect1d(Lw, Rw)) / union if union else None
            if f is not None and f < weak_floor:
                dc = min(int(d), int(D.dinv[d]))
                gap_dels.add(dc)

    # --- pass 2: in-sequence dips -> edge split or head detach ----------
    for li, (pos, bc) in arrays.items():
        L = int(llens[li])
        if L < 2 * window + 2 * EDGE_MARGIN or li not in by_line:
            continue
        gs = spans.get(li)
        dips: List[int] = []
        for x in range(window + EDGE_MARGIN, L - window - EDGE_MARGIN, stride):
            if gs is not None and len(gs):
                if bool(np.any((gs[:, 0] < x + window) & (gs[:, 1] > x - window))):
                    continue
            okL, Lw = coverage_ok(pos, bc, x - window, x)
            okR, Rw = coverage_ok(pos, bc, x, x + window)
            if not (okL and okR):
                continue
            union = len(np.union1d(Lw, Rw))
            f = len(np.intersect1d(Lw, Rw)) / union
            if f < weak_floor:
                dips.append(x)
        if not dips:
            continue
        # cluster consecutive dip anchors, take each cluster's center
        dips_a = np.asarray(dips)
        cluster_starts = np.r_[True, np.diff(dips_a) > 2 * stride]
        cid = np.cumsum(cluster_starts) - 1
        for c in range(int(cid[-1]) + 1):
            xs = dips_a[cid == c]
            center = int(xs.mean())
            n_dips += 1
            ivs = by_line[li]
            hit = None
            for s, e, d, is_gap in ivs:
                if s <= center < e and not is_gap:
                    hit = (s, e, d)
                    break
            if hit is None:
                continue
            s, e, d = hit
            rd = int(D.dinv[d])
            if d == rd:
                continue
            dc = min(d, rd)
            p = np.asarray(D.epaths.row(d), np.int64)
            if len(p) < 2:
                # no interior boundary: break at the end vertex nearer the
                # dip (canonical form: head flag flips through dinv)
                head = (center - s) > (e - center)
                detaches.add((dc, head if d == dc else not head))
                continue
            # base-edge boundaries inside d (line coords): prefix sums of
            # (len - (K-1)) steps after the first edge
            steps = blens[p].astype(np.int64) - (K - 1)
            bounds = s + np.cumsum(steps[:-1])  # boundary before p[j]
            j = int(np.argmin(np.abs(bounds - center))) + 1
            if dc == d:
                splits[dc] = j
            else:
                splits[dc] = len(p) - j  # mirror index on the rc row
    info = {
        "curve_points": int(len(gaps)), "weak_floor": round(weak_floor, 4),
        "n_dips": n_dips, "n_gap_judged": n_gap_judged,
        "n_splits": len(splits), "n_gap_dels": len(gap_dels),
        "n_detaches": len(detaches),
    }
    return sorted(splits.items()), sorted(gap_dels), sorted(detaches), info


def detach_edges(D, items: List[Tuple[int, bool]]):
    """Disconnect edge ends: (d, head=True) gives d's to-vertex (and the
    involution partner's from-vertex) fresh private vertices — the minimal
    break when a dip sits in a single-base-edge D-edge with no interior
    boundary to split at.  Returns a new SuperGraph sharing epaths."""
    from .supergraph import SuperGraph

    from_v = np.asarray(D.from_v, np.int64).copy()
    to_v = np.asarray(D.to_v, np.int64).copy()
    nv = int(D.n_vertices)
    for d, head in items:
        rd = int(D.dinv[d])
        if head:
            to_v[d] = nv
            from_v[rd] = nv + 1
        else:
            from_v[d] = nv
            to_v[rd] = nv + 1
        nv += 2
    return SuperGraph(
        epaths=D.epaths, dinv=D.dinv,
        from_v=from_v.astype(np.int32), to_v=to_v.astype(np.int32),
        n_vertices=nv, bg=D.bg,
    )


def split_edges(D, splits: List[Tuple[int, int]]):
    """Split each canonical non-gap D-edge d at epath index j (1 <= j <
    len): d keeps p[:j] ending at a fresh vertex; a new edge carries p[j:]
    from another fresh vertex (disconnected — the break), with the
    involution partner split at the mirrored index.  Returns a new
    SuperGraph."""
    from ..core.ragged import Ragged
    from .supergraph import SuperGraph

    rows = [np.asarray(D.epaths.row(i), np.int64) for i in range(D.n_edges)]
    from_v = list(np.asarray(D.from_v, np.int64))
    to_v = list(np.asarray(D.to_v, np.int64))
    dinv = list(np.asarray(D.dinv, np.int64))
    nv = int(D.n_vertices)
    for d, j in splits:
        rd = int(dinv[d])
        p = rows[d]
        q = rows[rd]
        assert 1 <= j < len(p) and len(q) == len(p) and d != rd
        jq = len(p) - j
        # d := p[:j] -> new vertex a; d2 := p[j:] from new vertex b
        d2 = len(rows)
        rows.append(p[j:])
        rows[d] = p[:j]
        a, b = nv, nv + 1
        from_v.append(b)
        to_v.append(to_v[d])
        to_v[d] = a
        # rd := q[:jq] -> new vertex c; rd2 := q[jq:] from new vertex e
        rd2 = len(rows)
        rows.append(q[jq:])
        rows[rd] = q[:jq]
        c, e = nv + 2, nv + 3
        from_v.append(e)
        to_v.append(to_v[rd])
        to_v[rd] = c
        nv += 4
        # involution: rc(p[:j]) = q[jq:], rc(p[j:]) = q[:jq]
        dinv[d] = rd2
        dinv.append(rd)  # dinv[d2] = rd
        dinv.append(d)  # dinv[rd2] = d
        dinv[rd] = d2
        # fix ordering: dinv[d2] must be rd and dinv[rd2] must be d, but the
        # two appends above landed in order d2, rd2 — verify by construction
    return SuperGraph(
        epaths=Ragged.from_rows(rows, dtype=np.int64),
        dinv=np.asarray(dinv, np.int64),
        from_v=np.asarray(from_v, np.int32),
        to_v=np.asarray(to_v, np.int32),
        n_vertices=nv,
        bg=D.bg,
    )
