"""Gaprika: barcode-only gap sizing, self-calibrated from the assembly.

The port's own copy of supernova_tpu/asm/gaprika.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference behavior analogue (no code shared): 10X/Gaprika.cc.  The insight
there is that the expected barcode-sharing between two windows separated by
s bases is a function of s set by the sample's own molecule-length
distribution — so instead of modeling molecules, measure the curve on the
assembly itself:

  1. CALIBRATE (Gaprika.cc:85-155): for each candidate separation g, sample
     gap-free anchor points i on long lines; lefts = barcodes with >=
     MIN_POINTS read positions in [i-W, i), rights = same in [i+g, i+g+W);
     record bridge_frac = |lefts ∩ rights| / |lefts ∪ rights|.  Mean over
     samples -> curve frac(g).
  2. ESTIMATE (Gaprika.cc:160-247): at each {-2} barcode-only gap edge,
     compute the same bridge fraction across the gap's flanking windows and
     invert the curve.  Too-weak linking (frac < curve(max)/2) leaves the
     gap unsized — those are misassembly suspects, not sizing targets.

Differences from the reference, on purpose:
  * fine grid + monotone (PAVA) smoothing + linear interpolation of the
    inverse, instead of nearest-of-{0,5k,10k,...} — the reference's 5 kb
    grid cannot land within 1 kb; a calibrated continuous inverse can.
  * adaptive sampling stride — the reference strides WINDOW*50 (built for
    3.2 Gb genomes); we pick the stride to hit a target sample count so
    calibration stays dense on Mb-scale rungs.
  * windows shrink (>= MIN_WINDOW) when a line is too short for the full
    10 kb window, with the same window used for calibration + estimation.

Everything is host-side numpy: lines are 1e3-1e5 objects with sorted
position arrays; the work is searchsorted + small-set unions (the reference
also runs this phase host-side under OpenMP).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

WINDOW = 10_000  # flanking window (Gaprika.cc:28 WINDOW)
MIN_WINDOW = 2_000
GAP_DELTA = 500  # grid step (reference: 5000 — Gaprika.cc:30 GAP_DELTA)
MAX_GAP = 20_000
MIN_GAP = 100  # floor on estimates (reference: 400 — Gaprika.cc:31)
MIN_POINTS = 2  # read positions per barcode per window (Gaprika.cc:32)
TARGET_SAMPLES = 300  # calibration anchors per grid point (adaptive stride)
MIN_SAMPLES = 25  # grid points with fewer samples are dropped


def line_arrays(
    line_positions: Dict[int, Dict[int, list]]
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{line: {bc: [pos]}} -> {line: (pos_sorted, bc_by_pos)} (lbpx form)."""
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for li, by_bc in line_positions.items():
        if not by_bc:
            continue
        bcs = np.concatenate(
            [np.full(len(ps), b, np.int64) for b, ps in by_bc.items()]
        )
        pos = np.concatenate(
            [np.asarray(ps, np.int64) for ps in by_bc.values()]
        )
        o = np.argsort(pos, kind="stable")
        out[li] = (pos[o], bcs[o])
    return out


def _window_bcs(
    pos: np.ndarray, bc: np.ndarray, a: int, b: int, min_points: int
) -> np.ndarray:
    """Distinct barcodes with >= min_points positions in [a, b)."""
    lo, hi = np.searchsorted(pos, [a, b])
    w = bc[lo:hi]
    if len(w) < min_points:
        return np.zeros(0, np.int64)
    u, c = np.unique(w, return_counts=True)
    return u[c >= min_points]


def bridge_frac(
    pos: np.ndarray,
    bc: np.ndarray,
    left: Tuple[int, int],
    right: Tuple[int, int],
    min_points: int = MIN_POINTS,
) -> float | None:
    """|lefts ∩ rights| / |lefts ∪ rights| for two windows, or None when
    both windows are barcode-empty."""
    L = _window_bcs(pos, bc, left[0], left[1], min_points)
    R = _window_bcs(pos, bc, right[0], right[1], min_points)
    union = len(np.union1d(L, R))
    if union == 0:
        return None
    return len(np.intersect1d(L, R)) / union


def _pava_decreasing(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted isotonic regression, DECREASING (pool adjacent violators)."""
    y = np.asarray(y, float).copy()
    w = np.asarray(w, float).copy()
    # fit increasing on the reversed series
    vals: List[float] = []
    wts: List[float] = []
    cnt: List[int] = []
    for yi, wi in zip(y[::-1], w[::-1]):
        vals.append(yi)
        wts.append(wi)
        cnt.append(1)
        while len(vals) > 1 and vals[-1] < vals[-2]:
            v = (vals[-1] * wts[-1] + vals[-2] * wts[-2]) / (wts[-1] + wts[-2])
            ww = wts[-1] + wts[-2]
            cc = cnt[-1] + cnt[-2]
            vals = vals[:-2] + [v]
            wts = wts[:-2] + [ww]
            cnt = cnt[:-2] + [cc]
    out = np.repeat(vals, cnt)[::-1]
    return out


def calibrate(
    arrays: Dict[int, Tuple[np.ndarray, np.ndarray]],
    llens: np.ndarray,
    gap_spans: Dict[int, np.ndarray],
    window: int = WINDOW,
    grid: np.ndarray | None = None,
    min_points: int = MIN_POINTS,
    target_samples: int = TARGET_SAMPLES,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (gaps, fracs): the monotone-decreasing bridge-fraction curve.

    `gap_spans[li]` is an (n, 2) array of [start, end) line-coordinate
    intervals occupied by gap edges — calibration windows containing any
    gap are skipped (Gaprika.cc:104-107 at_gap), so the curve is measured
    on contiguous sequence only.  Empty result -> (len-0, len-0)."""
    if grid is None:
        grid = np.arange(0, MAX_GAP + 1, GAP_DELTA)
    usable = [
        li for li, (p, b) in arrays.items()
        if int(llens[li]) >= 2 * window + int(grid[0]) and len(p)
    ]
    total_len = sum(int(llens[li]) for li in usable)
    if total_len == 0:
        return np.zeros(0, np.int64), np.zeros(0, float)
    gaps_out: List[int] = []
    fracs_out: List[float] = []
    weights: List[int] = []
    for g in grid:
        g = int(g)
        span = 2 * window + g
        # small separations get ~2x the anchors: the inverse is consumed
        # most often near small gaps and the curve is steepest there, so
        # sampling noise at the head costs the most estimate accuracy
        tgt = int(target_samples * (2.0 - g / max(int(grid[-1]), 1)))
        stride = max(window // 2, (total_len - span * len(usable)) // max(tgt, 1))
        samples: List[float] = []
        for li in usable:
            n = int(llens[li])
            if n < span:
                continue
            pos, bc = arrays[li]
            gs = gap_spans.get(li)
            for i in range(window, n - window - g + 1, max(stride, 1)):
                left1, right2 = i - window, i + g + window
                if gs is not None and len(gs):
                    # any gap interval intersecting [left1, right2)?
                    if bool(np.any((gs[:, 0] < right2) & (gs[:, 1] > left1))):
                        continue
                f = bridge_frac(
                    pos, bc, (left1, i), (i + g, right2), min_points
                )
                if f is not None:
                    samples.append(f)
        if len(samples) >= MIN_SAMPLES:
            gaps_out.append(g)
            fracs_out.append(float(np.mean(samples)))
            weights.append(len(samples))
    if not gaps_out:
        return np.zeros(0, np.int64), np.zeros(0, float)
    fr = _pava_decreasing(np.array(fracs_out), np.array(weights, float))
    return np.array(gaps_out, np.int64), fr


def invert_curve(gaps: np.ndarray, fracs: np.ndarray, f: float) -> int | None:
    """Continuous inverse of the decreasing curve at observed fraction f
    (linear interpolation between grid points); None off an empty curve."""
    if len(gaps) == 0:
        return None
    if f >= fracs[0]:
        return int(gaps[0])
    if f <= fracs[-1]:
        return int(gaps[-1])
    # first index where fracs[i] <= f (fracs decreasing)
    i = int(np.searchsorted(-fracs, -f, side="left"))
    g0, g1 = float(gaps[i - 1]), float(gaps[i])
    f0, f1 = float(fracs[i - 1]), float(fracs[i])
    if f0 == f1:
        return int(round((g0 + g1) / 2))
    t = (f0 - f) / (f0 - f1)
    return int(round(g0 + t * (g1 - g0)))


def _skip_window(
    edge: int,
    direction: int,
    w: int,
    spans: np.ndarray | None,
    self_span: Tuple[int, int],
    line_len: int,
    phys: Dict[Tuple[int, int], int],
) -> Tuple[List[Tuple[int, int]], float] | None:
    """Collect clean [a, b) segments totalling up to `w` SEQUENCE bases
    walking from `edge` (a line coordinate) in `direction` (-1 left, +1
    right), skipping over neighbor gap spans.

    Crowded sites (neighbor gaps within the flanking window) defeated the
    symmetric clean-window ladder at the 30 Mb rung (25/47 sized); a
    window that hops the neighbors keeps the full statistic power there.
    Returns (segments, inflation) — inflation is the expected extra
    PHYSICAL separation contributed by the skipped gaps (each neighbor's
    estimated size weighted by the fraction of window positions beyond
    it), to subtract from the inverted estimate — or None when less than
    half the window's sequence is reachable."""
    segs: List[Tuple[int, int]] = []
    inflation = 0.0
    got = 0
    cur = edge
    rel = []  # neighbor spans sorted by distance from the gap
    if spans is not None and len(spans):
        for s, e in spans:
            s, e = int(s), int(e)
            if (s, e) == self_span:
                continue
            if direction < 0 and e <= edge:
                rel.append((edge - e, s, e))
            elif direction > 0 and s >= edge:
                rel.append((s - edge, s, e))
        rel.sort()
    ri = 0
    while got < w:
        if direction < 0:
            nxt_e = rel[ri][2] if ri < len(rel) else 0
            take = min(cur - nxt_e, w - got)
            if take > 0:
                segs.append((cur - take, cur))
                got += take
            if got >= w or ri >= len(rel):
                break
            _dist, s, e = rel[ri]
            inflation += phys.get((s, e), e - s) * (1.0 - got / w)
            cur = s
            ri += 1
        else:
            nxt_s = rel[ri][1] if ri < len(rel) else line_len
            take = min(nxt_s - cur, w - got)
            if take > 0:
                segs.append((cur, cur + take))
                got += take
            if got >= w or ri >= len(rel):
                break
            _dist, s, e = rel[ri]
            inflation += phys.get((s, e), e - s) * (1.0 - got / w)
            cur = e
            ri += 1
    if got < w // 2:
        return None
    return segs, inflation


def _window_bcs_multi(
    pos: np.ndarray, bc: np.ndarray, segs: List[Tuple[int, int]],
    min_points: int,
) -> np.ndarray:
    parts = []
    for a, b in segs:
        lo, hi = np.searchsorted(pos, [a, b])
        if hi > lo:
            parts.append(bc[lo:hi])
    if not parts:
        return np.zeros(0, np.int64)
    w = np.concatenate(parts)
    if len(w) < min_points:
        return np.zeros(0, np.int64)
    u, c = np.unique(w, return_counts=True)
    return u[c >= min_points]


def find_gap_edges(D, lines) -> List[Tuple[int, int, int, int]]:
    """-> [(d, line, start_coord, repr_len)] for canonical (d <= dinv[d])
    {-2} barcode-only gap edges, positioned in line coordinates."""
    from . import gap as agap
    from .molecules import edge_line_starts

    line_of, start_of = edge_line_starts(D, lines)
    out = []
    for d in range(D.n_edges):
        row = D.epaths.row(d)
        if not (len(row) and row[0] == -2):
            continue
        if d > int(D.dinv[d]):
            continue
        li = int(line_of[d])
        if li < 0:
            continue
        out.append((d, li, int(start_of[d]), agap.gap_repr_len(row)))
    return out


def gap_spans_by_line(D, lines) -> Dict[int, np.ndarray]:
    """All gap-edge [start, end) intervals per line (every gap code, both
    orientations — they all break molecule continuity)."""
    from .molecules import edge_line_starts

    line_of, start_of = edge_line_starts(D, lines)
    gm = D.gap_mask()
    spans: Dict[int, List[Tuple[int, int]]] = {}
    for d in np.nonzero(gm)[0]:
        li = int(line_of[d])
        if li < 0:
            continue
        s = int(start_of[d])
        spans.setdefault(li, []).append((s, s + D.edge_len(int(d))))
    return {li: np.asarray(v, np.int64) for li, v in spans.items()}


def set_bc_gap_sizes(D, sizes: Dict[int, int]):
    """Rebuild D.epaths with {-2} rows resized to [-2, size] for the given
    canonical edges AND their involution partners.  Returns the same D
    object (epaths replaced)."""
    from ..core.ragged import Ragged

    if not sizes:
        return D
    full: Dict[int, int] = {}
    for d, s in sizes.items():
        full[int(d)] = int(s)
        full[int(D.dinv[d])] = int(s)
    rows = []
    for d in range(D.n_edges):
        if d in full:
            # third element 1 = CALIBRATED size (vs the crude star-time
            # estimate): downstream fill guards only trust flagged sizes
            rows.append(np.array([-2, full[d], 1], np.int64))
        else:
            rows.append(D.epaths.row(d))
    D.epaths = Ragged.from_rows(rows, dtype=np.int64)
    return D


def gaprika(
    D,
    lines,
    line_positions: Dict[int, Dict[int, list]],
    llens: np.ndarray,
    window: int = WINDOW,
    max_gap: int = MAX_GAP,
    min_gap: int = MIN_GAP,
) -> Tuple[object, int, dict]:
    """Size every {-2} gap edge from the calibrated bridge curve.

    Returns (D, n_sized, info).  Window auto-shrinks toward MIN_WINDOW when
    the line-length distribution can't support 10 kb flanks (short-rung
    regime); gaps whose bridge fraction is weaker than half the curve's
    max-gap value are left at their prior size (misassembly suspects,
    Gaprika.cc:227-229)."""
    arrays = line_arrays(line_positions)
    if not arrays:
        return D, 0, {"reason": "no positions"}
    targets = find_gap_edges(D, lines)
    if not targets:
        return D, 0, {"reason": "no {-2} gap edges"}
    spans = gap_spans_by_line(D, lines)
    # multi-window curves: many gap sites sit too close to line ends or to
    # neighboring gaps for the full window (31/47 at the 30 Mb rung), so
    # calibrate a curve per window in a 2x ladder down to MIN_WINDOW and
    # size each gap with the LARGEST window that fits its site
    grid = np.arange(0, max_gap + 1, GAP_DELTA)
    curves: List[Tuple[int, np.ndarray, np.ndarray]] = []
    w = window
    while w >= MIN_WINDOW:
        n_ok = sum(
            1 for li in arrays if int(llens[li]) >= 2 * w + max_gap
        )
        if n_ok >= 1:
            gaps_w, fracs_w = calibrate(
                arrays, llens, spans, window=w, grid=grid
            )
            if len(gaps_w) >= 3:  # MIN_SAMPLES in calibrate guards density
                curves.append((w, gaps_w, fracs_w))
        if len(curves) >= 3:
            break
        w //= 2
    info = {
        "windows": [c[0] for c in curves],
        "curve": [
            [[int(g), round(float(f), 4)] for g, f in zip(c[1], c[2])]
            for c in curves
        ],
    }
    if not curves:
        return D, 0, {**info, "reason": "curve too sparse"}

    def fits(li, gpos, cur, w):
        left1, right2 = gpos - w, gpos + cur + w
        if left1 < 0 or right2 > int(llens[li]):
            return False
        gs = spans.get(li)
        if gs is not None and len(gs):
            others = (gs[:, 0] < right2) & (gs[:, 1] > left1)
            self_row = (gs[:, 0] == gpos) & (gs[:, 1] == gpos + cur)
            if bool(np.any(others & ~self_row)):
                return False
        return True

    sizes: Dict[int, int] = {}
    weak_edges: List[int] = []
    n_weak = n_offline = n_skipwin = 0
    for d, li, gpos, cur in targets:
        if li not in arrays:
            n_offline += 1
            continue
        pos, bc = arrays[li]
        fitting = [c for c in curves if fits(li, gpos, cur, c[0])]
        if not fitting:
            n_offline += 1
            continue
        # LARGEST fitting window wins (more barcodes -> lower variance;
        # a median across window sizes measured WORSE on the 1 Mb rung:
        # abs-median 1174 -> 1944); smaller windows only when the large
        # one can't produce a value
        est_final = None
        weak = False
        for w, gaps, fracs in fitting:
            f = bridge_frac(
                pos, bc, (gpos - w, gpos), (gpos + cur, gpos + cur + w)
            )
            if f is None:
                continue
            if f < fracs[-1] / 2.0:
                # linking weaker than half the curve's max-gap value:
                # misassembly suspect (Gaprika.cc:225-229); callers may
                # break the join (barcode-set discontinuity score)
                weak = True
                break
            est = invert_curve(gaps, fracs, f)
            if est is not None:
                est_final = est
                break
        if weak:
            n_weak += 1
            weak_edges.append(d)
            continue
        if est_final is None:
            # crowded site: no clean symmetric window at any ladder size.
            # Hop the neighbor gaps with skip-windows at the LARGEST
            # calibrated window and correct the inverted estimate by the
            # skipped gaps' expected physical contribution.  NOT used for
            # weak-join judgments (inflation legitimately depresses the
            # fraction, which would false-positive the weak rule).
            wbig, gaps_b, fracs_b = curves[0]
            self_span = (gpos, gpos + cur)
            Lw = _skip_window(
                gpos, -1, wbig, spans.get(li), self_span, int(llens[li]), {}
            )
            Rw = _skip_window(
                gpos + cur, +1, wbig, spans.get(li), self_span,
                int(llens[li]), {},
            )
            if Lw is not None and Rw is not None:
                Lb = _window_bcs_multi(pos, bc, Lw[0], MIN_POINTS)
                Rb = _window_bcs_multi(pos, bc, Rw[0], MIN_POINTS)
                union = len(np.union1d(Lb, Rb))
                if union:
                    f = len(np.intersect1d(Lb, Rb)) / union
                    if f >= fracs_b[-1] / 2.0:
                        est = invert_curve(gaps_b, fracs_b, f)
                        if est is not None:
                            est_final = est - int(round(Lw[1] + Rw[1]))
                            n_skipwin += 1
        if est_final is None:
            n_offline += 1
            continue
        sizes[d] = max(min_gap, est_final)
    D = set_bc_gap_sizes(D, sizes)
    info.update(
        n_targets=len(targets), n_sized=len(sizes),
        n_weak=n_weak, n_offline=n_offline, n_skipwin=n_skipwin,
        weak_edges=weak_edges,
    )
    return D, len(sizes), info


def join_jaccard_floor(
    line_positions: Dict[int, Dict[int, list]],
    llens: np.ndarray,
    D=None,
    lines=None,
    window: int = None,
    max_gap: int = MAX_GAP,
) -> float | None:
    """Calibrated admission floor for new scaffold joins: the bridge-curve
    value at max_gap separation (a candidate join must look at least as
    linked as a true max_gap gap).  None when the curve can't be built
    (too few long lines) — callers fall back to the raw count veto."""
    from .star import BRIDGE_VIEW

    if window is None:
        window = min(WINDOW, BRIDGE_VIEW)
    arrays = line_arrays(line_positions)
    if not arrays:
        return None
    spans = (
        gap_spans_by_line(D, lines) if D is not None and lines is not None
        else {}
    )
    grid = np.arange(0, max_gap + 1, max(GAP_DELTA * 4, 2_000))
    gaps, fracs = calibrate(arrays, llens, spans, window=window, grid=grid)
    if len(gaps) < 3 or int(gaps[-1]) < max_gap // 2:
        return None
    return float(fracs[-1])
