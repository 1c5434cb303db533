"""Misassembly detection: barcode-coverage dips along lines.

The port's own copy of supernova_tpu/asm/misassembly.py, kept equal to it by
tests/test_torch_hostcopies.py, apart from the positional rule's loops:
find_weak_junctions_positional reads each junction's two windows off the
line's positions sorted once (binary searches) instead of scanning every
position of the line at every junction, and break_lines groups the
positions by line once instead of once a line.  Both were quadratic in a
line's length, which made the break take most of the supergraph stage on a
10 Mb genome; tests/test_torch_supergraph.py holds them to the reference's
junctions.  kill_misassembled_cells likewise reads each cell's two windows
off the line's sorted positions by binary search instead of masking every
position of the line at every cell (171 s of the scaffold stage on a 10 Mb
genome); tests/test_torch_scaffold_star.py holds it to the reference's
deletions.  The port imports nothing of the JAX package.

Analogue of KillMisassembledCells (10X/Super.h:25-31, CP.cc:942-1106):
a true join is supported by molecules spanning it, so the number of
barcodes covering both sides of every line junction should not dip to
(near) zero.  Junctions whose spanning-barcode support falls below
`min_span` relative to their flanks are misassembly candidates and the
line is broken there.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np

MIN_SPAN_BC = 2
BC_FLANK = 20_000  # CP.cc:290 flank window
BC_IGNORE = 2_000  # CP.cc:291 dead zone next to the junction
BC_REQUIRE = 5_000  # junction must be this far from both line ends
BC_MIN = 10  # expected bridging barcodes at full window density
BC_MAX_CELL = 1_000  # only judge small cells (Super.cc:319-320)

# the reference's escalation: two passes at the base tier, then a wider
# dead zone, then a long-range pass (CP.cc:942-945,1053-1056,1085-1106)
ESCALATION_TIERS = (
    (5_000, 20_000, 2_000),
    (5_000, 20_000, 5_000),
    (25_000, 40_000, 20_000),
)


def element_barcodes(D, line, sup_bcs: List[np.ndarray]) -> List[Set[int]]:
    """Barcode set per line element (union over parallel arms)."""
    out = []
    for el in line.elements:
        s: Set[int] = set()
        for d in el.edge_ids():
            s |= set(sup_bcs[int(d)].tolist())
        out.append(s)
    return out


def find_weak_junctions(
    D, line, sup_bcs: List[np.ndarray], min_span: int = MIN_SPAN_BC
) -> List[int]:
    """-> element indices j where the junction between element j-1 and j has
    fewer than min_span spanning barcodes (while both flanks have some)."""
    ebcs = element_barcodes(D, line, sup_bcs)
    weak = []
    for j in range(1, len(ebcs)):
        left, right = ebcs[j - 1], ebcs[j]
        if not left or not right:
            continue
        span = len(left & right)
        if span < min_span:
            weak.append(j)
    return weak


def find_weak_junctions_positional(
    D,
    line,
    line_pos: dict,
    min_span: int = MIN_SPAN_BC,
    flank: int = BC_FLANK,
    ignore: int = BC_IGNORE,
) -> List[int]:
    """Positional KillMisassembledCells rule (Super.cc:306-330, CP.cc
    BC_REQUIRE/FLANK/IGNORE): at each junction, barcodes with positions in
    the left window [jc-flank, jc-ignore] and right window
    [jc+ignore, jc+flank] must intersect in >= min_span barcodes (molecule
    ends make positions inside the dead zone uninformative; a position in
    both windows counts for the left one).  `line_pos` is
    {barcode: [positions]} in line coordinates.  -> weak element indices."""
    from .molecules import element_offsets

    offs = element_offsets(D, line)
    total = offs[-1]
    pos = np.concatenate([np.asarray(ps) for ps in line_pos.values()] or [np.zeros(0)])
    bcs = np.repeat(np.fromiter(line_pos.keys(), np.int64, len(line_pos)),
                    [len(ps) for ps in line_pos.values()])
    order = np.argsort(pos, kind="stable")
    pos, bcs = pos[order], bcs[order]
    weak: List[int] = []
    for j in range(1, len(line.elements)):
        jc = offs[j]
        if jc < ignore or total - jc < ignore:
            continue  # too close to the line end to judge
        lo_l, hi_l = jc - flank, jc - ignore
        lo_r, hi_r = jc + ignore, jc + flank
        a, b = np.searchsorted(pos, lo_l, "left"), np.searchsorted(pos, hi_l, "right")
        c = max(np.searchsorted(pos, lo_r, "left"), b)
        d = np.searchsorted(pos, hi_r, "right")
        if a >= b or c >= d:
            continue
        left, right = np.unique(bcs[a:b]), np.unique(bcs[c:d])
        if len(np.intersect1d(left, right, assume_unique=True)) < min_span:
            weak.append(j)
    return weak


def kill_misassembled_cells(
    D,
    lines,
    line_positions: dict,
    llens: np.ndarray | None = None,
    bc_require: int = BC_REQUIRE,
    bc_flank: int = BC_FLANK,
    bc_ignore: int = BC_IGNORE,
    lw_mol_len: float | None = None,
    judge_repeats: bool = True,
) -> List[int]:
    """KillMisassembledCells proper (Super.cc:306-470): judge each cell /
    gap junction far enough from its line's ends by the number of barcodes
    bridging the [mid-flank, mid-ignore] x [mid+ignore, mid+flank] windows
    against an expectation scaled by the genome-wide position density
    (expect = min(1, n/winpos) * BC_MIN); weak cells' D-edges are returned
    for deletion.  The dead zone shrinks to lw_mol_len/4 when the measured
    molecule length doesn't support it (Super.cc:357).
    line_positions: {line: {bc: [positions]}}.

    judge_repeats additionally treats short STRAIGHT elements made of
    repeat D-edges (any constituent base edge with D-multiplicity >= 2)
    as junctions: a line crossing an unresolved repeat copy without
    spanning molecules is a misjoin — break it there."""
    from .molecules import element_offsets

    if llens is None:
        llens = lines.lengths(D)
    if lw_mol_len:
        bc_ignore = min(bc_ignore, int(lw_mol_len) // 4)

    rep_edge = None
    if judge_repeats and getattr(D, "epaths", None) is not None:
        from .local import compute_mult

        mult = compute_mult(D)
        rep_edge = np.zeros(D.n_edges, bool)
        gm = D.gap_mask()
        for d in range(D.n_edges):
            if gm[d]:
                continue
            p = np.asarray(D.epaths.row(d), np.int64)
            if len(p) and (mult[p] >= 2).any():
                rep_edge[d] = True

    # genome-wide positions-per-window expectation (Super.cc:366-375)
    total_bases = 0
    total_pos = 0
    for li in range(lines.n_lines):
        if llens[li] < bc_flank:
            continue
        total_bases += int(llens[li])
        total_pos += sum(
            len(ps) for ps in line_positions.get(li, {}).values()
        )
    if total_bases == 0 or total_pos == 0:
        return []
    winpos = (bc_flank - bc_ignore) * total_pos / total_bases

    dels: List[int] = []
    for li, ln in enumerate(lines.lines):
        lp = line_positions.get(li)
        if not lp or llens[li] < 2 * bc_require:
            continue
        starts = np.concatenate([np.asarray(ps, np.int64) for ps in lp.values()])
        bcs = np.repeat(np.fromiter(lp.keys(), np.int64, len(lp)),
                        [len(ps) for ps in lp.values()])
        order = np.lexsort((bcs, starts))
        starts, bcs = starts[order], bcs[order]
        offs = element_offsets(D, ln)
        for j, cell in enumerate(ln.elements):
            is_bubble = len(cell.paths) > 1
            is_gap_el = any(D.is_gap(int(e)) for e in cell.edge_ids())
            is_rep = rep_edge is not None and all(
                rep_edge[int(e)] for e in cell.edge_ids()
            )
            if not (is_bubble or is_gap_el or is_rep):
                continue
            ncell = int(offs[j + 1] - offs[j])
            if ncell > BC_MAX_CELL:
                continue
            mid = int(offs[j]) + ncell // 2
            if mid < bc_require or llens[li] - mid < bc_require:
                continue
            # the windows [mid-flank, mid-ignore] and [mid+ignore, mid+flank]
            a = int(np.searchsorted(starts, mid - bc_flank, "left"))
            b = max(int(np.searchsorted(starts, mid - bc_ignore, "right")), a)
            c = int(np.searchsorted(starts, mid + bc_ignore, "left"))
            d = max(int(np.searchsorted(starts, mid + bc_flank, "right")), c)
            n = min(b - a, d - c)
            bridge = len(np.intersect1d(bcs[a:b], bcs[c:d]))
            expect = min(1.0, n / winpos) * BC_MIN
            if bridge < expect:
                dels.extend(int(e) for e in cell.edge_ids())
    return sorted(set(dels))


MIN_SHARE_FRAC = 0.25  # Super.cc:810
SURPRISE = 4.0  # Super.cc:812 (k + 4*sqrt(k) noise allowance)


def kill_misassembled_cells_alt(D, lines, ebcx) -> List[int]:
    """KillMisassembledCellsAlt (Super.cc:802-901): judge each interior
    cell by the barcode sets of its flanking straight edges (unique base
    edges only, via ebcx); with n = min(|b1|, |b2|) >= 10 and
    (k + SURPRISE*sqrt(k))/n < MIN_SHARE_FRAC, the cell's edges are
    killed.  Position-free — complements the window-based rule."""
    import math

    from ..core.kmer_codec import K
    from .local import compute_mult

    mult = compute_mult(D)
    bkmers = D.bg.edges.lengths() - (K - 1)
    dels: List[int] = []
    for ln in lines.lines:
        els = ln.elements
        for m in range(1, len(els) - 1):
            cell = els[m]
            if len(cell.paths) == 1 and not any(
                D.is_gap(int(e)) for e in cell.edge_ids()
            ):
                continue  # straight sequence element, not a junction cell
            # cell length gate (median over arms, kmers; Super.cc:849-859)
            plens = []
            for p in cell.paths:
                t = 0
                for d in p:
                    if not D.is_gap(int(d)):
                        t += int(
                            bkmers[np.asarray(D.epaths.row(int(d)), np.int64)].sum()
                        )
                plens.append(t)
            plens.sort()
            if plens and plens[len(plens) // 2] > BC_MAX_CELL:
                continue
            d1 = int(els[m - 1].paths[0][-1])
            d2 = int(els[m + 1].paths[0][0])
            if D.is_gap(d1) or D.is_gap(d2):
                continue

            def flank_bcs(d):
                out: Set[int] = set()
                for e in np.asarray(D.epaths.row(d), np.int64):
                    if mult[int(e)] != 1:
                        continue
                    out |= set(int(b) for b in ebcx.row(int(e)))
                return out

            b1, b2 = flank_bcs(d1), flank_bcs(d2)
            n = min(len(b1), len(b2))
            if n < 10:
                continue
            k = len(b1 & b2)
            if (k + SURPRISE * math.sqrt(k)) / n >= MIN_SHARE_FRAC:
                continue
            dels.extend(int(e) for e in cell.edge_ids())
    return sorted(set(dels))


def break_lines(
    lines,
    D,
    sup_bcs: List[np.ndarray],
    min_span: int = MIN_SPAN_BC,
    line_positions=None,
):
    """Split lines at weak junctions (set-based rule + positional
    flank-window rule when barcode positions are supplied).  Returns a new
    Lines object.  line_positions: {(barcode, line): [positions]}.

    Junction detection runs per line, but the SPLITS are symmetrized across
    each rc line pair: a junction before element j of line i is the same
    genomic position as the junction before element n-j of line linv[i], so
    the union of both strands' detections is broken on both.  Without this,
    a positional detection that fires on one strand only (read positions
    are strand-assigned) splits one strand and not its rc — downstream,
    splay_line_ends then splays one strand's vertices only, permanently
    breaking the supergraph's vertex involution (observed: an 8 kb sim's D
    lost rc symmetry and kill_low_unique's deletions stopped being
    dinv-closed)."""
    from .lines import Line, Lines

    by_line: dict = {}
    for (bc, lj), ps in (line_positions or {}).items():
        by_line.setdefault(lj, {})[bc] = ps
    weak_sets: List[set] = []
    for li, ln in enumerate(lines.lines):
        weak = set(find_weak_junctions(D, ln, sup_bcs, min_span))
        if line_positions is not None:
            lp = by_line.get(li)
            if lp:
                weak |= set(find_weak_junctions_positional(D, ln, lp, min_span))
        weak_sets.append(weak)
    # symmetrize: mirror each line's junctions onto its rc line
    linv0 = np.asarray(lines.linv)
    sym = [set(w) for w in weak_sets]
    for li, w in enumerate(weak_sets):
        ip = int(linv0[li]) if li < len(linv0) else -1
        if 0 <= ip < len(sym):
            n_i = len(lines.lines[li].elements)
            if len(lines.lines[ip].elements) == n_i:
                sym[ip] |= {n_i - j for j in w}

    new_lines: List[Line] = []
    for li, ln in enumerate(lines.lines):
        weak = sym[li]
        if not weak:
            new_lines.append(ln)
            continue
        cur: list = []
        for j, el in enumerate(ln.elements):
            if j in weak and cur:
                new_lines.append(Line(cur))
                cur = []
            cur.append(el)
        if cur:
            new_lines.append(Line(cur))

    n_edges = len(lines.line_of_edge)
    line_of_edge = np.full(n_edges, -1, np.int64)
    for i, ln in enumerate(new_lines):
        for el in ln.elements:
            for e in el.edge_ids():
                line_of_edge[int(e)] = i
    linv = np.zeros(len(new_lines), np.int64)
    for i, ln in enumerate(new_lines):
        e0 = int(ln.elements[0].paths[0][0])
        linv[i] = line_of_edge[int(D.dinv[e0])]
    return Lines(new_lines, line_of_edge, linv)
