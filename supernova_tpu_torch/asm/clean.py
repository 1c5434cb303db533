"""Supergraph cleanup passes (CP's Cleaner family).

The port's own copy of supernova_tpu/asm/clean.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogues:
  * SimpleHangs (10X/Super.cc:3128-3165, CP.cc:838-846): delete a short
    hanging D-edge (dead end, <= MAX_KILL kmers) when a sibling branch
    continues >= MIN_RATIO times farther.
  * DistancesToEndArr (10X/Super.cc): capped longest forward distance from
    each vertex, used by the hang tests.
  * weak bubble-arm deletion / 3:0 rule (CP.cc:1692-1794): in a two-arm
    cell, an arm with no read support loses to a strongly supported sibling
    (sequencing-error arms after nucleation).

All host-side: D is supergraph-scale (SURVEY.md §7 boundary rule).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.kmer_codec import K

MAX_KILL = 350  # CP.cc:838
MIN_RATIO = 25.0  # CP.cc:839
STRONG = 3  # the 3:0 bubble rule
MIN_SPLAY1 = 3500  # CP.cc:83 (build-phase splay)
MIN_SPLAY2 = 5000  # CP.cc:902 (star/fix-phase splay)


def splay_line_ends(D, lines, llens: np.ndarray, min_splay: int | None = None) -> int:
    """Splay the vertices at the ends of long lines (Splay,
    10X/Super.cc:904-936; called with MIN_SPLAY1=3500 at CP.cc:620 and
    MIN_SPLAY2=5000 at CP.cc:908,1305).

    For every line of length >= min_splay, if the vertex at either end has
    total degree > 1, every incident edge gets its own fresh vertex
    (digraphE::SplayVertex, graph/DigraphTemplate.h:2500-2509).  This
    severs adjacency-only connections at long-line boundaries so that only
    barcode evidence (Star / barcode joins) can reconnect them.
    Involution symmetry comes from processing both a line and its rc
    (the reference's two-pass loop over i and linv[i]).

    Mutates D.from_v / D.to_v / D.n_vertices in place; returns the number
    of vertices splayed.  Line structures remain edge-valid but vertex
    connectivity changed — callers should re-run find_lines when > 0."""
    if min_splay is None:
        min_splay = MIN_SPLAY1
    linv = np.asarray(lines.linv)
    assert np.array_equal(linv[linv], np.arange(lines.n_lines)), (
        "splay_line_ends needs rc-symmetric lines (linv not an involution) "
        "— splaying from asymmetric lines permanently breaks the vertex "
        "involution of D"
    )
    indeg = np.bincount(D.to_v, minlength=D.n_vertices)
    outdeg = np.bincount(D.from_v, minlength=D.n_vertices)
    deg = indeg + outdeg
    splays = set()
    for i, ln in enumerate(lines.lines):
        if llens[i] < min_splay:
            continue
        ip = int(lines.linv[i])
        if ip < i:
            continue
        for li in {i, ip}:
            L = lines.lines[li]
            if not L.elements:
                continue
            p0 = L.elements[0].paths
            p1 = L.elements[-1].paths
            if not p0 or not len(p0[0]) or not p1 or not len(p1[0]):
                continue
            v = int(D.from_v[int(p0[0][0])])
            w = int(D.to_v[int(p1[0][0])])
            for x in (v, w):
                if deg[x] > 1:
                    splays.add(x)
    nv = D.n_vertices
    for v in sorted(splays):
        for e in np.nonzero(D.to_v == v)[0]:
            D.to_v[e] = nv
            nv += 1
        for e in np.nonzero(D.from_v == v)[0]:
            D.from_v[e] = nv
            nv += 1
    D.n_vertices = nv
    return len(splays)


def superedge_kmers(D) -> np.ndarray:
    """Kmers per D-edge (sum of constituent base-edge kmers).  Vectorized
    segment sum (the per-edge loop was a wall at 1e6 D-edges); gap edges
    report 0 kmers (the old loop indexed base_k with the negative gap
    codes, wrapping to arbitrary edges)."""
    base_k = (D.bg.edges.lengths() - (K - 1)).astype(np.int64)
    vals = np.asarray(D.epaths.values, np.int64)
    lens = np.asarray(D.epaths.lengths(), np.int64)
    if D.n_edges == 0 or len(vals) == 0:
        return np.zeros(D.n_edges, dtype=np.int64)
    row_of = np.repeat(np.arange(D.n_edges), lens)
    ok = vals >= 0
    return np.bincount(
        row_of[ok], weights=base_k[vals[ok]], minlength=D.n_edges
    ).astype(np.int64)


def distances_to_end(D, lens: np.ndarray, cap: int) -> np.ndarray:
    """dfw[v] = longest forward path length from v, capped (DistancesToEndArr
    analogue; iterative relaxation, the cap bounds cycles)."""
    dfw = np.zeros(D.n_vertices, dtype=np.int64)
    for _ in range(64):
        nxt = np.zeros(D.n_vertices, dtype=np.int64)
        np.maximum.at(nxt, D.from_v, np.minimum(lens + dfw[D.to_v], cap))
        if np.array_equal(nxt, dfw):
            break
        dfw = nxt
    return dfw


def _group_top2(keys: np.ndarray, scores: np.ndarray, n_groups: int):
    """Per-group (max, second-max) of `scores` grouped by `keys`.
    Groups with < 2 members report second = -inf-analogue (minimum int)."""
    lo = np.iinfo(np.int64).min
    gmax = np.full(n_groups, lo, np.int64)
    np.maximum.at(gmax, keys, scores)
    # second max: max over entries strictly below the group max, plus the
    # duplicate-max case (two entries achieving gmax)
    below = scores < gmax[keys]
    gsec = np.full(n_groups, lo, np.int64)
    np.maximum.at(gsec, keys[below], scores[below])
    n_at_max = np.zeros(n_groups, np.int64)
    np.add.at(n_at_max, keys[~below], 1)
    dup = n_at_max >= 2
    gsec[dup] = gmax[dup]
    return gmax, gsec


def simple_hangs(
    D, max_kill: int = MAX_KILL, min_ratio: float = MIN_RATIO
) -> List[int]:
    """-> D-edge ids to delete (involution-symmetric).  Vectorized: the
    best-sibling-excluding-self test is a per-from-vertex top-2."""
    if D.n_edges == 0:
        return []
    lens = superedge_kmers(D)
    dfw = distances_to_end(D, lens, int(max_kill * min_ratio))
    indeg = np.bincount(D.to_v, minlength=D.n_vertices)
    outdeg = np.bincount(D.from_v, minlength=D.n_vertices)
    fv = np.asarray(D.from_v, np.int64)
    tv = np.asarray(D.to_v, np.int64)
    score = lens + dfw[tv]
    gmax, gsec = _group_top2(fv, score, D.n_vertices)
    best_excl = np.where(score < gmax[fv], gmax[fv], gsec[fv])
    hang = (outdeg[tv] == 0) & (indeg[tv] == 1) & (lens <= max_kill)
    cond = hang & (best_excl >= min_ratio * np.maximum(lens, 1))
    dels = np.nonzero(cond)[0]
    return sorted(set(dels.tolist()) | set(np.asarray(D.dinv)[dels].tolist()))


MAX_KILLX = 2500  # CleanThe.cc:2350
MIN_RATIOX = 20.0  # CleanThe.cc:2351


def compound_hangs(
    D, max_kill: int = MAX_KILLX, min_ratio: float = MIN_RATIOX
) -> List[int]:
    """FindCompoundHangs (CleanThe.cc:2782-2795, MAX_KILLX=2500,
    MIN_RATIOX=20): delete a branch whose
    ENTIRE forward continuation is short (<= max_kill kmers, subtree
    included via the capped distance-to-end) when a sibling continues
    >= min_ratio times farther; the orphaned subtree falls to the
    small-component pass.  -> D-edge ids (involution-symmetric)."""
    if D.n_edges == 0:
        return []
    lens = superedge_kmers(D)
    dfw = distances_to_end(D, lens, int(max_kill * min_ratio))
    fv = np.asarray(D.from_v, np.int64)
    tv = np.asarray(D.to_v, np.int64)
    score = lens + dfw[tv]
    lo = np.iinfo(np.int64).min
    gmax = np.full(D.n_vertices, lo, np.int64)
    np.maximum.at(gmax, fv, score)
    best = gmax[fv]
    cond = (
        (score <= max_kill)
        & (best >= min_ratio * np.maximum(score, 1))
        & (score < best)
    )
    dels = np.nonzero(cond)[0]
    return sorted(set(dels.tolist()) | set(np.asarray(D.dinv)[dels].tolist()))


def weak_cell_arms(D, lines, support: np.ndarray, strong: int = STRONG) -> List[int]:
    """3:0 rule over two-arm cells: delete the unsupported arm when the
    sibling has >= `strong` read support.  Arm support is measured on edges
    unique to that arm.  -> D-edge ids (involution-symmetric)."""
    dels: List[int] = []
    for ln in lines.lines:
        for el in ln.elements:
            if len(el) != 2:
                continue
            e0 = set(el.paths[0].tolist())
            e1 = set(el.paths[1].tolist())
            only0 = list(e0 - e1)
            only1 = list(e1 - e0)
            if not only0 or not only1:
                continue
            s0 = int(support[only0].max())
            s1 = int(support[only1].max())
            weak = None
            if s0 >= strong and s1 == 0:
                weak = only1
            elif s1 >= strong and s0 == 0:
                weak = only0
            if weak:
                for d in weak:
                    dels.append(int(d))
                    dels.append(int(D.dinv[d]))
    return sorted(set(dels))


MIN_COMP_SIZE = 300  # CleanThe.cc:2801


def component_of_edges(D) -> np.ndarray:
    """(ED,) weakly-connected component label per D-edge (the
    ComponentsEFast analogue).  Vectorized min-label propagation with
    pointer doubling — O((E+V) log V) numpy passes instead of a per-edge
    Python union-find."""
    labels = np.arange(D.n_vertices, dtype=np.int64)
    fv = np.asarray(D.from_v, np.int64)
    tv = np.asarray(D.to_v, np.int64)
    while True:
        nxt = labels.copy()
        np.minimum.at(nxt, fv, labels[tv])
        np.minimum.at(nxt, tv, labels[fv])
        nxt = nxt[nxt]  # pointer doubling
        if np.array_equal(nxt, labels):
            break
        labels = nxt
    return labels[fv]


def remove_very_small_components(D, min_kmers: int = MIN_COMP_SIZE) -> List[int]:
    """RemoveVerySmallComponents (CleanThe.cc:791-817): delete every edge of
    weakly-connected components totalling < min_kmers kmers — the residue of
    short contained closures that never glued.  -> D-edge ids."""
    if D.n_edges == 0:
        return []
    lens = superedge_kmers(D)
    comp = component_of_edges(D)
    comp_k = np.bincount(comp, weights=lens, minlength=D.n_vertices)
    return np.nonzero(comp_k[comp] < min_kmers)[0].tolist()


def edge_multiplicity(D) -> np.ndarray:
    """(E_base,) occurrences of each base edge across non-gap D-edges
    (ComputeMult, 10X/Super.cc:793-801)."""
    mult = np.zeros(D.bg.n_edges, dtype=np.int64)
    vals = D.epaths.values
    gaps = D.gap_mask()
    offs = D.epaths.offsets
    for d in range(D.n_edges):
        if gaps[d]:
            continue
        np.add.at(mult, vals[offs[d] : offs[d + 1]], 1)
    return mult


MIN_UNIQ = 75  # Super.cc:1405
MIN_UNIQ_FRAC = 0.1  # Super.h:116


def kill_low_unique(D, min_uniq: int = MIN_UNIQ) -> List[int]:
    """KillLowUnique (10X/Super.cc:1403-1424): delete every edge of
    components whose unique content (kmers of base edges used by exactly
    one D-edge) is < min_uniq — repeat-only junk components."""
    mult = edge_multiplicity(D)
    base_k = (D.bg.edges.lengths() - (K - 1)).astype(np.int64)
    comp = component_of_edges(D)
    gaps = D.gap_mask()
    uc: dict = {}
    for d in range(D.n_edges):
        c = comp[d]
        uc.setdefault(c, 0)
        if gaps[d]:
            continue
        p = D.epaths.row(d)
        u = p[mult[p] == 1]
        uc[c] += int(base_k[u].sum())
    return [d for d in range(D.n_edges) if uc[comp[d]] < min_uniq]


def kill_low_unique_frac(D, min_frac: float = MIN_UNIQ_FRAC) -> List[int]:
    """KillLowUniqueFrac (10X/Super.cc:1426-1448): delete components whose
    unique kmer fraction is < min_frac."""
    mult = edge_multiplicity(D)
    base_k = (D.bg.edges.lengths() - (K - 1)).astype(np.int64)
    comp = component_of_edges(D)
    gaps = D.gap_mask()
    uc: dict = {}
    tot: dict = {}
    for d in range(D.n_edges):
        c = comp[d]
        uc.setdefault(c, 0)
        tot.setdefault(c, 0)
        if gaps[d]:
            continue
        p = D.epaths.row(d)
        tot[c] += int(base_k[p].sum())
        uc[c] += int(base_k[p[mult[p] == 1]].sum())
    return [
        d
        for d in range(D.n_edges)
        if tot[comp[d]] > 0 and uc[comp[d]] / tot[comp[d]] < min_frac
    ]


MAX_CAN_INS_DEL = 5  # CleanThe.cc:130
MIN_CAN_INS_RATIO = 4  # CleanThe.cc:131


def _adjacency_support(dpaths: np.ndarray, dlen: np.ndarray, a: int, b: int) -> int:
    """Reads whose placed D-path contains the consecutive pair (a, b)."""
    r, mp = dpaths.shape
    if mp < 2:
        return 0
    valid = np.arange(1, mp)[None, :] < np.asarray(dlen)[:r, None]
    hit = (dpaths[:, :-1] == a) & (dpaths[:, 1:] == b) & valid
    return int(hit.any(axis=1).sum())


def snip_flip_squares(D, lines, dpaths: np.ndarray, dlen: np.ndarray) -> List[int]:
    """SnipFlipSquares (CleanThe.cc:125-204): at an inversion 'square' —
    two lines exit vertex v, one of them a solo non-gap edge d1 to w; one
    line (ending in edge g) enters v; one other line enters w and is the
    inverse of the line entering v — delete d1 (+rc) when read support
    for g->d1 is tiny compared to g->d2 (the sibling branch):
    n1 <= MAX_CAN_INS_DEL and n2 >= MIN_CAN_INS_RATIO * n1, n2 > 0."""
    linv = lines.linv
    first_e = []
    last_e = []
    for ln in lines.lines:
        if not ln.elements or not len(ln.elements[0].paths) or not len(
            ln.elements[0].paths[0]
        ):
            first_e.append(-1)
            last_e.append(-1)
            continue
        first_e.append(int(ln.elements[0].paths[0][0]))
        last_e.append(int(ln.elements[-1].paths[0][-1]))
    out_lines: dict = {}
    in_lines: dict = {}
    for li in range(lines.n_lines):
        if first_e[li] < 0:
            continue
        out_lines.setdefault(int(D.from_v[first_e[li]]), []).append(li)
        in_lines.setdefault(int(D.to_v[last_e[li]]), []).append(li)
    dels: List[int] = []
    dinv = D.dinv
    for v, outs in out_lines.items():
        if len(outs) != 2 or len(in_lines.get(v, ())) != 1:
            continue
        l3 = in_lines[v][0]
        g = last_e[l3]
        for m in (0, 1):
            l1, l2 = outs[m], outs[1 - m]
            ln1 = lines.lines[l1]
            e1 = ln1.edges()
            if len(e1) != 1 or D.is_gap(int(e1[0])):
                continue  # l1 must be a solo non-gap edge
            d1 = int(e1[0])
            w = int(D.to_v[d1])
            ins_w = [x for x in in_lines.get(w, ()) if x != l1]
            if len(in_lines.get(w, ())) != 2 or len(ins_w) != 1:
                continue
            if ins_w[0] != int(linv[l3]):
                continue  # the two entering lines must be rc partners
            d2 = first_e[l2]
            n1 = (
                _adjacency_support(dpaths, dlen, g, d1)
                + _adjacency_support(dpaths, dlen, int(dinv[d1]), int(dinv[g]))
            )
            n2 = (
                _adjacency_support(dpaths, dlen, g, d2)
                + _adjacency_support(dpaths, dlen, int(dinv[d2]), int(dinv[g]))
            )
            if n1 > MAX_CAN_INS_DEL:
                continue
            if n2 == 0 or n2 < MIN_CAN_INS_RATIO * n1:
                continue
            dels.extend([d1, int(dinv[d1])])
    return sorted(set(dels))


def clean_supergraph(D, place_fn, max_rounds: int = 4):
    """Iterate hang trimming + weak-arm deletion + inversion zapping until
    stable.  `place_fn(D) -> (dpaths, dlen)` supplies read support.
    Returns (D, total_deleted)."""
    from . import inversion as ainv
    from . import lines as alines
    from .nucleate import merge_short_overlaps
    from .place import dpath_counts

    total = 0
    for _ in range(max_rounds):
        merged = merge_short_overlaps(D)
        if merged.n_edges < D.n_edges:
            total += D.n_edges - merged.n_edges
            D = merged
        dels = simple_hangs(D)
        dels += compound_hangs(D)
        dels += remove_very_small_components(D)
        if D.bg is not None:
            dels += kill_low_unique(D)
            dels += kill_low_unique_frac(D)
        dpaths, dlen = place_fn(D)
        support = dpath_counts(D, dpaths, dlen)
        lines = alines.find_lines(D)
        dels += weak_cell_arms(D, lines, support)
        dels += ainv.zap_inversion_bubbles(D, lines)
        dels += snip_flip_squares(D, lines, dpaths, dlen)
        dels = sorted(set(dels))
        if not dels or len(dels) >= D.n_edges:
            break
        D = ainv.delete_edges(D, dels)
        total += len(dels)
    return D, total
