"""Inversion-artifact handling on the supergraph D.

The port's own copy of supernova_tpu/asm/inversion.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference analogues:
  * ZapInversionBubbles (10X/Super.cc:3167-3186): a cell sandwiched between
    a straight edge and that edge's own rc twin is an inversion artifact,
    not a het site — delete the cell's edges (and their dinv partners).
  * KillInversionArtifacts (10X/Super.cc:3003-3123, CP.cc:593-598): at a
    fork v (one in-edge h, two out-branches z and f) whose neighborhood
    "looks like" an inversion (some edge near one branch is the dinv of an
    edge near the other), delete the branch with almost no barcode support
    when the sibling is much better supported (MAX_CAN_INS_DEL=4,
    MIN_CAN_INS_RATIO=5).
  * RemoveUnneededVertices/CleanupCore (10X/CleanThe.cc): after deletion,
    chains through now-simple vertices are recompacted; delete_edges here
    does both in one pass, keeping the involution consistent.

  * InvFix (10X/InvFix.cc:22-162): flip a line segment lying between two
    barcode-only gaps when barcode positions say the interior is
    inverted — `inv_fix` below.  (The galigns/RefAlign part of the
    reference is diagnostic logging only; the fix itself is
    barcode-driven.)

Host-side by design: D is supergraph-scale (1e5-1e6 edges, SURVEY.md §7).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

MAX_CAN_INS_DEL = 4  # CP.cc:595
MIN_CAN_INS_RATIO = 5  # Super.h:192 default


class PairBarcodes:
    """Sorted (ordered-edge-pair, id) rows supporting O(log n) queries —
    the vectorized form of the (d_a, d_b) -> barcode-set map."""

    def __init__(self, D, dpaths: np.ndarray, dlen: np.ndarray, read_bc):
        r, mp = dpaths.shape
        dlen = np.asarray(dlen)[:r]
        self.ed = np.int64(D.n_edges + 1)
        if r == 0 or mp < 2:
            self.key = np.zeros(0, np.int64)
            self.id = np.zeros(0, np.int64)
            return
        if read_bc is None:
            ids = np.arange(r, dtype=np.int64)
        else:
            ids = np.asarray(read_bc)[:r].astype(np.int64)
        a = dpaths[:, :-1]
        b = dpaths[:, 1:]
        slot = np.arange(mp - 1)[None, :]
        ok = (slot + 1 < dlen[:, None]) & (a >= 0) & (b >= 0)
        if read_bc is not None:
            ok &= ids[:, None] > 0
        rows, cols = np.nonzero(ok)
        pair_k = a[rows, cols].astype(np.int64) * self.ed + b[rows, cols]
        uniq = np.unique(np.stack([pair_k, ids[rows]], axis=1), axis=0)
        self.key = uniq[:, 0]
        self.id = uniq[:, 1]

    def ids(self, da: int, db: int) -> np.ndarray:
        k = np.int64(da) * self.ed + db
        lo = np.searchsorted(self.key, k, side="left")
        hi = np.searchsorted(self.key, k, side="right")
        return self.id[lo:hi]


def consecutive_pair_barcodes(
    D, dpaths: np.ndarray, dlen: np.ndarray, read_bc: np.ndarray | None
) -> PairBarcodes:
    """(d_a, d_b) consecutive-traversal support index (see PairBarcodes)."""
    return PairBarcodes(D, dpaths, dlen, read_bc)


INVFIX_WINDOW = 10_000  # InvFix.cc:85


def inv_fix(D, lines, line_positions: Dict, window: int = INVFIX_WINDOW) -> int:
    """Flip line segments that seem inverted (InvFix, 10X/InvFix.cc:84-158).

    For each line, between every adjacent pair of barcode-only {-2} gaps
    at positions (start, stop): compare barcode sharing in windows around
    the two gaps.  n1 = |left1 ∩ right1| + |left2 ∩ right2| supports the
    current orientation; n2 = |left1 ∩ left2| + |right1 ∩ right2| supports
    the interior being inverted (barcodes entering at `start` should exit
    near `start`, but with an inverted interior they reappear at `stop`).
    When n2 > n1, swap the interior with its rc by re-homing the four
    flanking edges (GiveEdgeNewToVx/FromVx calls, InvFix.cc:131-136).

    Mutates D.from_v/D.to_v in place; returns the number of segments
    flipped.  Callers must re-run find_lines when > 0.  (Deviation from
    the reference: position reflection after a flip uses start+stop-p;
    InvFix.cc:146 writes stop-start-p, which de-calibrates pb against the
    untouched line coordinates.)"""
    from .gap import is_bc_gap
    from .molecules import element_offsets

    linv = np.asarray(lines.linv)
    dinv = np.asarray(D.dinv)
    # per-line sorted (pos, bc); accepts {line: {bc: [pos]}} (the
    # pipeline's _line_positions) or flat {(bc, line): [pos]}
    per_line: Dict[int, list] = {}
    for key, val in line_positions.items():
        if isinstance(key, tuple):
            bc, lj = key
            per_line.setdefault(int(lj), []).extend(
                (int(p), int(bc)) for p in val
            )
        else:
            for bc, ps in val.items():
                per_line.setdefault(int(key), []).extend(
                    (int(p), int(bc)) for p in ps
                )

    n_fixed = 0
    for li, ln in enumerate(lines.lines):
        if linv[li] <= li:
            continue
        # barcode-only gaps (solo single-edge cells) + line coordinates
        offs = element_offsets(D, ln)
        gpos: List[int] = []
        gid: List[int] = []
        for m, el in enumerate(ln.elements):
            if len(el.paths) == 1 and len(el.paths[0]) == 1:
                d = int(el.paths[0][0])
                row = D.epaths.row(d)
                if len(row) and is_bc_gap(row):
                    gpos.append(int(offs[m]))
                    gid.append(d)
        if len(gpos) < 2:
            continue
        pb = sorted(per_line.get(li, []))
        if not pb:
            continue
        pbp = np.array([p for p, _ in pb], np.int64)
        pbb = np.array([b for _, b in pb], np.int64)

        def score(j1: int, j2: int) -> int:
            start, stop = gpos[j1], gpos[j2]
            lo = int(np.searchsorted(pbp, start - window))
            hi = int(np.searchsorted(pbp, stop + window, side="right"))
            p = pbp[lo:hi]
            b = pbb[lo:hi]
            half = (stop - start) // 2
            l1 = set(b[(p < start) & (p >= start - window)].tolist())
            r1 = set(b[(p >= start) & (p < start + half)].tolist())
            l2 = set(b[(p < stop) & (p >= stop - half)].tolist())
            r2 = set(b[(p >= stop) & (p < stop + window)].tolist())
            n1 = len(l1 & r1) + len(l2 & r2)
            n2 = len(l1 & l2) + len(r1 & r2)
            return n2 - n1

        j1 = 0
        while j1 < len(gpos) - 1:
            j2 = j1 + 1
            if score(j1, j2) <= 0:
                j1 += 1
                continue
            d1, d2 = gid[j1], gid[j2]
            rd1, rd2 = int(dinv[d1]), int(dinv[d2])
            v1, w1 = int(D.from_v[d1]), int(D.to_v[d2])
            ins = np.nonzero(D.to_v == v1)[0]
            outs = np.nonzero(D.from_v == w1)[0]
            if len(ins) != 1 or len(outs) != 1:  # InvFix.cc:128
                j1 += 1
                continue
            v2, w2 = int(D.from_v[rd2]), int(D.to_v[rd1])
            if v1 == v2 or w1 == w2:  # degenerate palindrome
                j1 += 1
                continue
            f1, g1 = int(ins[0]), int(outs[0])
            ins2 = np.nonzero(D.to_v == v2)[0]
            outs2 = np.nonzero(D.from_v == w2)[0]
            if len(ins2) != 1 or len(outs2) != 1:
                j1 += 1
                continue
            f2, g2 = int(ins2[0]), int(outs2[0])
            # swap the interior with its rc (InvFix.cc:131-136)
            D.to_v[f1] = v2
            D.to_v[f2] = v1
            D.from_v[g1] = w2
            D.from_v[g2] = w1
            n_fixed += 1
            # reflect barcode positions inside the flipped interior
            start, stop = gpos[j1], gpos[j2]
            lo = int(np.searchsorted(pbp, start))
            hi = int(np.searchsorted(pbp, stop, side="right"))
            pbp[lo:hi] = (start + stop) - pbp[lo:hi]
            order = np.argsort(pbp[lo:hi], kind="stable")
            pbp[lo:hi] = pbp[lo:hi][order]
            pbb[lo:hi] = pbb[lo:hi][order]
            # advance past gaps within `window` of the flipped segment
            j1 = j2 + 1
            while j1 < len(gpos) - 1 and gpos[j1] - gpos[j2] < window:
                j1 += 1
    return n_fixed


def zap_inversion_bubbles(D, lines) -> List[int]:
    """-> D-edge ids to delete (involution-symmetric)."""
    dels: List[int] = []
    dinv = D.dinv
    for ln in lines.lines:
        els = ln.elements
        for j in range(1, len(els) - 1):
            left, right = els[j - 1], els[j + 1]
            if not left.is_straight() or not right.is_straight():
                continue
            if int(dinv[int(left.paths[0][0])]) != int(right.paths[0][0]):
                continue
            for d in els[j].edge_ids():
                dels.append(int(d))
                dels.append(int(dinv[int(d)]))
    return sorted(set(dels))


def kill_inversion_artifacts(
    D,
    dpaths: np.ndarray,
    dlen: np.ndarray,
    read_bc: np.ndarray | None,
    max_del: int = MAX_CAN_INS_DEL,
    min_ratio: int = MIN_CAN_INS_RATIO,
) -> List[int]:
    """Low-depth canonical-inversion branches to delete (+ dinv partners)."""
    dinv = D.dinv
    pair_bc = consecutive_pair_barcodes(D, dpaths, dlen, read_bc)

    def branch_support(h: int, g: int) -> int:
        fwd = pair_bc.ids(h, g)
        rc = pair_bc.ids(int(dinv[g]), int(dinv[h]))
        return len(np.union1d(fwd, rc))

    dels: List[int] = []
    # adjacency once (the per-vertex nonzero scans were quadratic)
    in_at: Dict[int, List[int]] = {}
    out_at: Dict[int, List[int]] = {}
    for e in range(D.n_edges):
        out_at.setdefault(int(D.from_v[e]), []).append(e)
        in_at.setdefault(int(D.to_v[e]), []).append(e)
    # candidate forks: one in-edge, two out-edges
    indeg = np.bincount(D.to_v, minlength=D.n_vertices)
    outdeg = np.bincount(D.from_v, minlength=D.n_vertices)
    for v in np.nonzero((indeg == 1) & (outdeg == 2))[0]:
        h = in_at[int(v)][0]
        outs = out_at[int(v)]
        for z, f in ((outs[0], outs[1]), (outs[1], outs[0])):
            w = int(D.to_v[z])
            w_outs = out_at.get(w, [])
            if len(w_outs) != 1:
                continue
            # neighborhoods on each side of the fork (bounded 2-step walk,
            # the nhood construction of Super.cc:3035-3050)
            nhood0 = {int(h), int(f)}
            x = int(D.from_v[h])
            nhood0.update(int(e) for e in in_at.get(x, ()))
            nhood1 = {int(w_outs[0])}
            for e in in_at.get(w, ()):
                if e != z:
                    nhood1.add(int(e))
                    m = int(D.from_v[e])
                    nhood1.update(int(g) for g in in_at.get(m, ()))
            looks_like = any(int(dinv[a]) in nhood1 for a in nhood0)
            if not looks_like:
                continue
            s_z = branch_support(int(h), int(z))
            s_f = branch_support(int(h), int(f))
            if s_z <= max_del and s_f >= min_ratio * max(s_z, 1) and s_f > 0:
                dels.append(int(z))
                dels.append(int(dinv[z]))
                break
    return sorted(set(dels))


def _compact_chains(
    E: int,
    live: np.ndarray,
    from_e: np.ndarray,
    to_e: np.ndarray,
    n_vertices: int,
    no_merge: np.ndarray | None = None,
) -> List[np.ndarray]:
    """Maximal unbranched chains of the live edges through simple
    (in=1, out=1) vertices; cycles broken deterministically at min edge id.
    Edges flagged in `no_merge` (gap edges — their payload is not a base-edge
    path) never join a chain, mirroring RemoveUnneededVertices' DoCheck gate
    on negative payloads (10X/Super.cc:1150-1153)."""
    indeg = np.zeros(n_vertices, dtype=np.int64)
    outdeg = np.zeros(n_vertices, dtype=np.int64)
    np.add.at(indeg, to_e[live], 1)
    np.add.at(outdeg, from_e[live], 1)
    out_edge = np.full(n_vertices, -1, dtype=np.int64)
    in_edge = np.full(n_vertices, -1, dtype=np.int64)
    for e in live:
        if outdeg[from_e[e]] == 1:
            out_edge[from_e[e]] = e
        if indeg[to_e[e]] == 1:
            in_edge[to_e[e]] = e
    nxt = np.full(E, -1, dtype=np.int64)
    prv = np.full(E, -1, dtype=np.int64)
    for e in live:
        if no_merge is not None and no_merge[e]:
            continue
        v = int(to_e[e])
        if indeg[v] == 1 and outdeg[v] == 1:
            f = out_edge[v]
            if f >= 0 and f != e and not (no_merge is not None and no_merge[f]):
                nxt[e] = f
                prv[f] = e
    visited = np.zeros(E, dtype=bool)
    for e in live:
        if visited[e] or prv[e] != -1:
            continue
        c = e
        while c != -1 and not visited[c]:
            visited[c] = True
            c = nxt[c]
    for e in live:
        if not visited[e]:  # cycle member
            cyc, x = [int(e)], nxt[e]
            visited[e] = True
            while x != e:
                visited[x] = True
                cyc.append(int(x))
                x = nxt[x]
            m = min(cyc)
            prv[m] = -1
            nxt[cyc[cyc.index(m) - 1]] = -1
    chains: List[np.ndarray] = []
    for e in live:
        if prv[e] != -1:
            continue
        chain = [int(e)]
        c = nxt[e]
        while c != -1:
            chain.append(int(c))
            c = nxt[c]
        chains.append(np.asarray(chain, dtype=np.int64))
    return chains


def delete_edges(D, dels: List[int], force: bool = False):
    """Remove D-edges (involution-symmetrized) and recompact chains through
    now-simple vertices.  Returns a new SuperGraph over the same BaseGraph.
    `force` recompacts even with no deletions (after structural edits)."""
    from .supergraph import SuperGraph
    from ..core.ragged import Ragged

    ED = D.n_edges
    drop = np.zeros(ED, dtype=bool)
    for d in dels:
        drop[int(d)] = True
        drop[int(D.dinv[d])] = True
    keep = ~drop
    if (keep.all() and not force) or not keep.any():
        return D
    live = np.nonzero(keep)[0]
    chains = _compact_chains(
        ED, live, D.from_v, D.to_v, D.n_vertices, no_merge=D.gap_mask()
    )

    paths: List[np.ndarray] = []
    new_of_old = np.full(ED, -1, dtype=np.int64)
    for chain in chains:
        d = len(paths)
        for od in chain:
            new_of_old[od] = d
        paths.append(np.concatenate([D.epaths.row(int(od)) for od in chain]))
    nd = len(paths)
    dinv = np.zeros(nd, dtype=np.int64)
    tails = [int(c[-1]) for c in chains]
    for d, t in enumerate(tails):
        dinv[d] = new_of_old[int(D.dinv[t])]
    from_v = np.array([D.from_v[int(c[0])] for c in chains], dtype=np.int64)
    to_v = np.array([D.to_v[int(c[-1])] for c in chains], dtype=np.int64)
    used_v = np.unique(np.concatenate([from_v, to_v])) if nd else np.zeros(0, np.int64)
    remap = {int(v): i for i, v in enumerate(used_v)}
    from_v = np.array([remap[int(v)] for v in from_v], dtype=np.int64)
    to_v = np.array([remap[int(v)] for v in to_v], dtype=np.int64)
    return SuperGraph(
        epaths=Ragged.from_rows(paths, dtype=np.int64)
        if nd
        else Ragged(np.zeros(0, np.int64), np.zeros(1, np.int64)),
        dinv=dinv,
        from_v=from_v,
        to_v=to_v,
        n_vertices=len(used_v),
        bg=D.bg,
    )
