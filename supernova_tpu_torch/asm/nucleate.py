"""NucleateGraph: glue closure paths into the supergraph D.

The port's own copy of supernova_tpu/asm/nucleate.py, kept equal to it by
tests/test_torch_hostcopies.py, apart from nucleate_graph's gate: the
device glue (parallel/device_nucleate.py) runs for plain-mode closure
sets of more than DEVICE_GLUE_MIN_POSITIONS positions when `device` is
CUDA, and the mesh glue (parallel/sharded_nucleate.py) when a mesh of more
than one shard is given, as the reference's; the route taken goes into
`info`.  The port imports nothing of the JAX package.

Reference behavior (10X/mergers/ClosuresToGraph.cc:151-290 GetMatches +
NucleateGraph.h:6-35 + Vectorify):
  * closures are base-edge paths, closed under the involution;
  * matches between closures come from two sources:
      (a) end-reaching overlaps: maximal shared runs that reach the end of
          one closure and the start of one of them, with total overlap
          >= MIN_OVER = 200-(K-1) kmers, seeded at the least-multiplicity
          edge within the last MIN_OVER kmers (GetMatches:163-201);
      (b) long-edge matches: any two closure positions sharing an edge with
          >= MIN_OVER kmers, extended maximally (GetMatches:230-283);
  * matches are forced symmetric under the involution;
  * gluing identifies closure *positions*; the quotient graph's edges are
    base-edge instances, so a repeat base edge with distinct closure
    contexts becomes multiple D-edges — this is how read evidence separates
    repeats;
  * Vectorify collapses unbranched chains into digraphE<vec<int>> D.

Implementation: union-find over closure boundary nodes (c, b), b in
[0, len_c]; a match (c1,s1,c2,s2,L) unions boundaries (c1,s1+i)~(c2,s2+i),
i in [0,L], plus the rc image.  Host-side today (supergraph scale); the
device formulation (sort-based hash join + iterated label propagation over
the shard mesh) is the multi-chip path for later rounds.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.kmer_codec import K
from ..core.ragged import Ragged

MIN_OVER_BASES = 200  # GetMatches: MIN_OVER = 200 - (K-1) kmers
_MAX_LONG_PARTNERS = 40  # cap pairwise extension work on very hot edges


LOOK_MERGE_BASES = 250 + 47  # ShortMergers LOOK_MERGE=250 kmers -> bases
LOOK = 6  # ShortMergers exploration depth (CleanThe.cc:2353)


def _local_pairs(D, min_kmers: int, look: int = LOOK) -> set:
    """Candidate merge pairs: edges >= min_kmers kmers encountered within a
    `look`-hop forward exploration of a common vertex
    (ExploreRightToDepth, ShortMergers.cc:293-306) — merging is LOCAL;
    distant repeat copies are never candidates."""
    from .clean import superedge_kmers

    lens = superedge_kmers(D)
    out_at: Dict[int, List[int]] = {}
    for d in range(D.n_edges):
        out_at.setdefault(int(D.from_v[d]), []).append(d)
    pairs: set = set()
    for v in range(D.n_vertices):
        seen: List[int] = []
        frontier = [v]
        visited = {v}
        for _ in range(look):
            nxt = []
            for u in frontier:
                for d in out_at.get(u, ()):
                    if lens[d] >= min_kmers:
                        seen.append(d)
                    w = int(D.to_v[d])
                    if w not in visited:
                        visited.add(w)
                        nxt.append(w)
            frontier = nxt
            if not frontier or len(seen) > 24:
                break
        seen = sorted(set(seen))
        for i in range(len(seen)):
            for j in range(i + 1, len(seen)):
                pairs.add((seen[i], seen[j]))
    return pairs


def merge_short_overlaps(D, min_over_bases: int = LOOK_MERGE_BASES):
    """MergeShortOverlaps analogue (10X/mergers/ShortMergers.h, called 6x
    with Zipper from CleanThe.cc:2585-2597): merge superedges that share a
    unique >= LOOK_MERGE-kmer base-edge run AND sit within a LOOK-hop
    neighborhood of a common vertex (FindOverlap + ExploreRightToDepth) —
    the duplicates ClosuresToGraph leaves when closures overlap without
    reaching ends.  D's own vertex structure rides along as explicit
    boundary unions so adjacency is preserved."""
    paths = [tuple(int(e) for e in D.epaths.row(d)) for d in range(D.n_edges)]
    min_k = max(min_over_bases - 47, 1)
    cand = _local_pairs(D, min_k)
    # rc image pairs keep the merge involution-symmetric
    dinv = D.dinv
    cand |= {
        tuple(sorted((int(dinv[a]), int(dinv[b])))) for a, b in cand
    }
    pair_tuples = [(paths[a], paths[b]) for a, b in cand if paths[a] != paths[b]]
    groups: Dict[int, List[Tuple[tuple, int]]] = {}
    for d, p in enumerate(paths):
        groups.setdefault(int(D.from_v[d]), []).append((p, 0))
        groups.setdefault(int(D.to_v[d]), []).append((p, len(p)))
    return nucleate_graph(
        D.bg,
        paths,
        min_over_bases=min_over_bases,
        interior_matches=True,
        interior_pairs=pair_tuples,
        extra_unions=list(groups.values()),
    )


class _UF:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return int(root)

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            if ra < rb:  # deterministic: smaller id wins
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def sanitize_closures(bg, closures: Sequence[Sequence[int]]) -> List[Tuple[int, ...]]:
    """Split closures at non-adjacent junctions (path fragments from read
    errors), dedupe, and close under the involution."""
    inv = bg.inv
    out = set()
    for c in closures:
        if not len(c):
            continue
        cur = [int(c[0])]
        for a, b in zip(c, c[1:]):
            a, b = int(a), int(b)
            if bg.to_v[a] == bg.from_v[b]:
                cur.append(b)
            else:
                out.add(tuple(cur))
                cur = [b]
        out.add(tuple(cur))
    for c in list(out):
        out.add(tuple(int(inv[e]) for e in reversed(c)))
    return sorted(out)


def _extend(x1, x2, j1: int, j2: int) -> Tuple[int, int, int]:
    """Maximal match around x1[j1] == x2[j2] -> (start1, start2, len)."""
    a = 0
    while j1 - a - 1 >= 0 and j2 - a - 1 >= 0 and x1[j1 - a - 1] == x2[j2 - a - 1]:
        a += 1
    b = 1
    while j1 + b < len(x1) and j2 + b < len(x2) and x1[j1 + b] == x2[j2 + b]:
        b += 1
    return j1 - a, j2 - a, a + b


MIN_OVER_FLOOR_BASES = 100  # adaptive gate lower bound

# debug introspection (python glue path): the gate and candidate list of
# the last nucleate_graph call — used by core-equivalence investigations
_LAST_GATE: int | None = None
_LAST_CANDIDATES: list = []
# pod-scale memory honesty: range-shard the flat closure values across the
# mesh (extension reads become distributed gathers) instead of replicating
# them per device.  Addin: asm.nucleate.VALUE_SHARD=1.
VALUE_SHARD = False
# closure positions above which the device glue runs (the reference's gate,
# supernova_tpu/asm/nucleate.py:253)
DEVICE_GLUE_MIN_POSITIONS = 200_000


def nucleate_graph(
    bg,
    closures,
    min_over_bases: int | None = MIN_OVER_BASES,
    interior_matches: bool = False,
    extra_unions=None,
    interior_pairs=None,
    device_glue: bool | None = None,
    device=None,
    info: dict | None = None,
    glue_budgets: tuple | None = None,
    mesh=None,
):
    """Closures -> SuperGraph D by gluing (ClosuresToGraph analogue).

    With `interior_matches` (the MergeShortOverlaps mode,
    10X/mergers/ShortMergers.h, LOOK_MERGE=250): any maximal shared run
    >= min_over kmers glues, not just end-reaching ones — used when the
    "closures" are superedge paths being merged.

    `min_over_bases=None` selects the gate adaptively: the reference's
    MIN_OVER=200 bases assumes deep coverage where adjacent fragments
    overlap by most of an insert; at lower coverage the observed
    end-reaching overlaps are shorter, so the gate is set to the 30th
    percentile of candidate overlaps, clamped to
    [MIN_OVER_FLOOR_BASES, MIN_OVER_BASES].

    `device`: where the device glue runs (None: nowhere).  `device_glue`
    None runs it for plain-mode closures of more than
    DEVICE_GLUE_MIN_POSITIONS positions on a CUDA device; True runs it on
    `device` whatever its type (the CPU takes the plain twins); False never.
    The device glue sizes its expansions exactly unless `glue_budgets`
    gives its (candidate, long-pair, union-pair) row budgets; when one of
    those clips real work the host core runs instead (the same partition),
    as the reference's does.  A `mesh` of more than one shard runs the mesh
    glue first (value-sharded when VALUE_SHARD), for plain-mode closures,
    as the reference's; its partition is taken when nothing overflowed.
    `info`, when given, receives glue_route ("mesh", "device",
    "device_overflow" or "host"),
    glue_overflow (the device glue's candidate, long-pair and union-pair
    overflow counts; zeros off the device route) and glue_positions (the
    sanitized closures' positions)."""
    from .inversion import _compact_chains
    from .supergraph import SuperGraph

    adaptive = min_over_bases is None
    if adaptive:
        min_over_bases = MIN_OVER_BASES  # seed-window ceiling; gate set below
    min_over = max(min_over_bases - (K - 1), 1)
    cls = sanitize_closures(bg, closures)
    if not cls:
        from .supergraph import build_supergraph

        return build_supergraph(bg)
    n = len(cls)
    idx = {c: i for i, c in enumerate(cls)}
    inv = bg.inv
    cinv = np.array(
        [idx[tuple(int(inv[e]) for e in reversed(c))] for c in cls], dtype=np.int64
    )
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    kmers = (bg.edges.lengths() - (K - 1)).astype(np.int64)

    # ci: edge -> closure ids touching it (deduped)
    ci: Dict[int, List[int]] = {}
    for i, c in enumerate(cls):
        for e in set(c):
            ci.setdefault(e, []).append(i)

    # boundary node ids: (c, b) -> cstart[c] + b, b in [0, len_c]
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=cstart[1:])

    # caller-supplied boundary unions (merge mode: the source graph's own
    # vertex structure, each group keyed by closure tuple + boundary pos)
    extra_pairs: List[Tuple[int, int]] = []
    if extra_unions:
        for grp in extra_unions:
            ids = [(idx[tuple(int(e) for e in c)], p) for c, p in grp]
            b0 = int(cstart[ids[0][0]] + ids[0][1])
            for c, p in ids[1:]:
                extra_pairs.append((b0, int(cstart[c] + p)))

    # device glue core (parallel/device_nucleate.py: the sort/join/min-label
    # formulation of the same partition) — used on the card for big closure
    # sets; the host core runs instead when a budget given to it overflowed
    plain_mode = (
        not interior_matches and interior_pairs is None and not extra_unions
    )
    if device is not None:
        from ..core.device import resolve_device

        device = resolve_device(device)
    if device_glue is None:
        device_glue = (
            plain_mode
            and device is not None
            and device.type == "cuda"
            and int(lens.sum()) > DEVICE_GLUE_MIN_POSITIONS
        )
    route, overflow = "host", (0, 0, 0)
    if mesh is not None and plain_mode and mesh.size > 1:
        # mesh-sharded glue (parallel/sharded_nucleate.py): identical
        # partition, distributed over the shards
        from ..parallel.sharded_nucleate import glue_closures_sharded

        par, ovf = glue_closures_sharded(
            mesh, bg, cls, int(min_over_bases), adaptive, value_shard=VALUE_SHARD,
        )
        if ovf == 0:
            if info is not None:
                info.update(glue_route="mesh", glue_overflow=overflow,
                            glue_positions=int(lens.sum()))
            return _quotient(bg, cls, cinv, lens, cstart, par, int(cstart[-1]))
    if device_glue and plain_mode:
        if device is None:
            raise ValueError("device_glue=True needs the device it runs on")
        from ..parallel.device_nucleate import glue_closures_device

        ginfo: dict = {}
        par = glue_closures_device(
            bg, cls, int(min_over_bases), adaptive, device, info=ginfo,
            budgets=glue_budgets,
        )
        overflow = ginfo["overflow"]
        route = "device" if par is not None else "device_overflow"
    if info is not None:
        info.update(glue_route=route, glue_overflow=overflow,
                    glue_positions=int(lens.sum()))
    if route == "device":
        return _quotient(bg, cls, cinv, lens, cstart, par, int(cstart[-1]))

    # native glue core (hot loops in C++; bit-identical partition) with a
    # pure-python fallback
    from ..native import load_nucleate

    # merge mode (pair-restricted interior matches) runs the python path:
    # supergraph-scale inputs are small
    lib = None if interior_pairs is not None else load_nucleate()
    if lib is not None:
        vals32 = np.ascontiguousarray(
            np.concatenate([np.asarray(c, np.int32) for c in cls])
        )
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        parent = np.arange(int(cstart[-1]), dtype=np.int64)
        ep = (
            np.ascontiguousarray(np.asarray(extra_pairs, np.int64).reshape(-1))
            if extra_pairs
            else np.zeros(0, np.int64)
        )
        lo = max(MIN_OVER_FLOOR_BASES - (K - 1), 1)
        rc = lib.nucleate_glue(
            vals32, offs, n,
            np.ascontiguousarray(kmers), bg.n_edges,
            np.ascontiguousarray(cinv),
            int(min_over), int(lo),
            int(bool(adaptive)), int(bool(interior_matches)),
            int(_MAX_LONG_PARTNERS),
            ep, len(extra_pairs),
            parent,
        )
        assert rc == 0
        total = int(cstart[-1])
        return _quotient(bg, cls, cinv, lens, cstart, parent, total)

    uf = _UF(int(cstart[-1]))
    for a, b in extra_pairs:
        uf.union(a, b)

    def union_match(c1: int, s1: int, c2: int, s2: int, L: int):
        """Glue boundaries of a length-L edge match + its rc image."""
        b1, b2 = cstart[c1] + s1, cstart[c2] + s2
        for i in range(L + 1):
            uf.union(int(b1 + i), int(b2 + i))
        r1, r2 = int(cinv[c1]), int(cinv[c2])
        rb1 = cstart[r1] + (lens[c1] - (s1 + L))
        rb2 = cstart[r2] + (lens[c2] - (s2 + L))
        for i in range(L + 1):
            uf.union(int(rb1 + i), int(rb2 + i))

    # (a) overlap matches.  Default: end-reaching, seeded at the least-
    # multiplicity edge within the last MIN_OVER kmers of each closure
    # (GetMatches:163-201).  Interior mode: seed at every shared edge and
    # accept any >= MIN_OVER match (MergeShortOverlaps semantics).
    candidates: List[Tuple[int, int, int, int, int, int]] = []
    if interior_matches and interior_pairs is not None:
        # pair-restricted merge mode (MergeShortOverlaps): each candidate
        # pair merges only on a UNIQUE >= gate overlap (FindOverlap,
        # ShortMergers.cc:14-50, allow_two=False)
        seen_pairs = set()
        for ta, tb in interior_pairs:
            i1 = idx.get(tuple(int(e) for e in ta))
            i2 = idx.get(tuple(int(e) for e in tb))
            if i1 is None or i2 is None or i1 == i2:
                continue
            if (i1, i2) in seen_pairs:
                continue
            seen_pairs.add((i1, i2))
            x1, x2 = cls[i1], cls[i2]
            by_off: Dict[int, Tuple[int, int, int, int]] = {}
            for j1, e in enumerate(x1):
                for j2, e2 in enumerate(x2):
                    if e2 != e or (j1 - j2) in by_off:
                        continue
                    s1, s2, L = _extend(x1, x2, j1, j2)
                    over = int(kmers[list(x1[s1 : s1 + L])].sum())
                    by_off[j1 - j2] = (s1, s2, L, over)
            good = [m for m in by_off.values() if m[3] >= min_over]
            if len(good) != 1:
                continue  # none, or ambiguous placement — skip the pair
            s1, s2, L, _ = good[0]
            union_match(i1, s1, i2, s2, L)
        interior_iter = []
    else:
        interior_iter = list(enumerate(cls))
    for i1, x1 in interior_iter:
        if interior_matches:
            first: Dict[int, int] = {}
            for j, e in enumerate(x1):
                first.setdefault(e, j)
            seeds = [(j, e) for e, j in first.items()]
        else:
            nk, b, best = 0, -1, 1 << 60
            for j in range(len(x1) - 1, -1, -1):
                m = len(ci[x1[j]])
                if m < best:
                    best, b = m, j
                nk += int(kmers[x1[j]])
                if nk >= min_over:
                    break
            seeds = [(b, x1[b])]
        done: set = set()
        for b, seed in seeds:
            for i2 in ci[seed]:
                if i2 == i1:
                    continue
                x2 = cls[i2]
                for j2, e2 in enumerate(x2):
                    if e2 != seed or (i2, b - j2) in done:
                        continue
                    s1, s2, L = _extend(x1, x2, b, j2)
                    if not interior_matches:
                        if s1 + L < len(x1):  # must reach x1's end
                            continue
                        if s1 > 0 and s2 > 0:  # must reach one closure's start
                            continue
                    over = int(kmers[list(x1[s1 : s1 + L])].sum())
                    done.add((i2, b - j2))
                    candidates.append((i1, s1, i2, s2, L, over))

    # adaptive gate: 30th-percentile order statistic of candidate overlaps,
    # clamped (same definition as the native core)
    if adaptive and candidates:
        overs = np.sort(np.array([c[-1] for c in candidates], dtype=np.int64))
        lo = max(MIN_OVER_FLOOR_BASES - (K - 1), 1)
        p30 = int(overs[int(0.30 * (len(overs) - 1))])
        min_over = int(np.clip(p30, lo, min_over))
    global _LAST_GATE, _LAST_CANDIDATES  # debug introspection (tests)
    _LAST_GATE = min_over
    _LAST_CANDIDATES = list(candidates)
    for i1, s1, i2, s2, L, over in candidates:
        if over >= min_over:
            union_match(i1, s1, i2, s2, L)

    # (b) long-edge matches: positions sharing a >= MIN_OVER-kmer edge
    for e, cids in ci.items():
        if kmers[e] < min_over:
            continue
        Q = [
            (c, m) for c in cids for m, ee in enumerate(cls[c]) if ee == e
        ]
        if len(Q) <= 1:
            continue
        for a in range(len(Q)):
            c1, m1 = Q[a]
            for bq in range(a + 1, len(Q)):
                c2, m2 = Q[bq]
                if bq - a <= _MAX_LONG_PARTNERS:
                    s1, s2, L = _extend(cls[c1], cls[c2], m1, m2)
                    union_match(c1, s1, c2, s2, L)
                else:
                    union_match(c1, m1, c2, m2, 1)

    # Zipper (10X/Super.cc:2297): glued boundaries whose continuations carry
    # the same base edge glue their next boundaries too — deterministic
    # label-propagation that collapses unglued duplicate paths.  Forward and
    # backward passes keep the involution symmetric (the rc image of a
    # forward zip is a backward zip).
    total = int(cstart[-1])
    inst_c0 = np.repeat(np.arange(n, dtype=np.int64), lens)
    inst_j0 = (
        np.concatenate([np.arange(l, dtype=np.int64) for l in lens])
        if n
        else np.zeros(0, np.int64)
    )
    labels0 = np.concatenate([np.asarray(c, dtype=np.int64) for c in cls])
    bl = cstart[inst_c0] + inst_j0
    br = bl + 1

    def _compress(par):
        while True:
            pp = par[par]
            if np.array_equal(pp, par):
                return par
            par = pp

    for _ in range(200):
        parent = _compress(uf.parent.copy())
        changed = False
        for heads, tails in ((parent[bl], parent[br]), (parent[br], parent[bl])):
            key = heads * np.int64(bg.n_edges + 1) + labels0
            order = np.argsort(key, kind="stable")
            k = key[order]
            t = tails[order]
            same = k[1:] == k[:-1]
            diff = t[1:] != t[:-1]
            for i in np.nonzero(same & diff)[0]:
                uf.union(int(t[i]), int(t[i + 1]))
                changed = True
        if not changed:
            break

    # quotient: boundary classes (full path compression)
    parent = _compress(uf.parent)
    return _quotient(bg, cls, cinv, lens, cstart, parent, total)


def _quotient(bg, cls, cinv, lens, cstart, parent, total):
    """Boundary classes -> D0 edge instances -> Vectorify -> SuperGraph."""
    from .inversion import _compact_chains
    from .supergraph import SuperGraph

    n = len(cls)
    inv = bg.inv
    # edge instances -> deduped D0 edges keyed on (class_l, class_r, edge)
    inst_c = np.repeat(np.arange(n, dtype=np.int64), lens)
    inst_j = np.concatenate([np.arange(l, dtype=np.int64) for l in lens]) if n else np.zeros(0, np.int64)
    left = parent[cstart[inst_c] + inst_j]
    right = parent[cstart[inst_c] + inst_j + 1]
    labels = np.concatenate([np.asarray(c, dtype=np.int64) for c in cls])
    # two-level key to stay within int64: compact (left,right) pair ids first
    pair = left * np.int64(total + 1) + right
    uniq_pair, pair_id = np.unique(pair, return_inverse=True)
    key = pair_id.astype(np.int64) * np.int64(bg.n_edges) + labels
    uniq_key, first_idx, inst_e0 = np.unique(key, return_index=True, return_inverse=True)
    ne0 = len(uniq_key)
    from0 = left[first_idx]
    to0 = right[first_idx]
    label0 = labels[first_idx]

    # involution on D0 edges via rc instances
    rc_c = cinv[inst_c]
    rc_j = lens[inst_c] - 1 - inst_j
    rc_left = parent[cstart[rc_c] + rc_j]
    rc_right = parent[cstart[rc_c] + rc_j + 1]
    rc_pair = rc_left * np.int64(total + 1) + rc_right
    rc_pair_id = np.searchsorted(uniq_pair, rc_pair)
    assert (uniq_pair[rc_pair_id] == rc_pair).all(), "rc boundary pair missing"
    rc_key = rc_pair_id.astype(np.int64) * np.int64(bg.n_edges) + inv[labels]
    rc_e0 = np.searchsorted(uniq_key, rc_key)
    assert (uniq_key[rc_e0] == rc_key).all(), "involution image missing"
    dinv0 = np.full(ne0, -1, dtype=np.int64)
    dinv0[inst_e0] = rc_e0
    assert np.array_equal(dinv0[dinv0], np.arange(ne0)), "dinv0 not an involution"

    # Vectorify: compact unbranched chains of D0 into D (vertex ids
    # compacted first — boundary-class ids are sparse)
    used0 = np.unique(np.concatenate([from0, to0]))
    from0 = np.searchsorted(used0, from0)
    to0 = np.searchsorted(used0, to0)
    chains = _compact_chains(
        ne0, np.arange(ne0, dtype=np.int64), from0, to0, len(used0)
    )
    paths: List[np.ndarray] = []
    new_of_old = np.full(ne0, -1, dtype=np.int64)
    for chain in chains:
        d = len(paths)
        for od in chain:
            new_of_old[od] = d
        paths.append(label0[chain])
    nd = len(paths)
    dinv = np.zeros(nd, dtype=np.int64)
    for d, chain in enumerate(chains):
        dinv[d] = new_of_old[int(dinv0[int(chain[-1])])]
    from_v = np.array([from0[c[0]] for c in chains], dtype=np.int64)
    to_v = np.array([to0[c[-1]] for c in chains], dtype=np.int64)
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
        bg=bg,
    )
