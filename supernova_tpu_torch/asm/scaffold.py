"""Barcode-link scaffolding: order lines into scaffolds across gaps.

The port's own copy of supernova_tpu/asm/scaffold.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of AllTinksCore barcode-link triples (SecretOps.cc:807-867: pairs of
edges sharing >= 4 barcodes among "good" barcodes) + ScaffoldLowMem
(10X/Scaffold.cc:534: orient & join lines via barcode-set overlaps) + Star's
advantage-gated joins (10X/Star.cc MIN_ADVANTAGE) with {-2} barcode-only gap
edges (10X/Gap.h:16-47).

v1 limitations (tracked for later rounds): orientation is inferred only from
rc-pair symmetry, not from barcode positional regression (LineOO/BarcodePos),
and gap sizes use a fixed estimate instead of Gaprika's lbpx model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

GOOD_BC_MIN_READS = 1  # reference: barcodes with 100-10000 reads are "good"
GOOD_BC_MAX_READS = 10_000
MIN_SHARED_BC = 4  # SecretOps.cc AllTinks min shared barcodes
ADVANTAGE = 2.0  # best link must beat runner-up by this factor (Star-lite)
DEFAULT_GAP_N = 100  # {-2} gap placeholder size


@dataclass
class Scaffold:
    line_ids: List[int]  # lines walked forward, in order
    gaps: List[int]  # gap sizes between consecutive lines (len-1)
    fills: List | None = None  # per-gap sequence fills (Stackaroo), or None


def good_barcodes(read_bc: np.ndarray) -> np.ndarray:
    """Barcodes within the good read-count envelope (SecretOps.cc:807)."""
    bc = read_bc[read_bc > 0]
    counts = np.bincount(bc)
    ids = np.nonzero(
        (counts >= GOOD_BC_MIN_READS) & (counts <= GOOD_BC_MAX_READS)
    )[0]
    return ids[ids > 0]


def line_barcode_sets(lines, line_bc_edges: List[np.ndarray], good: np.ndarray):
    """Per-line barcode set (restricted to good barcodes)."""
    gset = set(good.tolist())
    out = []
    for bcs in line_bc_edges:
        out.append(np.array(sorted(set(bcs.tolist()) & gset), dtype=np.int64))
    return out


def shared_count(a: np.ndarray, b: np.ndarray) -> int:
    return len(np.intersect1d(a, b, assume_unique=True))


def scaffold_lines(
    lines,
    line_bcs: List[np.ndarray],
    line_lens: np.ndarray,
    min_shared: int | None = None,  # None -> MIN_SHARED_BC (addin-able)
    min_line_len: int = 1,
    line_positions: Dict[int, Dict[int, list]] | None = None,
) -> List[Scaffold]:
    """Greedy mutual-best joining of canonical lines by shared-barcode count.
    min_shared=None reads MIN_SHARED_BC at call time.

    Works on one representative per rc pair; emits scaffolds as ordered line
    lists with {-2}-style gaps."""
    if min_shared is None:
        min_shared = MIN_SHARED_BC
    n = lines.n_lines
    canon = [i for i in range(n) if i <= lines.linv[i] and line_lens[i] >= min_line_len]
    # candidate links via the sparse barcode-pair join (AllTinks engine;
    # the mesh-sharded device variant is parallel/sharded_scaffold.py)
    from .links import incidence_from_sets, link_triples_np, links_as_dict

    with_bc = [i for i in canon if len(line_bcs[i])]
    bcv, item = incidence_from_sets([line_bcs[i] for i in with_bc], with_bc)
    links = links_as_dict(*link_triples_np(bcv, item, min_shared=min_shared))

    # best + runner-up per line for the advantage gate
    best: Dict[int, Tuple[int, int]] = {}
    second: Dict[int, int] = {}
    for (i, j), s in links.items():
        for a, b in ((i, j), (j, i)):
            if a not in best or s > best[a][1]:
                if a in best:
                    second[a] = best[a][1]
                best[a] = (b, s)
            elif s > second.get(a, 0):
                second[a] = s

    joins = []
    for (i, j), s in sorted(links.items(), key=lambda kv: -kv[1]):
        if best.get(i, (None, 0))[0] == j and best.get(j, (None, 0))[0] == i:
            if s >= ADVANTAGE * max(second.get(i, 0), second.get(j, 0), 1):
                joins.append((i, j, s))

    # union-find chains (each line joins at most twice: left+right neighbor)
    neighbor: Dict[int, List[int]] = {i: [] for i in canon}
    for i, j, s in joins:
        if len(neighbor[i]) < 2 and len(neighbor[j]) < 2:
            # avoid cycles
            if _reaches(neighbor, j, i):
                continue
            neighbor[i].append(j)
            neighbor[j].append(i)

    scaffolds: List[Scaffold] = []
    seen = set()
    for i in canon:
        if i in seen or len(neighbor[i]) > 1:
            continue
        chain = [i]
        seen.add(i)
        prev, cur = None, i
        while True:
            nxts = [x for x in neighbor[cur] if x != prev]
            if not nxts:
                break
            prev, cur = cur, nxts[0]
            chain.append(cur)
            seen.add(cur)
        # orient each join from molecule position gradients (LineOO-style)
        if line_positions is not None and len(chain) > 1:
            oriented = [chain[0]]
            for k in range(1, len(chain)):
                a = oriented[-1]
                b = chain[k]
                fixed = k > 1  # a's orientation already committed
                best = None
                a_opts = (a,) if fixed else (a, int(lines.linv[a]))
                for ao in a_opts:
                    for bo in (b, int(lines.linv[b])):
                        pa = line_positions.get(ao, {})
                        pb = line_positions.get(bo, {})
                        t, n = junction_tightness(pa, pb, int(line_lens[ao]))
                        if n >= 2 and (best is None or t < best[0]):
                            best = (t, ao, bo)
                if best is not None:
                    _, ao, bo = best
                    oriented[-1] = ao
                    oriented.append(bo)
                else:
                    oriented.append(b)
            chain = oriented
        scaffolds.append(Scaffold(chain, [DEFAULT_GAP_N] * (len(chain) - 1)))
    # isolated lines already covered (len-1 chains)
    return scaffolds


def junction_tightness(
    pos_a: dict, pos_b: dict, len_a: int
) -> Tuple[float, int]:
    """Tightness of joining line a's END to line b's START, from shared
    barcodes' molecule positions (LineOO/BarcodePos-style evidence):
    median over shared barcodes of (len_a - max_pos_on_a) + min_pos_on_b.
    Returns (tightness, n_shared); smaller = better supported junction."""
    shared = pos_a.keys() & pos_b.keys()
    if not shared:
        return float("inf"), 0
    vals = [
        (len_a - max(pos_a[bc])) + min(pos_b[bc]) for bc in shared
    ]
    return float(np.median(vals)), len(shared)


def orient_join(
    a: int,
    b: int,
    lines,
    line_positions: Dict[int, Dict[int, list]],
    line_lens: np.ndarray,
) -> Tuple[int, int, float] | None:
    """Pick the best of the four orientation combos for joining lines a, b
    (each may be walked as itself or its rc twin linv).  Returns
    (a_oriented, b_oriented, tightness) or None if no positional evidence.

    Positions on the rc twin ARE the twin line's own coordinates, so each
    combo just swaps in the twin's position map and length."""
    linv = lines.linv
    cands = []
    for ao in (a, int(linv[a])):
        for bo in (b, int(linv[b])):
            pa = line_positions.get(ao, {})
            pb = line_positions.get(bo, {})
            t, n = junction_tightness(pa, pb, int(line_lens[ao]))
            if n >= 2:
                cands.append((t, ao, bo))
    if not cands:
        return None
    t, ao, bo = min(cands)
    return ao, bo, t


def _reaches(neighbor, start, target, limit=10_000):
    seen = {start}
    stack = [start]
    while stack and len(seen) < limit:
        x = stack.pop()
        if x == target:
            return True
        for y in neighbor[x]:
            if y not in seen:
                seen.add(y)
                stack.append(y)
    return False
