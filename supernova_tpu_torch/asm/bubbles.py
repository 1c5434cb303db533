"""Bubble cleanup on the supergraph: flatten lopsided bubbles.

The port's own copy of supernova_tpu/asm/bubbles.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of FlattenSomeBubbles / DelWeak / 3:0-bubble deletion
(10X/Super.h:37-40, CP.cc:1692-1794): when one arm of a simple bubble has
strong read support and the other essentially none, the weak arm is a
sequencing-error artifact, not a het site — delete it (and its rc twin).
"""
from __future__ import annotations

from typing import List

import numpy as np

STRONG = 3  # reference's 3:0 rule (CP.cc:1746-1794)


def find_lopsided_bubbles(
    D, support: np.ndarray, strong: int = STRONG
) -> List[int]:
    """-> D-edge ids of weak arms to delete (involution-symmetric)."""
    # simple bubbles: pairs of edges with identical endpoints
    from collections import defaultdict

    groups = defaultdict(list)
    for d in range(D.n_edges):
        groups[(int(D.from_v[d]), int(D.to_v[d]))].append(d)
    drop = set()
    for (v, w), arms in groups.items():
        if len(arms) != 2 or v == w:
            continue
        a, b = arms
        sa, sb = support[a], support[b]
        if sa >= strong and sb == 0:
            drop.add(b)
        elif sb >= strong and sa == 0:
            drop.add(a)
    # involution symmetry
    out = set()
    for d in drop:
        out.add(d)
        out.add(int(D.dinv[d]))
    return sorted(out)


def flatten_bubbles(bg, keep_base: np.ndarray, D, support: np.ndarray):
    """Delete weak arms from the BASE graph keep-mask and rebuild D.
    Returns (new keep mask, n_flattened)."""
    weak = find_lopsided_bubbles(D, support)
    if not weak:
        return keep_base, 0
    keep = keep_base.copy()
    for d in weak:
        for e in D.epaths.row(d):
            keep[int(e)] = False
            keep[int(bg.inv[int(e)])] = False
    if not keep.any():
        return keep_base, 0
    return keep, len(weak)
