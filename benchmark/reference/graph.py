"""The plain reference of the unipath graph over a kmer table.

Oriented node u = 2 * row + d: the table's kmer (d = 0) or its reverse
complement (d = 1).  A node's out mask is the right mask (d = 0) or the
left mask turned over (d = 1), its in mask the other one.  Node u links to
v when u has exactly one out base, the kmer it leads to is in the table
as node v (v = 2 * row + 1 where that kmer's reverse complement is its
canonical form), v has exactly one in base, and v != u.  Links make
chains; a cycle is cut before its smallest node id.  Each chain is an edge,
numbered in the order of its first node's id, holding its nodes at
positions 0, 1, ...  Two edges are adjacent where the last 47 bases of the
first equal the first 47 bases of the second.
"""
from __future__ import annotations

import math

import torch

from .kmers import canonical, lookup, rev_comp, successor

MASK46 = (1 << 46) - 1


def _turn(mask):
    """A base mask of the reverse complement: bit b -> bit 3 - b."""
    return ((mask & 1) << 3) | ((mask & 2) << 1) | ((mask & 4) >> 1) | ((mask & 8) >> 3)


def _ones(mask):
    return (mask & 1) + ((mask >> 1) & 1) + ((mask >> 2) & 1) + ((mask >> 3) & 1)


def unipaths(t: dict) -> dict:
    """t: a kmer table (count.count_table) -> node_edge, node_pos (2n,),
    edge_kmers, from_hi, from_lo, to_hi, to_lo (per edge: the first and last
    47 bases as 24 + 23-base halves), n_edges."""
    hi, lo = t["hi"], t["lo"]
    n = hi.shape[0]
    dev = hi.device
    rhi, rlo = rev_comp(hi, lo)
    u = torch.arange(2 * n, device=dev)
    fwd = (u & 1) == 0
    row = u >> 1
    ohi = torch.where(fwd, hi[row], rhi[row])
    olo = torch.where(fwd, lo[row], rlo[row])
    out_mask = torch.where(fwd, t["rm"][row], _turn(t["lm"][row]))
    in_mask = torch.where(fwd, t["lm"][row], _turn(t["rm"][row]))
    single = _ones(out_mask) == 1
    b = (out_mask == 2).long() + 2 * (out_mask == 4).long() + 3 * (out_mask == 8).long()
    shi, slo = successor(ohi, olo, b)
    srhi, srlo = rev_comp(shi, slo)
    chi, clo, flip = canonical(shi, slo, srhi, srlo)
    srow, found = lookup(hi, lo, chi, clo)
    v = 2 * srow + flip.long()
    link = single & found & (_ones(in_mask[v]) == 1) & (v != u)
    nxt = torch.where(link, v, -1)
    prv = torch.full_like(u, -1)
    prv[nxt[link]] = u[link]

    steps = math.ceil(math.log2(max(2 * n, 2))) + 1
    # cut each cycle before its smallest node
    top, low = torch.where(prv >= 0, prv, u), u.clone()
    for _ in range(steps):
        low = torch.minimum(low, low[top])
        top = top[top]
    cyclic = prv[top] >= 0
    prv = torch.where(cyclic & (u == low), -1, prv)
    # each node's chain head and its distance from it
    top = torch.where(prv >= 0, prv, u)
    dist = (prv >= 0).long()
    for _ in range(steps):
        dist = dist + dist[top]
        top = top[top]

    heads = torch.nonzero(prv < 0).squeeze(1)  # ascending node ids
    edge_of_head = torch.full_like(u, -1)
    edge_of_head[heads] = torch.arange(heads.shape[0], device=dev)
    node_edge = edge_of_head[top]
    n_edges = heads.shape[0]
    edge_kmers = torch.zeros(n_edges, dtype=torch.int64, device=dev).index_add_(
        0, node_edge, torch.ones_like(node_edge))
    last = dist == edge_kmers[node_edge] - 1
    tail = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    tail[node_edge[last]] = u[last]
    # 47-base keys: bases 0..46 of the head, bases 1..47 of the tail
    hh, hl = ohi[heads], olo[heads]
    th, tl = ohi[tail], olo[tail]
    return dict(
        node_edge=node_edge, node_pos=dist, edge_kmers=edge_kmers, n_edges=n_edges,
        from_hi=hh, from_lo=hl >> 2,
        to_hi=((th << 2) & ((1 << 48) - 1)) | (tl >> 46), to_lo=tl & MASK46,
    )
