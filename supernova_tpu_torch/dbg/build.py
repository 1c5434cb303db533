"""De Bruijn graph construction + unipath compaction on torch tensors
(port of supernova_tpu/dbg/build.py).

The oriented kmer nodes (canonical row r, direction d -> node 2r+d) get a
functional successor map next[u] (unique out-extension whose target has a
unique in-extension); cycles are broken at their minimum node id and the
maximal chains are ranked by pointer doubling.  Edge sequences, vertices
(47-mer junctions) and the rc involution are then materialized with sorts,
cumsums and scatters.

The successor resolve joins the table with all 2M oriented nodes at once
when the card's free memory holds that join, else in chunks of nodes (the
reference's LINK_BLOCK_NODES loop), sized by link_chunk_rows: the table
comes from the blocked count and can hold any genome's kmers.  Left out, as TPU workarounds: the
e_pad/flat_pad compile buckets (arrays here have their true sizes) and the
host ranking twin that existed because of a TPU worker crash.
`trim_table` keeps the reference's geometric-ladder row count: it fixes
the byte layout of kmers.npz and graph.npz.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..kmer import count as kcount
from ..kmer.count import KmerTable, rev4
from ..ops import segments as seg


def popcount4(mask):
    return (mask & 1) + ((mask >> 1) & 1) + ((mask >> 2) & 1) + ((mask >> 3) & 1)


def single_bit_index(mask):
    """bit index of a one-hot 4-bit mask (0 otherwise)."""
    return (mask == 2).long() * 1 + (mask == 4).long() * 2 + (mask == 8).long() * 3


class Links(NamedTuple):
    next: torch.Tensor  # (2M,) int64 successor node or -1
    prev: torch.Tensor  # (2M,) int64 predecessor node or -1 (cycles broken)
    head: torch.Tensor  # (2M,) int64 chain head node
    dist: torch.Tensor  # (2M,) int64 rank within chain (head = 0)


def oriented_words(table_words: W3, node_ids) -> W3:
    """Node id u = 2*row + d  ->  kmer words in the node's orientation."""
    w = table_words.gather(node_ids >> 1)
    return kc.rc_words(w).where((node_ids & 1) == 1, w)


def _node_masks(table: KmerTable, u):
    """(in_mask, out_mask) of oriented nodes u."""
    row, d = u >> 1, u & 1
    lmask = table.left_mask[row].long()
    rmask = table.right_mask[row].long()
    fwd = d == 0
    return torch.where(fwd, lmask, rev4(rmask)), torch.where(fwd, rmask, rev4(lmask))


def _indeg8(table: KmerTable):
    """(2M,) uint8 in-degree of every oriented node."""
    m = table.words.a.shape[0]
    u = torch.arange(2 * m, device=table.words.a.device)
    return popcount4(_node_masks(table, u)[0]).to(torch.uint8)


def _links_block(table: KmerTable, indeg8, u):
    """Successor of each oriented node in u: its unique out-extension, if
    the target has a unique in-extension.  -1 otherwise."""
    _, out_mask = _node_masks(table, u)
    succ = kc.successor_words(oriented_words(table.words, u), single_bit_index(out_mask))
    canon, flip = kc.canonicalize(succ)
    srow, found = kc.lookup_words_merge(table.words, canon)
    v = 2 * srow + flip.long()
    link_ok = (
        (popcount4(out_mask) == 1) & found & (indeg8[torch.where(found, v, 0)] == 1) & (v != u)
    )
    return torch.where(link_ok, v, -1)


def _rank_links(nxt) -> Links:
    """Cycle-broken list ranking over the successor map by pointer doubling."""
    n2 = nxt.shape[0]
    u = torch.arange(n2, device=nxt.device)
    link_ok = nxt >= 0
    prv = torch.full_like(nxt, -1)
    prv[nxt[link_ok]] = u[link_ok]  # unique targets: in-degree-1 rule
    steps = int(math.ceil(math.log2(max(n2, 2)))) + 1

    # cycle detection + break at the cycle's minimum node
    ptr = torch.where(prv >= 0, prv, u)
    mn = u
    for _ in range(steps):
        ptr, mn = ptr[ptr], torch.minimum(mn, mn[ptr])
    in_cycle = prv[ptr] >= 0
    prv = torch.where(in_cycle & (u == mn), -1, prv)

    # distance to head by pointer doubling
    ptr = torch.where(prv >= 0, prv, u)
    dist = (prv >= 0).long()
    for _ in range(steps):
        ptr, dist = ptr[ptr], dist + dist[ptr]
    return Links(nxt, prv, ptr, dist)


# peak device bytes per joined row (table + chunk of oriented nodes) of
# build_links, the ranking after the joins included: 178.8 measured on an
# H100 80GB HBM3 (700 W) by chip_smoke.py's graph-chunks phase for one join
# of all nodes (the costliest per row; 165.8 for two chunks), rounded up
LINK_BYTES_PER_ROW = 192


def link_chunk_rows(device: torch.device, m: int) -> int:
    """Oriented nodes a successor-resolve join takes beside the m table
    rows: all 2m when table + nodes fit the card's free memory at
    LINK_BYTES_PER_ROW, else what fits (at least 2^20).  The CPU (the
    tests' device) sets no limit."""
    n = max(2 * m, 1)
    if device.type != "cuda":
        return n
    return min(n, max(1 << 20, kcount.free_device_bytes(device) // LINK_BYTES_PER_ROW - m))


def build_links(table: KmerTable, chunk: int | None = None) -> Links:
    """Successor/predecessor maps + cycle-broken list ranking.  The
    successors of the 2m oriented nodes resolve `chunk` nodes at a time
    (link_chunk_rows by default), each chunk one join of the table plus the
    chunk."""
    m = table.words.a.shape[0]
    dev = table.words.a.device
    chunk = chunk or link_chunk_rows(dev, m)
    indeg8 = _indeg8(table)
    nxt = torch.cat([
        _links_block(table, indeg8, torch.arange(s, min(s + chunk, 2 * m), device=dev))
        for s in range(0, 2 * m, chunk)
    ])
    return _rank_links(nxt)


def _edge_count(links: Links, n_valid_rows: int) -> int:
    u = torch.arange(links.prev.shape[0], device=links.prev.device)
    return int(((links.prev == -1) & ((u >> 1) < n_valid_rows)).sum())


class DeviceGraph(NamedTuple):
    """The unipath graph as tensors (HyperBasevector analogue), true sizes."""

    edge_codes: torch.Tensor  # (FLAT,) int64 flat edge base codes
    edge_offsets: torch.Tensor  # (E+1,) int64 CSR
    inv: torch.Tensor  # (E,) int64 rc-twin edge
    is_circle: torch.Tensor  # (E,) bool
    from_v: torch.Tensor  # (E,) int64
    to_v: torch.Tensor  # (E,) int64
    n_vertices: int
    node_edge: torch.Tensor  # (2M,) int64 edge containing oriented node
    node_pos: torch.Tensor  # (2M,) int64 kmer offset of node within edge
    n_edges: int


def materialize_edges(table: KmerTable, links: Links, n_edges: int) -> DeviceGraph:
    """Edge sequences, involution, vertices and the node -> (edge, pos) map."""
    dev = links.head.device
    n2 = links.head.shape[0]

    # nodes by (head, dist): chains contiguous, valid chains first (invalid
    # rows sit at the table tail, so their node/head ids are larger)
    us = kc.lex_argsort(links.head, links.dist)
    ds = links.dist[us]
    starts = ds == 0
    eid = torch.cumsum(starts.long(), 0) - 1  # edge id per sorted node
    in_edge = eid < n_edges

    w = torch.where(starts, K, 1) * in_edge.long()
    out_pos = torch.cumsum(w, 0) - w
    flat = int(w.sum())

    # last base of every chain node; the head node also spells bases 0..K-2
    codes = torch.zeros(flat, dtype=torch.int64, device=dev)
    lb_pos = out_pos + (K - 1) * starts.long()
    codes[lb_pos[in_edge]] = kc.last_base(oriented_words(table.words, us[in_edge]))
    is_head = starts & in_edge
    head_node = us[is_head]  # edge order: heads are sorted by edge id
    e_start = out_pos[is_head]
    bases = kc.unpack_bases(oriented_words(table.words, head_node))[:, : K - 1]
    codes[e_start[:, None] + torch.arange(K - 1, device=dev)[None, :]] = bases
    edge_offsets = torch.cat([e_start, torch.tensor([flat], device=dev)])

    last_in_seg = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    tail_node = us[last_in_seg & in_edge]

    node_edge = torch.full((n2,), -1, dtype=torch.int64, device=dev)
    node_edge[us] = torch.where(in_edge, eid, -1)
    node_pos = torch.zeros(n2, dtype=torch.int64, device=dev)
    node_pos[us] = ds

    inv = node_edge[head_node ^ 1]
    is_circle = links.next[tail_node] >= 0

    # vertices: 47-mer junction keys ("47 bases + trailing 0" word format)
    hw = oriented_words(table.words, head_node)
    from_key = W3(hw.a, hw.b, hw.c & 0xFFFFFFFC)
    to_key = kc.successor_words(oriented_words(table.words, tail_node), 0)
    both = W3(*(torch.cat([f, t]) for f, t in zip(from_key, to_key)))
    vsort, _, _ = kc.sort_by_words(both)
    vstarts = seg.run_starts(vsort.a, vsort.b, vsort.c)
    n_vertices = int((vstarts & ~kc.is_sentinel(vsort)).sum())
    vid_of_sorted = torch.cumsum(vstarts.long(), 0) - 1
    fpos, _ = kc.searchsorted_words(vsort, from_key)
    tpos, _ = kc.searchsorted_words(vsort, to_key)
    return DeviceGraph(
        codes, edge_offsets, inv, is_circle, vid_of_sorted[fpos],
        vid_of_sorted[tpos], n_vertices, node_edge, node_pos, n_edges,
    )


def geom_bucket(n: int, quantum: int = 1024, ratio: float = 1.25) -> int:
    """Round n up to the reference's geometric ladder (quantum,
    ~quantum*ratio^k): the table row count of kmers.npz/graph.npz."""
    m = quantum
    while m < n:
        m = -(-int(m * ratio) // quantum) * quantum
    return m


def trim_table(table: KmerTable, pad_multiple: int = 1024) -> KmerTable:
    """Repack the table to the geometric-ladder row count (the count pads
    it to the occurrence row count)."""
    n = int(table.n_valid)
    m = geom_bucket(max(n, 1), pad_multiple)
    dev = table.count.device

    def words(x):
        out = torch.full((m,), kc.SENTINEL, dtype=torch.int64, device=dev)
        out[:n] = x[:n]
        return out

    def sl(a):
        a = a[:m]
        if a.shape[0] < m:  # incoming table may be padded coarser OR finer
            a = torch.cat([a, torch.zeros(m - a.shape[0], dtype=a.dtype, device=dev)])
        return a.contiguous()

    return KmerTable(
        W3(*(words(x) for x in table.words)),
        sl(table.count), sl(table.nbc), sl(table.left_mask), sl(table.right_mask),
        torch.tensor(n, dtype=torch.int64, device=dev),
    )


def build_graph(table: KmerTable) -> DeviceGraph:
    """Trimmed KmerTable -> DeviceGraph."""
    links = build_links(table)
    return materialize_edges(table, links, _edge_count(links, int(table.n_valid)))
