"""The plain reference of read pathing: each read as a run of unipath edges.

For every read, every 48-mer (no quality trim) is looked up in the table;
a hit on canonical row r, flipped or not, is oriented node 2r + flip, at
edge e and position q of it.  Hits in read order open slots: a hit joins
the open slot when the previous hit of the read is on the same edge and
q - p (p: the hit's place in the read) is within JITTER of the previous
hit's.  A slot holds its edge, p and q of its first hit, and its hits;
MAX_PATH slots at most are kept, and a read with more is flagged
overflow.  Slot s + 1 continues slot s when edge s ends where edge s + 1
starts and the read places edge s + 1's start within JITTER of edge s's
start plus its kmers.  The path is the continued run of slots with the
most hits, the earliest ending on ties: its edges, its length, offset =
q - p of its first slot's first hit and first_skip = that p.  A read with
no hit has length 0, offset 0 and first_skip 0.
"""
from __future__ import annotations

import torch

from .kmers import K, MASK48, canonical, halves_at, lookup

MAX_PATH = 12
JITTER = 3


def path_reads(codes, offsets, t: dict, gr: dict, lo_mask: int = MASK48,
               chunk_reads: int = 1 << 19) -> dict:
    """Reads (flat codes, offsets) against table t and its unipaths gr ->
    edges (n_reads, MAX_PATH), path_len, offset, first_skip, overflow.
    lo_mask: the control's shortened lookup key (kmers.lookup)."""
    dev = codes.device
    codes = codes.long()
    offsets = offsets.long()
    n_reads = offsets.shape[0] - 1
    parts = []
    for r0 in range(0, n_reads, chunk_reads):
        r1 = min(n_reads, r0 + chunk_reads)
        parts.append(_path_chunk(codes, offsets[r0 : r1 + 1], t, gr, lo_mask))
    if not parts:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return dict(edges=z.reshape(0, MAX_PATH), path_len=z, offset=z, first_skip=z,
                    overflow=z.bool())
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _path_chunk(codes, offsets, t, gr, lo_mask):
    dev = codes.device
    nr = offsets.shape[0] - 1
    lens = offsets[1:] - offsets[:-1]
    nq = (lens - K + 1).clamp(min=0)
    total = int(nq.sum())
    read = torch.repeat_interleave(torch.arange(nr, device=dev), nq, output_size=total)
    p = torch.arange(total, device=dev) - (torch.cumsum(nq, 0) - nq)[read]
    at = offsets[read] + p
    hi, lo = halves_at(codes, at)
    rhi, rlo = halves_at(codes, at, rc=True)
    chi, clo, flip = canonical(hi, lo, rhi, rlo)
    del hi, lo, rhi, rlo, at
    row, found = lookup(t["hi"], t["lo"], chi, clo, lo_mask)
    del chi, clo
    hit = torch.nonzero(found).squeeze(1)  # read order
    node = 2 * row[hit] + flip[hit].long()
    he = gr["node_edge"][node]
    hq = gr["node_pos"][node]
    hr, hp = read[hit], p[hit]
    hd = hq - hp

    # slots
    h = hit.shape[0]
    joins = torch.zeros(h, dtype=torch.bool, device=dev)
    joins[1:] = (hr[1:] == hr[:-1]) & (he[1:] == he[:-1]) & ((hd[1:] - hd[:-1]).abs() <= JITTER)
    opens = ~joins
    n_slots = torch.zeros(nr, dtype=torch.int64, device=dev).index_add_(0, hr, opens.long())
    before = torch.cumsum(n_slots, 0) - n_slots  # slots of earlier reads
    slot = torch.cumsum(opens.long(), 0) - 1 - before[hr]
    kept = slot < MAX_PATH
    flat = hr * MAX_PATH + slot
    cells = nr * MAX_PATH
    s_edge = torch.full((cells,), -1, dtype=torch.int64, device=dev)
    s_p = torch.zeros(cells, dtype=torch.int64, device=dev)
    s_q = torch.zeros(cells, dtype=torch.int64, device=dev)
    first = opens & kept
    s_edge[flat[first]] = he[first]
    s_p[flat[first]] = hp[first]
    s_q[flat[first]] = hq[first]
    s_hits = torch.zeros(cells, dtype=torch.int64, device=dev).index_add_(
        0, flat[kept], torch.ones_like(flat[kept]))
    s_edge, s_p, s_q, s_hits = (x.reshape(nr, MAX_PATH) for x in (s_edge, s_p, s_q, s_hits))

    # the best continued run of slots
    col = torch.arange(MAX_PATH, device=dev)
    live = col[None, :] < n_slots.clamp(max=MAX_PATH)[:, None]
    e = s_edge.clamp(min=0)
    start = s_p - s_q  # where each slot's edge starts in read coordinates
    touch = (gr["to_hi"][e[:, :-1]] == gr["from_hi"][e[:, 1:]]) & (
        gr["to_lo"][e[:, :-1]] == gr["from_lo"][e[:, 1:]])
    placed = (start[:, 1:] - start[:, :-1] - gr["edge_kmers"][e[:, :-1]]).abs() <= JITTER
    cont = touch & placed & live[:, 1:] & live[:, :-1]
    sup = torch.where(live, s_hits, 0)
    run = sup.clone()
    run_from = torch.zeros_like(sup)
    for s in range(1, MAX_PATH):
        c = cont[:, s - 1]
        run[:, s] = torch.where(c, run[:, s - 1] + sup[:, s], sup[:, s]) * live[:, s]
        run_from[:, s] = torch.where(c, run_from[:, s - 1], s)
    best = run.max(dim=1, keepdim=True).values
    end = torch.where(run == best, col[None, :], MAX_PATH).min(dim=1).values
    begin = run_from.gather(1, end[:, None])[:, 0]
    length = end - begin + 1
    take = (begin[:, None] + col[None, :]).clamp(max=MAX_PATH - 1)
    edges = torch.where(col[None, :] < length[:, None], s_edge.gather(1, take), -1)
    p0 = s_p.gather(1, begin[:, None])[:, 0]
    q0 = s_q.gather(1, begin[:, None])[:, 0]
    any_hit = n_slots > 0
    zero = torch.zeros_like(length)
    return dict(edges=edges, path_len=torch.where(any_hit, length, zero),
                offset=torch.where(any_hit, q0 - p0, zero),
                first_skip=torch.where(any_hit, p0, zero), overflow=n_slots > MAX_PATH)
