"""Read-to-graph pathing on torch tensors: port of the fused uniform-read
path of supernova_tpu/align/pather.py.

Every read becomes (offset, [edge ids]) on the unipath graph.  One
sort-merge join looks up every read kmer in the graph's kmer dictionary;
hits on the same edge re-join across a miss gap only when the implied read
offsets agree within JITTER (captured-gap rule); consecutive path slots
must be graph-adjacent at the right junction position, and the best
supported valid run of slots is kept (algorithmTwo's seed-chain checks).

The dictionary values reach the query rows by the cummax + gather variant
of the reference (`join_once`, else-branch), which the reference's tests
hold equal to its associative-scan variant.  Left out as TPU-compile
workarounds: SCAN_PROPAGATE_MAX_ROWS, JOIN_ROWS (`_join_block_positions`),
table slicing and _is_compile_kill.  Readsets above BLOCK_POSITIONS bases
are pathed block by block (`path_readset_blocked`, the reference's
_path_readset_blocked).  Mixed-length readsets (the general pather) are
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..kmer import count as kcount

MAX_PATH = 12  # max edges a 150 bp read can plausibly traverse; overflow flagged
JITTER = 3  # max indel slack for captured gaps / junctions


class ReadPaths(NamedTuple):
    edges: torch.Tensor  # (R, MAX_PATH) int64 edge ids, -1 pad
    path_len: torch.Tensor  # (R,) int64
    offset: torch.Tensor  # (R,) int64 read start in first-edge coordinates
    first_skip: torch.Tensor  # (R,) int64 read position of first kmer hit
    overflow: torch.Tensor  # (R,) bool


def _select_best_run(paths, entry_p, entry_e, slot_hits, raw_len, n_slots, overflow,
                     from_v, to_v, edge_kmers, max_path: int, rp: int) -> ReadPaths:
    """Seed-chain validation: consecutive slots must be graph-adjacent AND
    the implied read coordinate of the next edge's start must equal this
    edge's start + its kmer count within JITTER; keep the best-supported
    valid run of slots per read (the earliest on ties)."""
    dev = paths.device
    slot_i = torch.arange(max_path, device=dev)[None, :]
    exists = slot_i < raw_len[:, None]
    e_safe = paths.clamp(min=0)
    o = entry_p - entry_e  # read coord where each slot's edge starts
    km = edge_kmers[e_safe]
    adj = to_v[e_safe][:, :-1] == from_v[e_safe][:, 1:]
    pos_ok = (o[:, 1:] - (o[:, :-1] + km[:, :-1])).abs() <= JITTER
    valid_j = adj & pos_ok & exists[:, 1:] & exists[:, :-1]

    sup = torch.where(exists, slot_hits, 0)
    run_sup = [sup[:, 0]]
    run_st = [torch.zeros(rp, dtype=torch.int64, device=dev)]
    for i in range(1, max_path):
        cont = valid_j[:, i - 1]
        run_sup.append(
            torch.where(cont, run_sup[-1] + sup[:, i], sup[:, i]) * exists[:, i]
        )
        run_st.append(torch.where(cont, run_st[-1], i))
    run_sup = torch.stack(run_sup, dim=1)
    run_st = torch.stack(run_st, dim=1)
    best = run_sup.max(dim=1, keepdim=True).values
    end = torch.where(run_sup == best, slot_i, max_path).min(dim=1).values
    seg_start = run_st.gather(1, end[:, None])[:, 0]
    best_len = end - seg_start + 1

    idx = (seg_start[:, None] + slot_i).clamp(0, max_path - 1)
    keep = slot_i < best_len[:, None]
    paths = torch.where(keep, paths.gather(1, idx), -1)
    st = seg_start.clamp(0, max_path - 1)[:, None]
    p0 = entry_p.gather(1, st)[:, 0]
    e0 = entry_e.gather(1, st)[:, 0]

    has_hit = n_slots > 0
    return ReadPaths(
        paths,
        torch.where(has_hit, best_len, 0),
        torch.where(has_hit, e0 - p0, 0),
        torch.where(has_hit, p0, 0),
        overflow,
    )


def _compact_and_place(hit, edge, epos, cols: int, rp: int, max_path: int,
                       from_v, to_v, edge_kmers) -> ReadPaths:
    """Hit rows (given in query order) -> slots per read -> best run.

    The reference sorts hit rows by (miss, query position); here they
    already are in query order, so a boolean mask compacts them."""
    dev = hit.device
    cq = torch.nonzero(hit).squeeze(1)  # query positions of hits, ascending
    ce, cp = edge[cq], epos[cq]
    cread = cq // cols
    cpir = cq % cols
    cdelta = cp - cpir

    # captured-gap rejoin: a hit opens a new slot unless the previous hit
    # in the same read is on the same edge at an offset within JITTER
    prev_same = torch.zeros(cq.shape[0], dtype=torch.bool, device=dev)
    prev_same[1:] = (
        (ce[1:] == ce[:-1])
        & (cread[1:] == cread[:-1])
        & ((cdelta[1:] - cdelta[:-1]).abs() <= JITTER)
    )
    new = ~prev_same
    g = torch.cumsum(new.long(), 0) - 1  # global slot counter
    read_first = torch.ones_like(new)
    read_first[1:] = cread[1:] != cread[:-1]
    base = torch.cummax(torch.where(read_first, g, -1), 0).values
    slot = g - base

    flat = cread * max_path + slot
    ok = new & (slot < max_path)

    def place(vals, fill):
        out = torch.full((rp * max_path,), fill, dtype=torch.int64, device=dev)
        out[flat[ok]] = vals[ok]  # each (read, slot) is written once
        return out.reshape(rp, max_path)

    paths = place(ce, -1)
    entry_p = place(cpir, 0)
    entry_e = place(cp, 0)

    counted = slot < max_path
    slot_hits = torch.zeros(rp * max_path, dtype=torch.int64, device=dev)
    slot_hits.index_add_(0, flat[counted], torch.ones_like(flat[counted]))
    n_slots = torch.zeros(rp, dtype=torch.int64, device=dev)
    n_slots.index_add_(0, cread[new], torch.ones_like(cread[new]))
    return _select_best_run(
        paths, entry_p, entry_e, slot_hits.reshape(rp, max_path),
        n_slots.clamp(max=max_path), n_slots, n_slots > max_path,
        from_v, to_v, edge_kmers, max_path, rp,
    )


def _join(kmer_words: W3, node_edge, node_pos, canon: W3, flipped, invalid):
    """Look the query kmers up in the sorted table (the cummax merge-join of
    `lookup_words_merge`) -> (hit, edge, epos) per query row, in query order."""
    row, found = kc.lookup_words_merge(kmer_words, canon)
    hit = found & ~invalid
    node = 2 * row + flipped.long()
    edge = torch.where(hit, node_edge[node], -1)
    epos = torch.where(hit, node_pos[node], 0)
    return hit, edge, epos


def path_reads_fused_impl(kmer_words: W3, node_edge, node_pos, from_v, to_v, edge_kmers,
                          codes_ext, rlen_pos, nbp: int, rp: int, max_path: int,
                          uniform_rl: int) -> ReadPaths:
    """Pather for uniform-length reads: word extraction (K1 on the card),
    one merge-join against the dictionary, then slotting and seed-chain
    validation at hit scale."""
    cols = uniform_rl - K + 1
    canon, flipped = kc.canonicalize(kc.sliding_words(codes_ext, nbp))
    a_, b_, c_, flipped, rlen_q = kcount.uniform_tail_cut(
        uniform_rl, canon.a, canon.b, canon.c, flipped, rlen_pos
    )
    n = a_.shape[0]
    pirq = torch.arange(n, device=a_.device) % cols
    invalid = pirq + K > rlen_q  # padding reads
    hit, edge, epos = _join(kmer_words, node_edge, node_pos, W3(a_, b_, c_), flipped, invalid)
    return _compact_and_place(
        hit, edge, epos, cols, rp, max_path, from_v, to_v, edge_kmers
    )


def path_reads_packed(kmer_words: W3, node_edge, node_pos, from_v, to_v, edge_kmers,
                      codes_packed, n_reads: int, max_path: int, uniform_rl: int,
                      nbp: int, rp_pad: int) -> ReadPaths:
    """Pathing from compact inputs (2-bit packed codes + read count): the
    per-position arrays are rebuilt on the device."""
    rl = uniform_rl
    codes_ext = kcount._unpack_codes_dev(codes_packed, nbp, max(K, 128))
    pos = torch.arange(nbp, device=codes_ext.device) // rl
    rlen_pos = torch.where(pos < n_reads, rl, 0)
    return path_reads_fused_impl(
        kmer_words, node_edge, node_pos, from_v, to_v, edge_kmers,
        codes_ext, rlen_pos, nbp, rp_pad, max_path, rl,
    )


def _path_packed(bg, pk, device, max_path: int, rp_pad: int) -> ReadPaths:
    da = bg.device_arrays(device)
    return path_reads_packed(
        da["words"], da["node_edge"], da["node_pos"], da["from_v"], da["to_v"],
        da["edge_kmers"], torch.from_numpy(pk["codes_packed"]).to(device),
        int(pk["n_reads"]), max_path, pk["uniform_rl"], pk["nbp"], rp_pad,
    )


def path_readset_blocked(bg, rs, device, max_path: int = MAX_PATH,
                         max_positions: int | None = None) -> ReadPaths:
    """Path a uniform-length readset block by block (the count's barcode-
    boundary blocks, BLOCK_POSITIONS bases when max_positions is None):
    every block is padded to the largest block's bases and to
    round_up(largest read count + 1, 1024) rows, and its first n_reads rows
    are kept.  Reads are independent, so the concatenation equals the
    single-block result over [:n_reads]; the output has n_reads rows."""
    device = torch.device(device)
    blocks = kcount.split_readset_blocks(rs, max_positions or kcount.BLOCK_POSITIONS)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    rp_pad = kcount._round_up(max(b.n_reads for b in blocks) + 1, 1024)
    parts = []
    for b in blocks:
        rp = _path_packed(bg, kcount.prepare_reads_packed(b, pad_to_positions=pad_pos),
                          device, max_path, rp_pad)
        parts.append([x[: b.n_reads] for x in rp])
    return ReadPaths(*(torch.cat([p[i] for p in parts]) for i in range(len(ReadPaths._fields))))


def path_readset(bg, rs, device, max_path: int = MAX_PATH) -> ReadPaths:
    """BaseGraph + ReadSet -> ReadPaths on `device`: rows padded to
    round_up(n_reads + 1, 1024) for one block, n_reads rows when the
    readset spans several (as in the reference)."""
    if kcount._uniform_rl(rs) is None:
        raise NotImplementedError(
            "mixed-length readsets need the general pather (path_reads_impl), "
            "ROADMAP item 'general pather'"
        )
    if int(rs.offsets[-1]) > kcount.BLOCK_POSITIONS:
        return path_readset_blocked(bg, rs, device, max_path)
    return _path_packed(bg, kcount.prepare_reads_packed(rs), torch.device(device), max_path,
                        kcount._round_up(rs.n_reads + 1, 1024))
