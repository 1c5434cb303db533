"""Read-to-graph pathing on torch tensors: port of
supernova_tpu/align/pather.py.

Every read becomes (offset, [edge ids]) on the unipath graph.  One
sort-merge join looks up every read kmer in the graph's kmer dictionary;
hits on the same edge re-join across a miss gap only when the implied read
offsets agree within JITTER (captured-gap rule); consecutive path slots
must be graph-adjacent at the right junction position, and the best
supported valid run of slots is kept (algorithmTwo's seed-chain checks).

Uniform-length reads take the fused pather (`path_reads_fused_impl`, from
2-bit packed codes); mixed-length reads (10x R1 is 23 bases shorter than
R2) take the general one (`path_reads_impl`, per-position inputs of
kcount.prepare_reads).  Both place their hits with `_compact_and_place`.
The dictionary values reach the query rows by the cummax + gather variant
of the reference (`join_once`, else-branch), which the reference's tests
hold equal to its associative-scan variant.  Left out as TPU-compile
workarounds: SCAN_PROPAGATE_MAX_ROWS, JOIN_ROWS (`_join_block_positions`),
table slicing and _is_compile_kill.  Readsets above one block's bases
are pathed block by block (`path_readset_blocked`, the reference's
_path_readset_blocked), halving the block size on a device OOM.  A block's
size is `path_block_positions`: on a card what its free memory holds beside
the graph's dictionary, on the CPU (the tests' device) the reference's
BLOCK_POSITIONS.

A call is the span call.path_readset (stats/trace.py), each block's steps
call.paths.prep (the block's host preparation, its upload and expansion
on the device), call.paths.join (K1, canonicalisation, the tail cut and
the merge join with its value gathers) and call.paths.place (slotting,
seed chains, and the blocks' concatenation); each block's queries are
counted in prep (`prepare_block`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..kmer import count as kcount
from ..ops.kernels.scan_max import scan_max
from ..stats.trace import count_rows, span, upload

MAX_PATH = 12  # max edges a 150 bp read can plausibly traverse; overflow flagged
JITTER = 3  # max indel slack for captured gaps / junctions
# peak device bytes per position of one paths block beside the dictionary
# (the block's inputs, extraction, the query side of the merge join, hit
# placement) that the caching allocator reserves: 212.0 measured on an
# H100 80GB HBM3 (700 W) by chip_smoke.py's mixed-paths phase for the
# general pather, the costlier one (21.248 GiB reserved at 96M positions,
# 11.773 GiB at 48M; the tensors alone 194.2), rounded up
PATH_BYTES_PER_POSITION = 224
# peak device bytes per dictionary row (graph.kmer_words' sentinel-padded
# rows) beside a paths block: the dictionary's own tensors (words,
# node_edge, node_pos: 40 B) and the merge join's table side, reserved.
# From the 100 Mb rung on an H100 80GB HBM3 (700 W; stats/rung.py): a
# 231,735,296-position block beside the 123,389,952-row dictionary ran
# out of memory with 76.70 GiB reserved while asking for 2.11 GiB more,
# so a row takes at least (78.81 GiB - 224 B x 231,735,296) / 123,389,952
# = 265.1 B; rounded up.  At 10 Mb (10,597,376 rows) the reserve at 96M
# positions is 2.46 GB above 212.0 B a position: 232 B a row.
PATH_BYTES_PER_DICT_ROW = 288


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


def _compact_and_place(hit, edge, epos, locate, rp: int, max_path: int,
                       from_v, to_v, edge_kmers) -> ReadPaths:
    """Hit rows (given in query order) -> slots per read -> best run.

    locate(cq) gives the read and the position in the read of the hit rows
    cq.  The reference sorts hit rows by (miss, query position) (the
    general pather: a stable sort by miss); here they already are in query
    order, so a boolean mask compacts them."""
    dev = hit.device
    cq = torch.nonzero(hit).squeeze(1)  # query positions of hits, ascending
    ce, cp = edge[cq], epos[cq]
    cread, cpir = locate(cq)
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
    base = scan_max(g, read_first, -1)
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
    with span("call.paths.join", codes_ext.device):
        canon, flipped = kc.canonicalize(kc.sliding_words(codes_ext, nbp))
        a_, b_, c_, flipped, rlen_q = kcount.uniform_tail_cut(
            uniform_rl, canon.a, canon.b, canon.c, flipped, rlen_pos
        )
        n = a_.shape[0]
        pirq = torch.arange(n, device=a_.device) % cols
        invalid = pirq + K > rlen_q  # padding reads
        hit, edge, epos = _join(kmer_words, node_edge, node_pos, W3(a_, b_, c_), flipped,
                                invalid)
    with span("call.paths.place", codes_ext.device):
        return _compact_and_place(
            hit, edge, epos, lambda cq: (cq // cols, cq % cols), rp, max_path,
            from_v, to_v, edge_kmers,
        )


def general_queries(codes_ext, read_offsets, pos_read, rlen_pos, uniform_rl: int | None = None):
    """The general pather's dictionary queries: every position's canonical
    kmer (K1 on the card), its flip, whether it lies past its read's end,
    and `locate`, which maps a query row to (read, position in read).
    uniform_rl cuts the last K-1 positions of each read block first (the
    reference's tail-cut branch).

    The position in the read is p - read_offsets[pos_read], one gather: it
    equals the reference's cummax from each read's first position because
    pos_read is non-decreasing and read_offsets[r] is read r's first
    position (empty reads and the padding read n_reads included)."""
    nb = pos_read.shape[0]
    canon, flipped = kc.canonicalize(kc.sliding_words(codes_ext, nb))
    if uniform_rl is not None:
        cols = uniform_rl - K + 1
        a_, b_, c_, flipped, pos_read, rlen_pos = kcount.uniform_tail_cut(
            uniform_rl, canon.a, canon.b, canon.c, flipped, pos_read, rlen_pos
        )
        canon = W3(a_, b_, c_)
        pir = torch.arange(a_.shape[0], device=a_.device) % cols
    else:
        pir = torch.arange(nb, device=pos_read.device) - torch.index_select(
            read_offsets, 0, pos_read)
    invalid = pir + K > rlen_pos  # beyond the read (padding reads: length 0)
    return canon, flipped, invalid, lambda cq: (pos_read[cq].long(), pir[cq])


def place_hits(hit, edge, epos, locate, rp: int, max_path: int, from_v, to_v,
               edge_kmers) -> ReadPaths:
    """The general pather after its dictionary lookup: slotting and
    seed-chain validation at hit scale."""
    return _compact_and_place(hit & (edge >= 0), edge, epos, locate, rp, max_path,
                              from_v, to_v, edge_kmers)


def path_reads_impl(kmer_words: W3, node_edge, node_pos, from_v, to_v, edge_kmers,
                    codes_ext, read_offsets, pos_read, rlen_pos, max_path: int = MAX_PATH,
                    uniform_rl: int | None = None) -> ReadPaths:
    """The general pather (per-position inputs of kcount.prepare_reads, any
    read lengths): general_queries, one merge-join against the dictionary
    (K4), then place_hits.  Output rows: rp = len(read_offsets) - 1."""
    with span("call.paths.join", codes_ext.device):
        canon, flipped, invalid, locate = general_queries(codes_ext, read_offsets, pos_read,
                                                          rlen_pos, uniform_rl)
        hit, edge, epos = _join(kmer_words, node_edge, node_pos, canon, flipped, invalid)
    with span("call.paths.place", codes_ext.device):
        return place_hits(hit, edge, epos, locate, read_offsets.shape[0] - 1, max_path,
                          from_v, to_v, edge_kmers)


def packed_inputs(pk: dict, device) -> dict:
    """The fused pather's device inputs from kcount.prepare_reads_packed's
    host arrays: the packed codes uploaded and unpacked, and each
    position's read length (0 past the last read)."""
    rl, nbp = pk["uniform_rl"], pk["nbp"]
    codes_ext = kcount._unpack_codes_dev(upload(pk["codes_packed"], device), nbp, max(K, 128))
    pos = torch.arange(nbp, device=codes_ext.device) // rl
    return dict(codes_ext=codes_ext, rlen_pos=torch.where(pos < int(pk["n_reads"]), rl, 0),
                nbp=nbp, uniform_rl=rl)


def query_rows(inp: dict) -> int:
    """The dictionary queries a block's join makes from its inputs (either
    pather's): every position, or a uniform block's positions less each
    read's last K-1."""
    nbp, rl = inp["nbp"] if "nbp" in inp else inp["pos_read"].shape[0], inp["uniform_rl"]
    return nbp if rl is None else nbp // rl * (rl - K + 1)


def prepare_block(rs, device, packed: bool, pad_to_positions: int | None = None,
                  pad_to_reads: int | None = None) -> dict:
    """One block's inputs on `device` (the prep step): packed_inputs for the
    fused pather, else kcount.prepare_reads' for the general one.  Its join
    is counted as join_rows and dead_join_rows (stats/trace.py count_rows):
    the queries, and those that start no K-mer of the block's reads (past
    a read's last K-1, the padding up to its sibling blocks' shape)."""
    with span("call.paths.prep", device):
        if packed:
            inp = packed_inputs(kcount.prepare_reads_packed(rs, pad_to_positions), device)
        else:
            inp = kcount.prepare_reads(rs, device, pad_to_positions=pad_to_positions,
                                       pad_to_reads=pad_to_reads)
        count_rows("join", lambda: (query_rows(inp), kcount.kmer_starts(rs.lengths())))
        return inp


def _path_packed(bg, inp, device, max_path: int, rp_pad: int) -> ReadPaths:
    da = bg.device_arrays(device)
    return path_reads_fused_impl(
        da["words"], da["node_edge"], da["node_pos"], da["from_v"], da["to_v"],
        da["edge_kmers"], inp["codes_ext"], inp["rlen_pos"], inp["nbp"], rp_pad, max_path,
        inp["uniform_rl"],
    )


def _path_full(bg, inp, device, max_path: int) -> ReadPaths:
    da = bg.device_arrays(device)
    return path_reads_impl(
        da["words"], da["node_edge"], da["node_pos"], da["from_v"], da["to_v"],
        da["edge_kmers"], inp["codes_ext"], inp["read_offsets"], inp["pos_read"],
        inp["rlen_pos"], max_path, inp["uniform_rl"],
    )


def _placed_bytes(bg, device) -> int:
    """Bytes of the graph's device arrays already cached on `device`."""
    da = bg.__dict__.get("_device_arrays", {}).get(device, {})
    ts = [t for v in da.values() for t in (v if isinstance(v, tuple) else (v,))]
    return sum(t.numel() * t.element_size() for t in ts)


def path_block_positions(device, bg, free_bytes: int | None = None) -> int:
    """Bases one paths block takes on `device`: the card's memory free with
    no dictionary on it (kcount.free_device_bytes plus the graph's device
    arrays when they are already there, or free_bytes), less
    PATH_BYTES_PER_DICT_ROW a dictionary row, over PATH_BYTES_PER_POSITION,
    by kcount.block_budget.  Nothing is placed on the card.  A block's
    queries sort beside the dictionary's rows, so it is capped at
    kcount.MAX_BLOCK_POSITIONS less those rows.  The CPU (the tests'
    device) takes the reference's BLOCK_POSITIONS."""
    device = torch.device(device)
    if device.type != "cuda":
        return kcount.BLOCK_POSITIONS
    m = int(bg.kmer_words.shape[0])
    if free_bytes is None:
        free_bytes = kcount.free_device_bytes(device) + _placed_bytes(bg, device)
    return kcount.block_budget(free_bytes - m * PATH_BYTES_PER_DICT_ROW,
                               PATH_BYTES_PER_POSITION, kcount.MAX_BLOCK_POSITIONS - m)


def path_readset_blocked(bg, rs, device, max_path: int = MAX_PATH,
                         max_positions: int | None = None,
                         info: dict | None = None) -> ReadPaths:
    """Path a readset block by block (the count's barcode-boundary blocks,
    path_block_positions bases when max_positions is None): every block is
    padded to the largest block's bases and reads, and its first n_reads
    rows are kept.  Reads are independent, so the concatenation equals the
    single-block result over [:n_reads]; the output has n_reads rows.
    Uniform-length readsets (decided on the parent, as the reference does)
    send packed codes to the fused pather, mixed-length ones the inputs of
    prepare_reads to the general pather.  info receives blocks and
    block_positions."""
    device = torch.device(device)
    max_positions = max_positions or path_block_positions(device, bg)
    with span("call.paths.prep", device):
        blocks = kcount.split_readset_blocks(rs, max_positions)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    packed = kcount._uniform_rl(rs) is not None
    if info is not None:
        info.update(blocks=len(blocks), block_positions=max_positions)
    parts = []
    for b in blocks:
        inp = prepare_block(b, device, packed, pad_pos, pad_rd)
        if packed:
            rp = _path_packed(bg, inp, device, max_path, kcount._round_up(pad_rd + 1, 1024))
        else:
            rp = _path_full(bg, inp, device, max_path)
        del inp
        parts.append([x[: b.n_reads] for x in rp])
    with span("call.paths.place", device):
        return ReadPaths(*(torch.cat([p[i] for p in parts])
                           for i in range(len(ReadPaths._fields))))


def path_readset(bg, rs, device, max_path: int = MAX_PATH, info: dict | None = None,
                 max_positions: int | None = None) -> ReadPaths:
    """BaseGraph + ReadSet -> ReadPaths on `device`: rows padded to
    round_up(n_reads + 1, 1024) for one block, n_reads rows when the
    readset spans several (as in the reference).  max_positions: bases a
    block takes (path_block_positions when None).  Above it the blocked
    pather runs under kcount.halving_retry, which starts from it (info
    receives blocks, block_positions and oom_retries; one block: blocks 1,
    block_positions)."""
    device = torch.device(device)
    with span("call.path_readset", device):
        max_positions = max_positions or path_block_positions(device, bg)
        if int(rs.offsets[-1]) > max_positions:
            return kcount.halving_retry(
                "paths", device, info, lambda max_pos: path_readset_blocked(
                    bg, rs, device, max_path, max_positions=max_pos, info=info), max_positions)
        if info is not None:
            info.update(blocks=1, block_positions=int(max_positions))
        packed = kcount._uniform_rl(rs) is not None
        inp = prepare_block(rs, device, packed)
        if packed:
            return _path_packed(bg, inp, device, max_path,
                                kcount._round_up(rs.n_reads + 1, 1024))
        return _path_full(bg, inp, device, max_path)
