"""48-mer counting on torch tensors: port of supernova_tpu/kmer/count.py,
single-block and blocked.

Rules reproduced (see the reference module's docstring): qual trim to the
longest prefix whose last K bases have qual >= MIN_QUAL; canonical 48-mers
with their observed left/right extension masks, rc-flipped with the kmer;
keep kmers with count >= min_freq AND (an occurrence from an ignored
barcode OR >= min_bc distinct barcodes > 0); then intersect the extension
masks with table membership.

Design: one lexicographic sort of all (kmer, packed attributes) occurrence
rows (kernel K4, csrc/radix_sort.cu, on the card), then per-run
reductions.  On the card the reduction is kernel K3 (csrc/run_reduce.cu)
followed by kernel K2 (csrc/compact.cu); on the CPU it is the plain
cumsum/cummax branch.  The two branches differ only in `nbc` above 4095
(the fused stats word clamps it, as on the TPU).

Readsets above BLOCK_POSITIONS flat bases take the blocked count
(`count_readset_blocked`): the readset is cut at barcode boundaries into
blocks, each block is counted WITHOUT the filter into a raw table of its
distinct kmers (kept rows pulled to host memory), and the concatenated raw
rows go back to the card for one merge + filter.  Bit-identical to the
single-block count.  Left out (each raises NotImplementedError where it
would be needed): the partitioned host merge for raw rows above the
card's merge budget, blocked counting of mixed-length readsets, and the
reference's spill/resume and OOM-halving retry.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..ingest.feudal import pack_codes
from ..ingest.reads import ReadSet
from ..ops import segments as seg
from ..ops.kernels.run_reduce import run_reduce, run_stats_plain

MIN_QUAL = 7
MIN_FREQ = 3
MIN_BC = 2
BC_IGNORED = -1  # occurrences whose barcode is untracked
BC_FIELD_IGNORED = 0x3FFFFF  # 22-bit barcode field; all-ones = "ignored"
MIN_READ_LEN = K + 1  # good length a read needs to contribute kmers
BASE_BUCKET = 16384  # flat-base padding of mixed-length readsets
READ_BUCKET = 1024  # read-count padding
# flat bases one count block holds: the reference's unit of work
# (supernova_tpu/kmer/count.py BLOCK_POSITIONS); larger readsets go through
# the blocked count.  The output does not depend on the block size.
BLOCK_POSITIONS = 96_000_000
# peak device bytes per raw row of merge_raw_blocks, its inputs included,
# when every row is a distinct kmer (its worst case): 219.6 measured on an
# H100 by chip_smoke.py's merge phase, rounded up
MERGE_BYTES_PER_ROW = 224


class KmerTable(NamedTuple):
    """Sorted canonical kmer table, sentinel-padded to M rows."""

    words: W3  # (M,) x3 int64, canonical, ascending; sentinel pad
    count: torch.Tensor  # (M,) int32 occurrence count
    nbc: torch.Tensor  # (M,) int32 distinct barcodes > 0
    left_mask: torch.Tensor  # (M,) int32 4-bit predecessor-base mask
    right_mask: torch.Tensor  # (M,) int32 4-bit successor-base mask
    n_valid: torch.Tensor  # 0-d int64


def rev4(mask):
    """Reverse a 4-bit base mask (bit b -> bit 3-b): rc of an extension set."""
    return ((mask & 1) << 3) | ((mask & 2) << 1) | ((mask & 4) >> 1) | ((mask & 8) >> 3)


def extract_occurrences(codes_ext, pos_read, glen_pos, bc_pos):
    """Per-position canonical kmer occurrences (the Kmerizer::map phase).

    codes_ext: (NB + >=K,) int32 codes, zero tail; pos_read/glen_pos/bc_pos:
    (NB,) per-position read id, good length and barcode.
    -> (canon W3 with sentinel at invalid rows, bc, lm, rm, valid)."""
    nb = pos_read.shape[0]
    dev = pos_read.device
    p = torch.arange(nb, device=dev)
    canon, flipped = kc.canonicalize(kc.sliding_words(codes_ext, nb))

    read_first = torch.ones(nb, dtype=torch.bool, device=dev)
    read_first[1:] = pos_read[1:] != pos_read[:-1]
    start = torch.cummax(torch.where(read_first, p, 0), 0).values
    pir = p - start  # position in read
    glen = glen_pos.to(torch.int64)
    valid = (pir + K <= glen) & (glen >= MIN_READ_LEN)

    codes = codes_ext.to(torch.int64)
    pred = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), codes[: nb - 1]])
    succ = codes[K : K + nb]
    lmask = torch.where(pir > 0, 1 << pred, 0)
    rmask = torch.where(pir + K < glen, 1 << succ, 0)
    lm = torch.where(flipped, rev4(rmask), lmask)
    rm = torch.where(flipped, rev4(lmask), rmask)
    return canon.where(valid, kc.SENTINEL), bc_pos, lm, rm, valid


def uniform_tail_cut(uniform_rl: int, *arrays):
    """Drop the last K-1 positions of every uniform-length read block —
    they never start a kmer (reshape + slice, as in the reference)."""
    cols = uniform_rl - K + 1
    return tuple(x.reshape(-1, uniform_rl)[:, :cols].reshape(-1) for x in arrays)


def pack_occurrence_attrs(bc, lm, rm, valid):
    """Non-kmer occurrence attributes as ONE 32-bit sort key (in int64):
    [31:10] barcode (22 bits), [9:6] left mask, [5:2] right mask, [1] valid."""
    bc = bc.to(torch.int64)
    bcf = torch.where(bc == BC_IGNORED, BC_FIELD_IGNORED, bc)
    return (
        (bcf << 10)
        | (lm.to(torch.int64) << 6)
        | (rm.to(torch.int64) << 2)
        | (valid.to(torch.int64) << 1)
    )


def unpack_occurrence_attrs(pk):
    field = pk >> 10
    bc = torch.where(field == BC_FIELD_IGNORED, BC_IGNORED, field)
    return bc, (pk >> 6) & 15, (pk >> 2) & 15, ((pk >> 1) & 1) == 1


def _reduce_packed(canon: W3, packed, min_freq: int, min_bc: int) -> KmerTable:
    """Sort (kmer, packed attrs) rows and reduce each run into a filtered
    KmerTable padded to the row count."""
    nb = canon.a.shape[0]
    dev = canon.a.device
    ws, (pk,), _ = kc.sort_by_words(canon, extra_keys=(packed,))
    if dev.type == "cuda":
        # fused: all per-run statistics + the keep decision in one pass (K3),
        # then a stable compaction of the kept run ends (K2)
        keep, count, stats = run_reduce(ws.a, ws.b, ws.c, pk, min_freq, min_bc)
        n_valid, (wa, wb, wc, c2, st2) = seg.compact_sorted_words(
            keep, ws.a, ws.b, ws.c, count, stats
        )
        nbc2, l2, r2 = (st2 >> 9) & 4095, (st2 >> 5) & 15, (st2 >> 1) & 15
    else:
        ends, real, count, nbc, ign, lm, rm = run_stats_plain(ws.a, ws.b, ws.c, pk)
        keep = ends & real & (count >= min_freq) & (ign | (nbc >= min_bc))
        i32 = torch.int32
        n_valid, (wa, wb, wc, c2, nbc2, l2, r2) = seg.compact_sorted_words(
            keep, ws.a, ws.b, ws.c, count.to(i32), nbc.to(i32), lm.to(i32), rm.to(i32)
        )
    m = torch.arange(nb, device=dev) < n_valid
    return KmerTable(W3(wa, wb, wc).where(m, kc.SENTINEL), c2, nbc2, l2, r2, n_valid)


def reduce_occurrences(canon: W3, bc, lm, rm, valid, min_freq: int = MIN_FREQ,
                       min_bc: int = MIN_BC) -> KmerTable:
    """Sort occurrence rows and reduce each run (the Kmerizer::reduce phase)."""
    return _reduce_packed(canon, pack_occurrence_attrs(bc, lm, rm, valid), min_freq, min_bc)


def count_kmers(codes_ext, pos_read, glen_pos, bc_pos, min_freq: int = MIN_FREQ,
                min_bc: int = MIN_BC, uniform_rl: int | None = None) -> KmerTable:
    """Count + filter canonical 48-mers over all reads of one block.

    uniform_rl: every read (host padding included) is laid out in blocks of
    this length, so the last K-1 positions of each block are cut before the
    sort (~30% of the rows at rl=150)."""
    canon, bc, lm, rm, valid = extract_occurrences(codes_ext, pos_read, glen_pos, bc_pos)
    pk = pack_occurrence_attrs(bc, lm, rm, valid)
    if uniform_rl is not None:
        a_, b_, c_, pk = uniform_tail_cut(uniform_rl, canon.a, canon.b, canon.c, pk)
        canon = W3(a_, b_, c_).where(((pk >> 1) & 1) == 1, kc.SENTINEL)
    return _reduce_packed(canon, pk, min_freq, min_bc)


def recompute_adjacencies(table: KmerTable) -> KmerTable:
    """Intersect observed extension masks with table membership
    (KmerDict::recomputeAdjacencies)."""
    words = table.words
    new_r = torch.zeros_like(table.right_mask)
    new_l = torch.zeros_like(table.left_mask)
    for b in range(4):
        succ, _ = kc.canonicalize(kc.successor_words(words, b))
        _, found = kc.lookup_words_merge(words, succ)
        new_r |= found.to(new_r.dtype) << b
        pred, _ = kc.canonicalize(kc.predecessor_words(words, b))
        _, found = kc.lookup_words_merge(words, pred)
        new_l |= found.to(new_l.dtype) << b
    return table._replace(
        left_mask=table.left_mask & new_l, right_mask=table.right_mask & new_r
    )


# ----------------------------------------------------------------- host prep
# good_lengths_np / prepare_reads / prepare_reads_packed are host numpy in
# the reference too, but its module imports jax, so they are copied here
# (tests/test_torch_count.py holds each copy equal to the original).

def good_lengths_np(quals: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Host qual-trim rule: per read, the largest prefix whose last K bases
    are all >= MIN_QUAL.  Only BAD positions matter, so the work is
    O(n_reads + n_bad): between consecutive bad positions (plus a virtual bad
    before each read start, the read end bounding the last), a clean segment
    of length >= K ending at `nxt` gives candidate glen = nxt - start; the
    max candidate is the last one, found per read with np.maximum.reduceat."""
    nb = len(quals)
    n_reads = len(offsets) - 1
    offsets = np.asarray(offsets, np.int64)
    if nb == 0 or n_reads == 0:
        return np.zeros(n_reads, dtype=np.int32)
    badpos = np.flatnonzero(np.asarray(quals) < MIN_QUAL)
    starts = offsets[:-1]
    allb = np.concatenate([starts - 1, badpos])
    rid = np.concatenate([
        np.arange(n_reads, dtype=np.int64),
        np.searchsorted(offsets, badpos, side="right") - 1,
    ])
    order = np.lexsort((allb, rid))
    allb = allb[order]
    rid = rid[order]
    nxt = np.concatenate([allb[1:], [0]])
    last_of_read = np.r_[rid[1:] != rid[:-1], True]
    nxt = np.where(last_of_read, offsets[1:][rid], nxt)
    seg_len = nxt - allb - 1  # clean run between this bad and the next
    cand = np.where(seg_len >= K, nxt - starts[rid], 0)
    first_of_read = np.r_[True, rid[1:] != rid[:-1]]
    return np.maximum.reduceat(cand, np.flatnonzero(first_of_read)).astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _uniform_rl(rs) -> int | None:
    lens = np.diff(rs.offsets)
    if rs.n_reads > 0 and (lens == lens[0]).all() and lens[0] > K:
        return int(lens[0])
    return None


def prepare_reads(rs, device) -> dict:
    """Host packing of a ReadSet into per-position tensors on `device`.

    Sizes are rounded up as in the reference (padding positions belong to a
    fake empty read); with uniform read length the base padding is a
    multiple of rl*128 and the dict carries `uniform_rl`."""
    nb = int(rs.offsets[-1])
    n_reads = rs.n_reads
    uniform_rl = _uniform_rl(rs)
    base_bucket = BASE_BUCKET if uniform_rl is None else uniform_rl * 128
    nbp = _round_up(max(nb, 1), base_bucket)
    rp = _round_up(n_reads + 1, READ_BUCKET)

    codes_ext = np.zeros(nbp + max(K, 128), dtype=np.int32)
    codes_ext[:nb] = rs.codes
    lens = np.diff(rs.offsets).astype(np.int64)
    pos_read = np.full(nbp, n_reads, dtype=np.int32)
    pos_read[:nb] = np.repeat(np.arange(n_reads, dtype=np.int32), lens)
    offsets = np.full(rp + 1, nb, dtype=np.int32)
    offsets[: n_reads + 1] = rs.offsets
    read_bc = np.full(rp, BC_IGNORED, dtype=np.int32)
    if rs.barcoded:
        read_bc[:n_reads] = np.where(rs.bc > 0, rs.bc, BC_IGNORED)
    glen_pos = np.zeros(nbp, dtype=np.int32)
    glen_pos[:nb] = np.repeat(good_lengths_np(rs.quals, rs.offsets), lens)
    bc_pos = np.full(nbp, BC_IGNORED, dtype=np.int32)
    bc_pos[:nb] = np.repeat(read_bc[:n_reads], lens)
    rlen_pos = np.zeros(nbp, dtype=np.int32)
    rlen_pos[:nb] = np.repeat(lens.astype(np.int32), lens)
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(
        codes_ext=t(codes_ext), read_offsets=t(offsets), pos_read=t(pos_read),
        glen_pos=t(glen_pos), bc_pos=t(bc_pos), rlen_pos=t(rlen_pos),
        read_bc=t(read_bc), uniform_rl=uniform_rl,
    )


def prepare_reads_packed(rs, pad_to_positions: int | None = None):
    """Compact host prep for uniform-length reads: 2-bit packed codes +
    per-READ attributes (numpy); the per-position arrays are rebuilt on the
    device.  None for non-uniform reads."""
    uniform_rl = _uniform_rl(rs)
    if uniform_rl is None:
        return None
    n_reads = rs.n_reads
    nb = int(rs.offsets[-1])
    nbp = _round_up(max(nb, 1, pad_to_positions or 1), uniform_rl * 128)
    grid = nbp // uniform_rl
    codes = np.zeros(nbp, np.uint8)
    codes[:nb] = rs.codes
    glen = np.zeros(grid, np.int32)
    glen[:n_reads] = good_lengths_np(rs.quals, rs.offsets)
    read_bc = np.full(grid, BC_IGNORED, np.int32)
    if rs.barcoded:
        read_bc[:n_reads] = np.where(rs.bc > 0, rs.bc, BC_IGNORED)
    return dict(
        codes_packed=pack_codes(codes), glen=glen, read_bc=read_bc,
        n_reads=n_reads, uniform_rl=uniform_rl, nbp=nbp,
    )


def _unpack_codes_dev(packed: torch.Tensor, nbp: int, ext: int) -> torch.Tensor:
    """Device 2-bit unpack (inverse of feudal.pack_codes: code j at bit
    (j%4)*2): (nbp//4,) uint8 -> (nbp + ext,) int32 with a zero tail."""
    x = packed.to(torch.int32)
    codes = torch.stack([(x >> s) & 3 for s in (0, 2, 4, 6)], dim=1).reshape(-1)[:nbp]
    return torch.cat([codes, torch.zeros(ext, dtype=torch.int32, device=packed.device)])


def estimate_coverage(table: KmerTable, read_len: float = 150.0):
    """Kmer-spectrum coverage estimate -> (read_cov, genome_size_est), or
    (None, None): the median count of the table is the kmer coverage."""
    n = int(table.n_valid)
    if n == 0:
        return None, None
    counts = table.count[:n].cpu().numpy()
    kmer_cov = float(np.median(counts))
    if kmer_cov <= 0:
        return None, None
    read_cov = kmer_cov * read_len / max(read_len - K + 1, 1.0)
    return read_cov, int(counts.sum() / kmer_cov)


# ------------------------------------------------------- blocked counting

class RawBlockTable(NamedTuple):
    """Per-block UNFILTERED reduced table: one row per distinct canonical
    kmer of the block, stats packed as nbc(12b)|lm(4b)|rm(4b)|has_ign(1b)
    (K3's stats word).  Blocks are split at barcode boundaries so per-block
    nbc values sum exactly across blocks."""

    words: W3  # (M,) x3 int64, sentinel past n_valid
    count: torch.Tensor  # (M,) int32
    stats: torch.Tensor  # (M,) int32
    n_valid: torch.Tensor  # 0-d int64


def _reduce_occurrences_raw(canon: W3, packed) -> RawBlockTable:
    """Sort + per-run reduce WITHOUT the (min_freq, min_bc) filter: K3 with
    min_freq=1, min_bc=0 keeps every real run end (its plain twin on the
    CPU, which clamps nbc at 4095 as the reference's raw branch does)."""
    nb = canon.a.shape[0]
    ws, (pk,), _ = kc.sort_by_words(canon, extra_keys=(packed,))
    keep, count, stats = run_reduce(ws.a, ws.b, ws.c, pk, 1, 0)
    n_valid, (wa, wb, wc, c2, st2) = seg.compact_sorted_words(
        keep, ws.a, ws.b, ws.c, count, stats
    )
    m = torch.arange(nb, device=canon.a.device) < n_valid
    return RawBlockTable(W3(wa, wb, wc).where(m, kc.SENTINEL), c2, st2, n_valid)


def count_block_raw_packed(codes_packed, glen_r, bc_r, n_reads: int,
                           uniform_rl: int, nbp: int) -> RawBlockTable:
    """One block of the blocked count from compact inputs (2-bit packed
    codes + per-READ good length and barcode): the per-position arrays are
    rebuilt on the device (the same values prepare_reads builds on the
    host), then extract + tail cut + raw reduce."""
    rl = uniform_rl
    grid = nbp // rl
    codes_ext = _unpack_codes_dev(codes_packed, nbp, max(K, 128))
    pos_read = (torch.arange(nbp, device=codes_ext.device) // rl).clamp(max=n_reads)
    glen_pos = glen_r[:, None].expand(grid, rl).reshape(-1)
    bc_pos = bc_r[:, None].expand(grid, rl).reshape(-1)
    canon, bc, lm, rm, valid = extract_occurrences(codes_ext, pos_read, glen_pos, bc_pos)
    pk = pack_occurrence_attrs(bc, lm, rm, valid)
    a_, b_, c_, pk = uniform_tail_cut(rl, canon.a, canon.b, canon.c, pk)
    canon = W3(a_, b_, c_).where(((pk >> 1) & 1) == 1, kc.SENTINEL)
    return _reduce_occurrences_raw(canon, pk)


def split_readset_blocks(rs, max_positions: int):
    """Split a barcode-sorted ReadSet into blocks at barcode boundaries
    (and pair boundaries for the unbarcoded prefix), each <= max_positions
    flat bases where a cut allows it — so no barcode spans two blocks and
    per-block nbc values sum exactly.  Returns a list of ReadSets (views)."""
    if int(rs.offsets[-1]) <= max_positions:
        return [rs]
    # candidate cut points (read indices): barcode starts from bci; the
    # unbarcoded block [bci[0], bci[1]) may be cut at any pair boundary
    cuts = set(int(x) for x in rs.bci[1:-1])
    cuts.update(range(0, int(rs.bci[1]) + 1, 2))
    cuts.add(rs.n_reads)
    blocks = []
    start = prev = 0
    for c in sorted(c for c in cuts if 0 < c <= rs.n_reads):
        if int(rs.offsets[c] - rs.offsets[start]) > max_positions and prev > start:
            blocks.append((start, prev))
            start = prev
        prev = c
    blocks.append((start, rs.n_reads))
    out = []
    for lo, hi in blocks:
        o0, o1 = int(rs.offsets[lo]), int(rs.offsets[hi])
        out.append(ReadSet(
            codes=rs.codes[o0:o1], offsets=rs.offsets[lo : hi + 1] - o0,
            quals=rs.quals[o0:o1], bc=rs.bc[lo:hi],
            # barcode ids stay global; only the read ranges are re-based
            bci=np.clip(rs.bci - lo, 0, hi - lo), barcoded=rs.barcoded,
        ))
    return out


def merge_raw_blocks(wa, wb, wc, count, stats, min_freq: int, min_bc: int) -> KmerTable:
    """Concatenated per-block raw rows -> filtered KmerTable, one row per
    distinct kmer (kept rows first, then sentinel rows).

    Blocks are barcode-disjoint, so per kmer: count = sum, nbc = sum clamped
    at 4095 (per-block values are clamped; the clamped sum equals the
    single-block clamp), masks = OR, has_ign = OR; then the reference
    filter.  K4 sorts the rows by their 3 words; the per-run sums and ORs
    are index_add_ reductions over run ids; K2 compacts the kept runs'
    7 columns."""
    dev = wa.device
    perm = kc.lex_argsort(wa, wb, wc)
    ws = W3(wa, wb, wc).gather(perm)
    count, stats = count[perm], stats[perm]
    del perm
    starts = seg.run_starts(ws.a, ws.b, ws.c)
    rid = torch.cumsum(starts, 0) - 1
    first = torch.nonzero(starts).squeeze(1)
    nruns = first.shape[0]

    def run_sum(x):
        return torch.zeros(nruns, dtype=torch.int64, device=dev).index_add_(0, rid, x.long())

    total = run_sum(count)
    nbc = run_sum((stats >> 9) & 4095).clamp(max=4095)
    ign = run_sum(stats & 1) > 0
    lm = torch.zeros(nruns, dtype=torch.int64, device=dev)
    rm = torch.zeros(nruns, dtype=torch.int64, device=dev)
    for b in range(4):
        lm |= (run_sum((stats >> (5 + b)) & 1) > 0).long() << b
        rm |= (run_sum((stats >> (1 + b)) & 1) > 0).long() << b
    del rid, count, stats
    words = ws.gather(first)
    keep = ~kc.is_sentinel(words) & (total >= min_freq) & (ign | (nbc >= min_bc))
    i32 = torch.int32
    n_valid, (a2, b2, c2, t2, n2, l2, r2) = seg.compact_sorted_words(
        keep, words.a, words.b, words.c, total.to(i32), nbc.to(i32), lm.to(i32), rm.to(i32)
    )
    m = torch.arange(nruns, device=dev) < n_valid
    return KmerTable(W3(a2, b2, c2).where(m, kc.SENTINEL), t2, n2, l2, r2, n_valid)


def merge_row_limit(device: torch.device) -> int:
    """Raw rows one device merge can take: the card's free memory (the
    caching allocator's idle bytes included) over MERGE_BYTES_PER_ROW.
    The CPU (the tests' device) sets no limit."""
    if device.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    idle = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return (free + idle) // MERGE_BYTES_PER_ROW


def count_readset_blocked(rs, device, min_freq: int | None = None, min_bc: int | None = None,
                          max_positions: int | None = None, info: dict | None = None
                          ) -> KmerTable:
    """Blocked count: per-block unfiltered raw tables (distinct-kmer scale,
    pulled to host memory block by block), then ONE device merge + filter
    and the adjacency recompute.  Bit-identical to the single-block count.

    max_positions: bases per block (BLOCK_POSITIONS when None).  info, when
    given, receives blocks, block_rows and raw_rows."""
    from ..dbg.build import trim_table

    device = torch.device(device)
    min_freq = MIN_FREQ if min_freq is None else min_freq
    min_bc = MIN_BC if min_bc is None else min_bc
    if _uniform_rl(rs) is None:
        raise NotImplementedError(
            "blocked counting of mixed-length readsets (the reference's "
            "count_block_raw) is not ported: ROADMAP queue"
        )
    blocks = split_readset_blocks(rs, max_positions or BLOCK_POSITIONS)
    # every block pads to the largest one, as the reference's shared shape
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    t = lambda a: torch.from_numpy(a).to(device)
    parts = []
    for b in blocks:
        p = prepare_reads_packed(b, pad_to_positions=pad_pos)
        raw = count_block_raw_packed(
            t(p["codes_packed"]), t(p["glen"]), t(p["read_bc"]), p["n_reads"],
            p["uniform_rl"], p["nbp"],
        )
        nv = int(raw.n_valid)
        parts.append(tuple(x[:nv].cpu() for x in (*raw.words, raw.count, raw.stats)))
        del raw
    tot = sum(p[0].shape[0] for p in parts)
    if info is not None:
        info.update(blocks=len(blocks), block_rows=[p[0].shape[0] for p in parts],
                    raw_rows=tot)
    limit = merge_row_limit(device)
    if tot > limit:
        raise NotImplementedError(
            f"{tot} raw rows exceed one device merge ({limit} rows at "
            f"{MERGE_BYTES_PER_ROW} B/row); the partitioned host merge is not "
            "ported: ROADMAP queue"
        )
    cols = [torch.cat([p[j] for p in parts]).to(device) for j in range(5)]
    del parts
    table = merge_raw_blocks(*cols, min_freq, min_bc)
    del cols
    return recompute_adjacencies(trim_table(table))


def count_readset(rs, device, min_freq: int | None = None,
                  min_bc: int | None = None, info: dict | None = None) -> KmerTable:
    """ReadSet -> filtered, adjacency-true KmerTable on `device`.

    Readsets above BLOCK_POSITIONS bases take the blocked count (`info`
    receives its block and row counts).  The table is trimmed to the
    geometric-ladder row count before the adjacency recompute, so its
    membership joins run at table scale."""
    from ..dbg.build import trim_table

    min_freq = MIN_FREQ if min_freq is None else min_freq
    min_bc = MIN_BC if min_bc is None else min_bc
    if int(rs.offsets[-1]) > BLOCK_POSITIONS:
        return count_readset_blocked(rs, device, min_freq, min_bc, info=info)
    inp = prepare_reads(rs, device)
    table = count_kmers(
        inp["codes_ext"], inp["pos_read"], inp["glen_pos"], inp["bc_pos"],
        min_freq=min_freq, min_bc=min_bc, uniform_rl=inp["uniform_rl"],
    )
    return recompute_adjacencies(trim_table(table))
