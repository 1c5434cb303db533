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

Readsets above one block's flat bases take the blocked count
(`count_readset_blocked`).  A block's size is `count_block_positions`: on
a card the free memory over COUNT_BYTES_PER_POSITION, on the CPU (the
tests' device) the reference's BLOCK_POSITIONS.  The readset is cut at
barcode boundaries into blocks, each block is counted WITHOUT the filter
into a raw table of its distinct kmers, spilled to disk at 20 B a row and
memory-mapped back (kmer/spill.py; a killed count resumes block by block,
in the blocks its spill records), and the raw rows are merged + filtered
on the card: in one merge when they fit the card's
merge budget, else in kmer-range partitions, each merged on the card and
pulled back, then finalized on the card (trim + chunked adjacency
recompute).  `count_readset` halves the block size and retries when the
card runs out of memory.  Bit-identical to the single-block count.  Each
block goes to the card as 2-bit packed codes and per-read attributes
(`prepare_reads`); a uniform-length block cuts its reads' last K-1
positions before the sort, a mixed-length one (10x R1 is 23 bases shorter
than R2) keeps every position as a sort row.
"""
from __future__ import annotations

import gc
import logging
from typing import NamedTuple

import numpy as np
import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..ingest.feudal import pack_codes
from ..ingest.reads import ReadSet
from ..ops import segments as seg
from ..ops.kernels.run_reduce import run_reduce, run_stats_plain
from ..ops.kernels.scan_max import scan_max
from ..stats.trace import count_rows, span, upload
from . import spill

log = logging.getLogger("supernova_tpu_torch")

MIN_QUAL = 7
MIN_FREQ = 3
MIN_BC = 2
BC_IGNORED = -1  # occurrences whose barcode is untracked
BC_FIELD_IGNORED = 0x3FFFFF  # 22-bit barcode field; all-ones = "ignored"
BASE_BUCKET = 16384  # flat-base padding of mixed-length readsets
READ_BUCKET = 1024  # read-count padding
# flat bases one count block holds in the reference, sized for a 16 GB
# chip (supernova_tpu/kmer/count.py BLOCK_POSITIONS): the block on the CPU
# (the tests' device); on a card the count and the pather size their
# blocks from its free memory (count_block_positions, and
# align/pather.py path_block_positions).  The output does not depend on the
# block size.
BLOCK_POSITIONS = 96_000_000
# halving_retry (the count and the pather) halves the block size on a
# device OOM down to this; no budget goes below it
MIN_BLOCK_POSITIONS = 24_000_000
# the largest block: prepare_reads carries a block's read offsets in int32
# and K4 (ops/kernels/sort.py) sorts fewer than 2^31 rows with 32-bit row
# indices; a block's sort rows are at most its positions plus a read
# bucket's padding (< 2^20).  A multiple of 2^20.
MAX_BLOCK_POSITIONS = (1 << 31) - (1 << 20)
# derived budgets are whole multiples of this many positions
BLOCK_QUANTUM = 1 << 20
# peak device bytes per position of one count block (prepare_reads' inputs
# on the card, extraction, K4's sort with its gathers, K3, K2) that the
# caching allocator reserves, its segments' slack included: 174.2 measured
# on an H100 80GB HBM3 (700 W) by chip_smoke.py's genome-count phase
# (7.787 GiB reserved at 48M positions, 15.287 GiB at 96M = 171.0; the
# tensors alone 150.9: 6.753 and 13.496 GiB), rounded up
COUNT_BYTES_PER_POSITION = 176
# peak device bytes per raw row of merge_raw_blocks, its inputs included,
# when every row is a distinct kmer (its worst case): 178.7 measured on an
# H100 by chip_smoke.py's merge phase, rounded up
MERGE_BYTES_PER_ROW = 192
# peak device bytes per joined row (table + query chunk) of one membership
# join of recompute_adjacencies, the chunk's neighbour words included:
# 153.1 measured on an H100 by chip_smoke.py's scale phase (a chunk of the
# whole table, the costliest per row), rounded up
JOIN_BYTES_PER_ROW = 160


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


def extract_occurrences(codes_ext, pos_read, glen_pos, bc_pos, min_read_len: int = K + 1):
    """Per-position canonical kmer occurrences (the Kmerizer::map phase).

    codes_ext: (NB + >=K,) int32 codes, zero tail; pos_read/glen_pos/bc_pos:
    (NB,) per-position read id, good length and barcode.  Reads below
    min_read_len good bases contribute nothing; the patch rebuild passes K
    so that single-kmer edges survive.
    -> (canon W3 with sentinel at invalid rows, bc, lm, rm, valid)."""
    nb = pos_read.shape[0]
    dev = pos_read.device
    p = torch.arange(nb, device=dev)
    canon, flipped = kc.canonicalize(kc.sliding_words(codes_ext, nb))

    read_first = torch.ones(nb, dtype=torch.bool, device=dev)
    read_first[1:] = pos_read[1:] != pos_read[:-1]
    start = scan_max(None, read_first, 0)
    pir = p - start  # position in read
    glen = glen_pos.to(torch.int64)
    valid = (pir + K <= glen) & (glen >= min_read_len)

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


def sort_occurrence_rows(canon: W3, packed):
    """The (kmer, packed attrs) rows sorted (K4 on the card) -> (words, attrs)."""
    ws, (pk,), _ = kc.sort_by_words(canon, extra_keys=(packed,))
    return ws, pk


def _reduce_packed(canon: W3, packed, min_freq: int, min_bc: int) -> KmerTable:
    """Sort (kmer, packed attrs) rows and reduce each run into a filtered
    KmerTable padded to the row count."""
    return _reduce_sorted(*sort_occurrence_rows(canon, packed), min_freq, min_bc)


def _reduce_sorted(ws: W3, pk, min_freq: int, min_bc: int) -> KmerTable:
    """Reduce each run of the sorted rows into a filtered KmerTable padded
    to the row count."""
    if ws.a.device.type == "cuda":
        # fused: all per-run statistics + the keep decision in one pass (K3),
        # then a stable compaction of the kept run ends (K2), which also
        # writes the sentinel/zero tail
        keep, count, stats = run_reduce(ws.a, ws.b, ws.c, pk, min_freq, min_bc)
        n_valid, (wa, wb, wc, c2, st2) = seg.compact_sorted_words(
            keep, ws.a, ws.b, ws.c, count, stats, word_fill=kc.SENTINEL
        )
        nbc2, l2, r2 = (st2 >> 9) & 4095, (st2 >> 5) & 15, (st2 >> 1) & 15
    else:
        ends, real, count, nbc, ign, lm, rm = run_stats_plain(ws.a, ws.b, ws.c, pk)
        keep = ends & real & (count >= min_freq) & (ign | (nbc >= min_bc))
        i32 = torch.int32
        n_valid, (wa, wb, wc, c2, nbc2, l2, r2) = seg.compact_sorted_words(
            keep, ws.a, ws.b, ws.c, count.to(i32), nbc.to(i32), lm.to(i32), rm.to(i32),
            word_fill=kc.SENTINEL,
        )
    return KmerTable(W3(wa, wb, wc), c2, nbc2, l2, r2, n_valid)


def reduce_occurrences(canon: W3, bc, lm, rm, valid, min_freq: int = MIN_FREQ,
                       min_bc: int = MIN_BC) -> KmerTable:
    """Sort occurrence rows and reduce each run (the Kmerizer::reduce phase)."""
    return _reduce_packed(canon, pack_occurrence_attrs(bc, lm, rm, valid), min_freq, min_bc)


def occurrence_rows(codes_ext, pos_read, glen_pos, bc_pos, uniform_rl: int | None = None,
                    min_read_len: int = K + 1):
    """The sort rows of one block: (canonical words, packed attributes) of
    every position, invalid rows holding the sentinel.

    uniform_rl: every read (host padding included) is laid out in blocks of
    this length, so the last K-1 positions of each block are cut before the
    sort (~30% of the rows at rl=150).  Mixed-length reads keep every
    position as a row."""
    canon, bc, lm, rm, valid = extract_occurrences(codes_ext, pos_read, glen_pos, bc_pos,
                                                   min_read_len)
    pk = pack_occurrence_attrs(bc, lm, rm, valid)
    if uniform_rl is not None:
        a_, b_, c_, pk = uniform_tail_cut(uniform_rl, canon.a, canon.b, canon.c, pk)
        canon = W3(a_, b_, c_).where(((pk >> 1) & 1) == 1, kc.SENTINEL)
    return canon, pk


def kmer_starts(lengths: np.ndarray) -> int:
    """Positions that start a K-mer in reads of these lengths."""
    return int(np.maximum(np.asarray(lengths, np.int64) - K + 1, 0).sum())


def count_sort_rows(rows: int, glen: np.ndarray, min_read_len: int) -> None:
    """Counts one occurrence sort of `rows` rows over reads of good lengths
    glen as sort_rows and dead_sort_rows (stats/trace.py count_rows): the
    live rows start a K-mer inside the good bases of a read of at least
    min_read_len of them; the others hold the sentinel (past a good length
    or a read's last K-1, shorter reads, the bucket padding)."""
    count_rows("sort", lambda: (rows, kmer_starts(glen[glen >= min_read_len])))


def count_kmers(codes_ext, pos_read, glen_pos, bc_pos, min_freq: int = MIN_FREQ,
                min_bc: int = MIN_BC, min_read_len: int = K + 1,
                uniform_rl: int | None = None) -> KmerTable:
    """Count + filter canonical 48-mers over all reads of one block."""
    canon, pk = occurrence_rows(codes_ext, pos_read, glen_pos, bc_pos, uniform_rl, min_read_len)
    return _reduce_packed(canon, pk, min_freq, min_bc)


def free_device_bytes(device: torch.device) -> int:
    """The card's free memory once the caching allocator has handed its
    idle segments back (torch.cuda.empty_cache): what a budget's fresh
    allocations can take.  Idle bytes left inside segments that a live
    tensor pins are not counted: an earlier stage's cached segments, split
    to its own tensors' sizes, need not hold a larger tensor (an H100
    pather block planned on them ran out of memory with 18 GiB of them
    idle)."""
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0]


def block_budget(free_bytes: int, bytes_per_position: int, cap: int) -> int:
    """Positions a block takes in free_bytes at bytes_per_position: at most
    cap, rounded down to a multiple of BLOCK_QUANTUM, and never below
    MIN_BLOCK_POSITIONS (a card with less room runs out of memory there,
    and halving_retry raises)."""
    n = min(max(free_bytes, 0) // bytes_per_position, cap)
    return max(MIN_BLOCK_POSITIONS, n // BLOCK_QUANTUM * BLOCK_QUANTUM)


def count_block_positions(device, free_bytes: int | None = None) -> int:
    """Flat bases one count block takes on `device`: the card's free memory
    (free_device_bytes, or free_bytes when given) over
    COUNT_BYTES_PER_POSITION, by block_budget, at most MAX_BLOCK_POSITIONS.
    The CPU (the tests' device) takes the reference's BLOCK_POSITIONS."""
    if torch.device(device).type != "cuda":
        return BLOCK_POSITIONS
    if free_bytes is None:
        free_bytes = free_device_bytes(torch.device(device))
    return block_budget(free_bytes, COUNT_BYTES_PER_POSITION, MAX_BLOCK_POSITIONS)


def join_chunk_rows(device: torch.device, m: int) -> int:
    """Query rows a membership join of recompute_adjacencies takes beside
    its m table rows: all m where table + queries fit the card's free
    memory at JOIN_BYTES_PER_ROW, else what fits (at least 2^20).  The CPU
    (the tests' device) sets no limit."""
    m = max(m, 1)
    if device.type != "cuda":
        return m
    return min(m, max(1 << 20, free_device_bytes(device) // JOIN_BYTES_PER_ROW - m))


def recompute_adjacencies(table: KmerTable, chunk: int | None = None,
                          dictionary: W3 | None = None) -> KmerTable:
    """Intersect observed extension masks with table membership
    (KmerDict::recomputeAdjacencies).

    The table's rows are queried `chunk` rows at a time (join_chunk_rows by
    default), so each of the 8 sort-merge joins a chunk takes sorts the
    table plus one chunk, not the table plus all its rows: the reference's
    bounded-memory recompute (recompute_adjacencies_host), on the card.
    dictionary: the sorted words whose membership counts (the table's own
    when None; a part of a table takes the whole one's)."""
    words = table.words
    dictionary = words if dictionary is None else dictionary
    m = words.a.shape[0]
    chunk = chunk or join_chunk_rows(words.a.device, dictionary.a.shape[0])
    new_r = torch.zeros_like(table.right_mask)
    new_l = torch.zeros_like(table.left_mask)
    for s in range(0, m, chunk):
        q = W3(*(w[s : s + chunk] for w in words))
        for b in range(4):
            succ, _ = kc.canonicalize(kc.successor_words(q, b))
            _, found = kc.lookup_words_merge(dictionary, succ)
            new_r[s : s + chunk] |= found.to(new_r.dtype) << b
            pred, _ = kc.canonicalize(kc.predecessor_words(q, b))
            _, found = kc.lookup_words_merge(dictionary, pred)
            new_l[s : s + chunk] |= found.to(new_l.dtype) << b
    return table._replace(
        left_mask=table.left_mask & new_l, right_mask=table.right_mask & new_r
    )


# ----------------------------------------------------------------- host prep
# good_lengths_np / prepare_reads_packed are host numpy in the reference
# too, but its module imports jax, so they are copied here; prepare_reads
# expands on the device what the reference's expands on the host
# (tests/test_torch_count.py and test_torch_mixed.py hold each equal to
# the original).

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


def prepare_reads(rs, device, pad_to_positions: int | None = None,
                  pad_to_reads: int | None = None) -> dict:
    """A ReadSet as per-position tensors on `device`: the reference's
    prepare_reads, same values and shapes.

    nbp = round_up(max(nb, 1, pad_to_positions), bucket) positions, the
    bucket rl*128 for uniform read length rl (the dict then carries
    `uniform_rl`) and BASE_BUCKET otherwise; rp = round_up(max(n_reads,
    pad_to_reads) + 1, READ_BUCKET) reads.  Padding positions belong to a
    fake empty read n_reads.  The pad_to_* arguments give sibling blocks one
    shape.  The host sends 2-bit packed codes and per-READ lengths, good
    lengths and barcodes; the per-position arrays are expanded on the
    device (~16x fewer bytes over the bus than expanded arrays).  The dict
    also keeps the reads' good lengths on the host (`good_lengths`, numpy),
    for count_sort_rows."""
    device = torch.device(device)
    nb = int(rs.offsets[-1])
    n_reads = rs.n_reads
    uniform_rl = _uniform_rl(rs)
    base_bucket = BASE_BUCKET if uniform_rl is None else uniform_rl * 128
    nbp = _round_up(max(nb, 1, pad_to_positions or 1), base_bucket)
    rp = _round_up(max(n_reads, pad_to_reads or 0) + 1, READ_BUCKET)

    codes = np.zeros(nbp, np.uint8)
    codes[:nb] = rs.codes
    offsets = np.full(rp + 1, nb, dtype=np.int32)
    offsets[: n_reads + 1] = rs.offsets
    read_bc = np.full(rp, BC_IGNORED, dtype=np.int32)
    if rs.barcoded:
        read_bc[:n_reads] = np.where(rs.bc > 0, rs.bc, BC_IGNORED)
    # per read, the fake read n_reads last: positions, length, good length
    reps = np.append(np.diff(rs.offsets), nbp - nb).astype(np.int64)
    rlen = np.append(reps[:n_reads], 0).astype(np.int32)
    good_lengths = good_lengths_np(rs.quals, rs.offsets)
    glen = np.append(good_lengths, 0).astype(np.int32)
    t = lambda a: upload(a, device)
    pos_read = torch.repeat_interleave(
        torch.arange(n_reads + 1, dtype=torch.int32, device=device), t(reps), output_size=nbp)
    per_pos = lambda a: torch.index_select(t(a), 0, pos_read)
    return dict(
        codes_ext=_unpack_codes_dev(t(pack_codes(codes)), nbp, max(K, 128)),
        read_offsets=t(offsets), pos_read=pos_read, glen_pos=per_pos(glen),
        bc_pos=per_pos(read_bc[: n_reads + 1]), rlen_pos=per_pos(rlen),
        read_bc=t(read_bc), uniform_rl=uniform_rl, good_lengths=good_lengths,
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


# ------------------------------------------- host canonicalization (numpy)
# Copies of the reference's numpy twins (supernova_tpu/kmer/count.py:336-355)
# on uint32 columns; asm/fillcheck.py canonicalizes its fill kmers with them.

def _rev16_np(w):
    w = ((w & np.uint32(0x33333333)) << np.uint32(2)) | (
        (w >> np.uint32(2)) & np.uint32(0x33333333)
    )
    w = ((w & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    )
    w = ((w & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (w >> np.uint32(8)) & np.uint32(0x00FF00FF)
    )
    return (w << np.uint32(16)) | (w >> np.uint32(16))


def _canon_np(a, b, c):
    """Numpy twin of kc.canonicalize on (a, b, c) uint32 columns."""
    ra, rb, rcw = _rev16_np(~c), _rev16_np(~b), _rev16_np(~a)
    flip = (ra < a) | ((ra == a) & ((rb < b) | ((rb == b) & (rcw < c))))
    return (
        np.where(flip, ra, a), np.where(flip, rb, b), np.where(flip, rcw, c)
    )


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


def _reduce_sorted_raw(ws: W3, pk) -> RawBlockTable:
    """Per-run reduce of the sorted rows WITHOUT the (min_freq, min_bc)
    filter: K3 with min_freq=1, min_bc=0 keeps every real run end (its
    plain twin on the CPU, which clamps nbc at 4095 as the reference's raw
    branch does)."""
    keep, count, stats = run_reduce(ws.a, ws.b, ws.c, pk, 1, 0)
    n_valid, (wa, wb, wc, c2, st2) = seg.compact_sorted_words(
        keep, ws.a, ws.b, ws.c, count, stats, word_fill=kc.SENTINEL
    )
    return RawBlockTable(W3(wa, wb, wc), c2, st2, n_valid)


def count_block_raw(codes_ext, pos_read, glen_pos, bc_pos,
                    uniform_rl: int | None = None, min_read_len: int = K + 1) -> RawBlockTable:
    """One block of the blocked count from per-position inputs
    (prepare_reads): extract (+ the tail cut for uniform reads) and sort
    (the sort step: K1, K4), then the raw reduce (the reduce step: K3,
    K2)."""
    dev = codes_ext.device
    with span("call.count.sort", dev):
        rows = sort_occurrence_rows(*occurrence_rows(codes_ext, pos_read, glen_pos, bc_pos,
                                                     uniform_rl, min_read_len))
    with span("call.count.reduce", dev):
        return _reduce_sorted_raw(*rows)


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
        keep, words.a, words.b, words.c, total.to(i32), nbc.to(i32), lm.to(i32), rm.to(i32),
        word_fill=kc.SENTINEL,
    )
    return KmerTable(W3(a2, b2, c2), t2, n2, l2, r2, n_valid)


def merge_row_limit(device: torch.device) -> int:
    """Raw rows one device merge can take: the card's free memory
    (free_device_bytes) over MERGE_BYTES_PER_ROW.
    The CPU (the tests' device) sets no limit."""
    if device.type != "cuda":
        return 1 << 62
    return free_device_bytes(device) // MERGE_BYTES_PER_ROW


def _u32_bits(w):
    """int64 words in [0, 2^32) -> int32 tensors with the same 32 bits."""
    return (w - ((w & 0x80000000) << 1)).to(torch.int32)


def _widen(x):
    """int32 bit patterns -> the port's int64 words in [0, 2^32)."""
    return x.long() & 0xFFFFFFFF


def raw_block_columns(raw: RawBlockTable) -> tuple[np.ndarray, ...]:
    """A block's kept raw rows as the spill's five host columns
    (spill.COLUMN_DTYPES): words narrowed to 32 bits on the device, then
    one copy each to the host."""
    nv = int(raw.n_valid)
    words = [_u32_bits(w[:nv]).cpu().numpy().view(np.uint32) for w in raw.words]
    return (*words, raw.count[:nv].cpu().numpy(), raw.stats[:nv].cpu().numpy().view(np.uint32))


class Partition(NamedTuple):
    """One kmer range of the partitioned merge: leading words below
    `hi_word`, made of rows [lo[i], hi[i]) of each block i."""

    hi_word: int
    lo: list
    hi: list
    rows: int


def plan_partitions(a_cols, merge_rows: int) -> list[Partition]:
    """Cut the blocks' raw rows into kmer-range partitions of about 0.75 x
    merge_rows rows (one partition when they all fit merge_rows).

    Each block is sorted by (a, b, c), so the splitters are quantiles of a
    sample of the leading words `a` (deduplicated: a partition never cuts
    a word, so partitions are kmer-disjoint), and each block gives each
    partition the slice that searchsorted finds on its `a` column
    (reference: _merge_blocks_partitioned)."""
    nblk = len(a_cols)
    tot = sum(len(a) for a in a_cols)
    if tot <= merge_rows:
        return [Partition(1 << 32, [0] * nblk, [len(a) for a in a_cols], tot)]
    n_parts = max(2, -(-tot // max(1, int(merge_rows * 0.75))))
    sample = np.concatenate([a[:: max(1, len(a) // 65536)] for a in a_cols])
    sample.sort()
    qs = np.unique(sample[(np.arange(1, n_parts) * (len(sample) / n_parts)).astype(np.int64)])
    # the last bound exceeds every word (a real kmer's leading word may be
    # 0xFFFFFFFF); a uint32 bound keeps searchsorted from copying a column
    parts, lo = [], [0] * nblk
    for hi_word in [*(int(q) for q in qs), 1 << 32]:
        hi = [len(a) if hi_word >> 32 else int(np.searchsorted(a, np.uint32(hi_word)))
              for a in a_cols]
        rows = sum(h - l for h, l in zip(hi, lo))
        if rows:
            parts.append(Partition(hi_word, lo, hi, rows))
        lo = hi
    return parts


def merge_blocks(blocks, device, min_freq: int, min_bc: int, merge_rows: int | None = None,
                 info: dict | None = None) -> KmerTable:
    """Blocks' raw rows (five host columns a block, spill.COLUMN_DTYPES,
    each block sorted) -> the filtered table on `device`, trimmed to the
    geometric-ladder row count (no adjacency recompute yet).

    The rows are merged in kmer-range partitions of plan_partitions
    (merge_rows defaults to merge_row_limit: one partition when every row
    fits one merge).  Each partition's block slices are gathered into
    pinned host buffers (one a column, sized once at the largest
    partition), copied to the card, merged by merge_raw_blocks (K4, K2) and,
    when there are several, pulled back: partitions are ascending kmer
    ranges, so their kept rows concatenate into the sorted table.  A
    partition above merge_rows (one leading word dominating) runs widened
    if the card's budget takes it, else raises.  info receives partitions,
    partition_rows and peak_rss_gb."""
    from ..dbg.build import trim_table

    device = torch.device(device)
    limit = merge_row_limit(device)
    merge_rows = merge_rows or limit
    parts = plan_partitions([b[0] for b in blocks], merge_rows)
    for p in parts:
        if p.rows > max(merge_rows, limit):
            raise RuntimeError(
                f"merge partition below leading word {p.hi_word} holds {p.rows} raw rows, "
                f"more than one device merge takes ({limit} rows at {MERGE_BYTES_PER_ROW} "
                "B/row): one leading word dominates the raw rows"
            )
    if info is not None:
        info.update(partitions=len(parts), partition_rows=[p.rows for p in parts])
    pin = device.type == "cuda"
    bufs = [torch.empty(max(p.rows for p in parts), dtype=torch.int32, pin_memory=pin)
            for _ in spill.COLUMN_DTYPES]
    kept = []
    for p in parts:
        for j, (buf, dt) in enumerate(zip(bufs, spill.COLUMN_DTYPES)):
            dst, k = buf.numpy().view(dt), 0
            for b, lo, hi in zip(blocks, p.lo, p.hi):
                dst[k : k + hi - lo] = b[j][lo:hi]
                k += hi - lo
        _sample_rss(info)
        cols = [buf[: p.rows].to(device, non_blocking=True) for buf in bufs]
        words = [_widen(c) for c in cols[:3]]
        count, stats = cols[3], cols[4]
        del cols
        table = merge_raw_blocks(*words, count, stats, min_freq, min_bc)
        del words, count, stats
        if len(parts) == 1:
            break
        nv = int(table.n_valid)  # also: the pinned buffers are free again
        kept.append([_u32_bits(w[:nv]).cpu() for w in table.words]
                    + [x[:nv].cpu() for x in table[1:5]])
        log.info("blocked count: merge partition <%d: %d rows -> %d kept - rss=%.1f GB",
                 p.hi_word, p.rows, nv, _rss_gb())
        del table
    del bufs
    if kept:
        cols = [torch.cat(c).to(device) for c in zip(*kept)]
        del kept
        n = cols[0].shape[0]
        table = KmerTable(W3(*(_widen(c) for c in cols[:3])), *cols[3:],
                          torch.tensor(n, dtype=torch.int64, device=device))
        del cols
    _sample_rss(info)
    return trim_table(table)


def planned_block_positions(rs, device, min_freq: int, min_bc: int, spill_dir=None) -> int:
    """The block size of a count with no explicit one: the size recorded in
    spill_dir's meta when the directory holds a count of this readset (its
    read count and filter), so that a resumed count keeps its blocks
    whatever the card has free now; else count_block_positions(device)."""
    meta = spill.read_meta(spill_dir) if spill_dir is not None else None
    if meta and "block_positions" in meta and (meta.get("n_reads"), meta.get("min_freq"),
                                               meta.get("min_bc")) == (
            int(rs.n_reads), int(min_freq), int(min_bc)):
        return int(meta["block_positions"])
    return count_block_positions(device)


def count_readset_blocked(rs, device, min_freq: int | None = None, min_bc: int | None = None,
                          min_read_len: int = K + 1, max_positions: int | None = None,
                          merge_rows: int | None = None, spill_dir=None,
                          info: dict | None = None) -> KmerTable:
    """Blocked count: per-block unfiltered raw tables (distinct-kmer scale),
    spilled block by block (kmer/spill.py), then merge_blocks and the
    adjacency recompute on the card.  Bit-identical to the single-block
    count, whatever the block size and the partitions.

    max_positions: bases per block (planned_block_positions when None: a
    resumed spill directory's, else the device's budget).
    merge_rows: raw rows per device merge (merge_row_limit when None).
    spill_dir: where the blocks spill; a killed count resumes there (blocks
    with a done marker are not recounted) and its owner removes it; None
    spills to a temporary directory removed on return.  info, when given,
    receives blocks, block_rows, raw_rows, block_positions, spilled_blocks,
    resumed_blocks, and merge_blocks' keys."""
    device = torch.device(device)
    min_freq = MIN_FREQ if min_freq is None else min_freq
    min_bc = MIN_BC if min_bc is None else min_bc
    max_positions = max_positions or planned_block_positions(rs, device, min_freq, min_bc,
                                                             spill_dir)
    blocks = split_readset_blocks(rs, max_positions)
    # every block pads to the largest one, as the reference's shared shape
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    meta = dict(n_blocks=len(blocks), pad_pos=pad_pos, pad_rd=pad_rd,
                n_reads=int(rs.n_reads), min_freq=int(min_freq), min_bc=int(min_bc),
                block_positions=int(max_positions))

    def count_block(i):
        with span("call.count.prep", device):
            p = prepare_reads(blocks[i], device, pad_to_positions=pad_pos, pad_to_reads=pad_rd)
        raw = count_block_raw(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                              p["uniform_rl"], min_read_len)
        count_sort_rows(raw.count.shape[0], p["good_lengths"], min_read_len)
        if i == 0:  # the raw table keeps the sort's row count
            _first_block(info, p, raw.count)
        return raw

    with spill.SpillDir(spill_dir, meta) as sd:
        pending = [i for i in range(len(blocks)) if not sd.done(i)]
        log.info("blocked count: %d blocks at <=%d positions, %d already spilled - %s",
                 len(blocks), max_positions, len(blocks) - len(pending), _device_memory(device))
        for i in pending:
            raw = count_block(i)
            # drop the block's device buffers before the next block (and,
            # after the last, before the merge reads its budget)
            rows = len(sd.save(i, raw_block_columns(raw))[0])
            del raw
            _sample_rss(info)
            log.info("blocked count: block %d/%d -> %d rows - rss=%.1f GB",
                     i + 1, len(blocks), rows, _rss_gb())
        cols = [sd.load(i) for i in range(len(blocks))]
        block_rows = [len(c[0]) for c in cols]
        if info is not None:
            info.update(blocks=len(blocks), block_rows=block_rows, raw_rows=sum(block_rows),
                        block_positions=max_positions, spilled_blocks=len(pending),
                        resumed_blocks=len(blocks) - len(pending))
        log.info("blocked count: merging %d raw rows - %s, rss=%.1f GB",
                 sum(block_rows), _device_memory(device), _rss_gb())
        with span("call.count.reduce", device):
            table = merge_blocks(cols, device, min_freq, min_bc, merge_rows, info)
        del cols  # release the memory maps before the directory goes
    with span("call.count.recompute", device):
        return recompute_adjacencies(table)


def _first_block(info: dict | None, inp: dict, sort_col) -> None:
    """info receives the first counted block's shapes: first_block_positions
    (prepare_reads' positions, padding included) and first_block_sort_rows
    (the rows of sort_col, a column as long as the block's sort)."""
    if info is not None:
        info.update(first_block_positions=int(inp["pos_read"].shape[0]),
                    first_block_sort_rows=int(sort_col.shape[0]))


def _rss_gb() -> float:
    """The process's resident set in GB (reference: count.py _rss_gb)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return -1.0


def _sample_rss(info: dict | None) -> None:
    """Keep the largest _rss_gb() seen as info["peak_rss_gb"]."""
    if info is not None:
        info["peak_rss_gb"] = max(info.get("peak_rss_gb", 0.0), _rss_gb())


def _device_memory(device: torch.device) -> str:
    """The card's allocator state in one line, for OOM forensics ('' off
    CUDA); the counterpart of the reference's _hbm_in_use."""
    if device.type != "cuda":
        return ""
    gib = 1 << 30
    return (f"device {torch.cuda.memory_allocated(device) / gib:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved(device) / gib:.2f} reserved, "
            f"peak {torch.cuda.max_memory_allocated(device) / gib:.2f}")


def _free_failed_attempt(e: BaseException) -> None:
    """Release a failed attempt's device memory before the retry: the
    traceback of every exception in the chain pins the raising frames and
    with them the attempt's tensors, so clear them all, collect, and
    release the caching allocator's idle blocks."""
    seen = set()
    x = e
    while x is not None and id(x) not in seen:
        seen.add(id(x))
        x.__traceback__ = None
        x = x.__cause__ or x.__context__
    gc.collect()
    torch.cuda.empty_cache()


def halving_retry(what: str, device: torch.device, info: dict | None, attempt,
                  max_positions: int):
    """attempt(max_positions); on a device OOM the failed attempt is freed
    and the block size halved, down to MIN_BLOCK_POSITIONS (smaller blocks
    on the same card: the blocked count and pather give the same output at
    any block size).  Any other error, or an OOM at the smallest size,
    raises.  info receives oom_retries."""
    max_pos, retries = max_positions, 0
    while True:
        try:
            out = attempt(max_pos)
            break
        except torch.cuda.OutOfMemoryError as e:
            if max_pos // 2 < MIN_BLOCK_POSITIONS:
                raise
            log.warning("%s: device OOM at block=%d positions (%s; %.120s); "
                        "retrying with block=%d", what, max_pos, _device_memory(device), e,
                        max_pos // 2)
            _free_failed_attempt(e)
            max_pos //= 2
            retries += 1
    if info is not None:
        info["oom_retries"] = retries
    return out


def count_readset(rs, device, min_freq: int | None = None, min_bc: int | None = None,
                  min_read_len: int = K + 1, info: dict | None = None,
                  spill_dir=None, max_positions: int | None = None) -> KmerTable:
    """ReadSet -> filtered, adjacency-true KmerTable on `device`.

    max_positions: bases a block takes (planned_block_positions when None:
    a resumed spill directory's, else the device's budget).  Readsets above
    it take the blocked count (`info` receives its counts, and oom_retries;
    spill_dir as there) under halving_retry, which starts from it; a
    smaller one is one block (info: blocks 1, block_positions).  The table
    is trimmed to the geometric-ladder row count before the adjacency
    recompute, so its membership joins run at table scale.  The call is
    the span call.count_readset, its steps call.count.prep, .sort, .reduce
    and .recompute (stats/trace.py; a block's steps in the blocked count);
    every block's occurrence sort is counted by count_sort_rows."""
    from ..dbg.build import trim_table

    device = torch.device(device)
    min_freq = MIN_FREQ if min_freq is None else min_freq
    min_bc = MIN_BC if min_bc is None else min_bc
    with span("call.count_readset", device):
        max_positions = max_positions or planned_block_positions(rs, device, min_freq, min_bc,
                                                                 spill_dir)
        if int(rs.offsets[-1]) > max_positions:
            return halving_retry("count", device, info, lambda max_pos: count_readset_blocked(
                rs, device, min_freq, min_bc, min_read_len, max_positions=max_pos,
                spill_dir=spill_dir, info=info), max_positions)
        if info is not None:
            info.update(blocks=1, block_positions=int(max_positions))
        with span("call.count.prep", device):
            inp = prepare_reads(rs, device)
        with span("call.count.sort", device):
            rows = occurrence_rows(inp["codes_ext"], inp["pos_read"], inp["glen_pos"],
                                   inp["bc_pos"], inp["uniform_rl"], min_read_len)
            _first_block(info, inp, rows[1])
            count_sort_rows(rows[1].shape[0], inp["good_lengths"], min_read_len)
            ws, pk = sort_occurrence_rows(*rows)
        with span("call.count.reduce", device):
            table = _reduce_sorted(ws, pk, min_freq, min_bc)
            del rows, ws, pk
            trimmed = trim_table(table)
        with span("call.count.recompute", device):
            return recompute_adjacencies(trimmed)
