"""Multi-shard 48-mer counting: data-parallel reads, hash-sharded kmer space
(port of supernova_tpu/parallel/sharded_count.py).

Reads are split across the shards; each shard extracts its canonical kmer
occurrence rows (K1), the rows are exchanged by a kmer hash so that every
copy of a kmer lands on one shard (the reference's MSP shuffle, which makes
shard-local counting + filtering exact), and each shard sorts (K4) and
reduces (K3, K2) its slice of kmer space with the port's own count
functions.  The exchange is the reference's ragged one (mesh.exchange):
only real rows move, and `capacity` bounds the rows a shard receives (the
overflow the Pipeline answers with a single-device recount).

The result is a KmerTable per shard (rows of its own length, on its
shard's device); merge_shard_tables re-sorts the disjoint shard tables into
the one lexicographic table the graph builder consumes.  Left out as
TPU/XLA workarounds: the dense fixed-capacity exchange XLA:CPU needs for
lack of a ragged all-to-all, and split_readset's shape-bucket padding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import W3
from ..ingest.reads import ReadSet
from ..kmer import count as kcount
from ..kmer.count import MIN_BC, MIN_FREQ, KmerTable
from ..ops.kernels.sort import lex_argsort
from .mesh import AXIS, CHIP_AXIS, HOST_AXIS, Mesh, Sharded

M32 = 0xFFFFFFFF


def kmer_shard_hash(words: W3) -> torch.Tensor:
    """Mix the 3 kmer words into a well-distributed uint32 (murmur-style),
    held in int64: every multiply and left shift is masked to 32 bits
    (int64 products wrap mod 2^64, so their low 32 bits are right)."""

    def rotl(x, r):
        return ((x << r) & M32) | (x >> (32 - r))

    h = torch.full_like(words.a, 0x9E3779B9)
    for wj in words:
        k = (wj * 0xCC9E2D51) & M32
        k = (rotl(k, 15) * 0x1B873593) & M32
        h = rotl(h ^ k, 13)
        h = (h * 5 + 0xE6546B64) & M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    return h ^ (h >> 13)


def _occurrences(inp: dict):
    """One shard's occurrence rows: (rows, 4) [a, b, c, packed attributes]
    and each row's validity."""
    canon, pk = kcount.occurrence_rows(inp["codes_ext"], inp["pos_read"], inp["glen_pos"],
                                       inp["bc_pos"], inp["uniform_rl"])
    return torch.stack([canon.a, canon.b, canon.c, pk], 1), ((pk >> 1) & 1) == 1


def _reduce(rows: torch.Tensor, min_freq: int, min_bc: int) -> KmerTable:
    """A shard's received occurrence rows -> its filtered KmerTable (one
    sentinel row stands in for none)."""
    if rows.shape[0] == 0:
        rows = torch.tensor([[kc.SENTINEL] * 3 + [0]], dtype=torch.int64, device=rows.device)
    canon = W3(*(rows[:, j].contiguous() for j in range(3)))
    return kcount._reduce_packed(canon, rows[:, 3].contiguous(), min_freq, min_bc)


def sharded_count(mesh: Mesh, inputs, capacity: int, min_freq: int = MIN_FREQ,
                  min_bc: int = MIN_BC):
    """Multi-shard counting step over a 1-D mesh (a fleet's flat mesh too,
    whose exchange crosses the processes): `inputs` are this process's
    shards' prepare_reads dicts (split_readset) -> (its per-shard
    KmerTables, its per-shard overflow: rows past `capacity`, rounded up to
    a multiple of the shard count as in the reference; mesh.psum totals
    it).  The reference's _sharded_count_local body,
    every shard a step at a time: extract, route by kmer hash, reduce."""
    n_dev = mesh.size
    capacity = -(-capacity // n_dev) * n_dev
    cols, keys = [], []
    for inp in inputs:
        rows, valid = _occurrences(inp)
        cols.append(rows)
        w = W3(rows[:, 0], rows[:, 1], rows[:, 2])
        keys.append(torch.where(valid, kmer_shard_hash(w) % n_dev, n_dev))
    recv, _, dropped = mesh.exchange(cols, keys, n_dev, AXIS, capacity)
    return Sharded([_reduce(r, min_freq, min_bc) for r in recv], mesh), dropped


# ------------------------------------------- 2-D ("host","chip") mesh path

def sharded_count_hier(mesh: Mesh, inputs, capacity: int, min_freq: int = MIN_FREQ,
                       min_bc: int = MIN_BC):
    """Counting over a make_mesh2 / fleet ("host","chip") mesh with the
    hierarchical shuffle (the reference's _sharded_count_local_hier body):
    each row crosses the host axis once, in C-times-larger per-host
    messages:
      phase 1 (chip axis): chip j of a host gathers the rows whose
        destination host h* has h* % C == j;
      phase 2 (host axis): to the destination host (landing on chip j);
      phase 3 (chip axis): to the destination chip.
    The destination shard is the flat count's hash % (H*C), so the shard
    tables equal sharded_count's over H*C shards (host-major); every
    shard's overflow is the mesh's total."""
    capacity = -(-capacity // mesh.size) * mesh.size
    H, C = mesh.shape
    n_shards = H * C
    cols, keys = [], []
    for inp in inputs:
        rows, valid = _occurrences(inp)
        dest = kmer_shard_hash(W3(rows[:, 0], rows[:, 1], rows[:, 2])) % n_shards
        cols.append(torch.cat([rows, dest[:, None]], 1))
        keys.append(torch.where(valid, (dest // C) % C, C))
    cols, _, d1 = mesh.exchange(cols, keys, C, CHIP_AXIS, capacity)
    cols, _, d2 = mesh.exchange(cols, [c[:, 4] // C for c in cols], H, HOST_AXIS, capacity)
    cols, _, d3 = mesh.exchange(cols, [c[:, 4] % C for c in cols], C, CHIP_AXIS, capacity)
    overflow = mesh.psum(a + b + c for a, b, c in zip(d1, d2, d3))
    tables = Sharded([_reduce(c[:, :4], min_freq, min_bc) for c in cols], mesh)
    return tables, [overflow] * len(tables)


# ------------------------------------------------------------------- host

def _read_range(rs: ReadSet, lo: int, hi: int) -> ReadSet:
    """Reads [lo, hi) of `rs` as a ReadSet (views; barcode ids global)."""
    o0, o1 = int(rs.offsets[lo]), int(rs.offsets[hi])
    return ReadSet(codes=rs.codes[o0:o1], offsets=rs.offsets[lo:hi + 1] - o0,
                   quals=rs.quals[o0:o1], bc=rs.bc[lo:hi],
                   bci=np.clip(rs.bci - lo, 0, hi - lo), barcoded=rs.barcoded)


def read_blocks(rs: ReadSet, n_dev: int) -> list[tuple[int, int]]:
    """The shards' read ranges: equal runs of pairs, so mates stay
    together (the reference's split)."""
    per = -(-rs.n_pairs // n_dev)
    return [(min(d * per * 2, rs.n_reads), min((d + 1) * per * 2, rs.n_reads))
            for d in range(n_dev)]


def split_readset(rs: ReadSet, mesh: Mesh):
    """A ReadSet -> (this process's shards' prepare_reads inputs, each on its
    shard's device, and nbl: the largest shard's positions, the unit the
    Pipeline's capacity is counted in).  A uniform-length shard carries its
    read length, so its reads' last K-1 positions are cut before the
    exchange, as in the reference."""
    blocks = read_blocks(rs, mesh.size)
    nbl = max(max(int(rs.offsets[hi] - rs.offsets[lo]) for lo, hi in blocks), 1)
    inputs = Sharded([kcount.prepare_reads(_read_range(rs, *blocks[mesh.global_index(i)]), d)
                      for i, d in enumerate(mesh.devices)], mesh)
    return inputs, nbl


def merge_shard_tables(tables, device) -> KmerTable:
    """Per-shard tables (disjoint in kmer space) -> one table on `device`:
    their valid rows concatenated and sorted lexicographically (K4),
    sentinel-padded to a multiple of 256 rows, as the reference's."""
    from .dist import from_global

    def leaf(get):
        if isinstance(tables, Sharded) and tables.mesh.group is not None:
            return torch.from_numpy(from_global(Sharded(
                [get(t)[: int(t.n_valid)] for t in tables], tables.mesh))).to(device)
        return torch.cat([get(t)[: int(t.n_valid)].to(device) for t in tables])

    a, b, c = (leaf(lambda t, j=j: t.words[j]) for j in range(3))
    rest = [leaf(lambda t, f=f: getattr(t, f)) for f in ("count", "nbc", "left_mask", "right_mask")]
    order = lex_argsort(a, b, c)
    n = a.shape[0]
    m = max(256, -(-n // 256) * 256)

    def pad(x, fill):
        out = torch.full((m,), fill, dtype=x.dtype, device=device)
        out[:n] = x[order]
        return out

    return KmerTable(W3(pad(a, kc.SENTINEL), pad(b, kc.SENTINEL), pad(c, kc.SENTINEL)),
                     *(pad(x, 0) for x in rest), torch.tensor(n, dtype=torch.int64, device=device))
