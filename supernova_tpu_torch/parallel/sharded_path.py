"""Multi-shard read pathing: data-parallel reads over a replicated or a
hash-sharded graph dictionary (port of supernova_tpu/parallel/sharded_path.py).

Pathing is embarrassingly parallel over reads: each shard paths its read
block with the general pather (align/pather.py: K1 for the query words, K4
for the merge join) against the dictionary replicated on its device
(`sharded_path`).  Above PATH_VS_DICT_ROWS dictionary rows the Pipeline
shards the dictionary itself by kmer hash (`shard_dictionary`), so no shard
holds all of it: `sharded_path_vs` routes each shard's query kmers to their
owner (mesh.exchange), answers them there with a shard-local merge join,
and returns the answers (give_back).  Per-read results equal
path_readset's either way.  On a fleet's flat mesh each process paths
its own shards' reads and gather_paths gathers every read's path onto
every process.  Left out: split_for_pathing's shape-bucket padding (each
shard's block keeps its own length).
"""
from __future__ import annotations

import torch

from ..align.pather import MAX_PATH, ReadPaths, general_queries, path_reads_impl, place_hits
from ..core import kmer_codec as kc
from ..core.kmer_codec import W3
from ..ingest.reads import ReadSet
from ..kmer import count as kcount
from .mesh import AXIS, Mesh, Sharded
from .sharded_count import _read_range, kmer_shard_hash, read_blocks


def sharded_path(mesh: Mesh, kmer_words: W3, node_edge, node_pos, from_v, to_v, edge_kmers,
                 inputs, max_path: int = MAX_PATH):
    """Each shard paths its block (`inputs`: split_for_pathing's
    prepare_reads dicts) against the replicated dictionary -> per shard
    ReadPaths (its block's rows padded as prepare_reads pads them)."""
    out = []
    for inp, dev in zip(inputs, mesh.devices):
        rep = lambda x: x.to(dev)
        out.append(path_reads_impl(
            W3(*(rep(w) for w in kmer_words)), rep(node_edge), rep(node_pos), rep(from_v),
            rep(to_v), rep(edge_kmers), inp["codes_ext"], inp["read_offsets"], inp["pos_read"],
            inp["rlen_pos"], max_path, inp["uniform_rl"]))
    return Sharded(out, mesh)


def split_for_pathing(rs: ReadSet, mesh: Mesh):
    """Per-shard read blocks for pathing (the count's split) -> (this
    process's shards' prepare_reads inputs, each shard's read range)."""
    blocks = read_blocks(rs, mesh.size)
    mine = [blocks[mesh.global_index(i)] for i in range(mesh.n_local)]
    inputs = Sharded([kcount.prepare_reads(_read_range(rs, lo, hi), d)
                      for (lo, hi), d in zip(mine, mesh.devices)], mesh)
    return inputs, mine


# ----------------------------------- value-sharded dictionary (pod scale)

def shard_dictionary(mesh: Mesh, kmer_words: W3, node_edge, node_pos):
    """Partition the sorted kmer dictionary by kmer_shard_hash % mesh.size,
    so that no shard holds all of it -> per shard (words W3, node_edge,
    node_pos), each on its shard's device: its rows in dictionary order
    (still sorted), one sentinel row after them, node ids shard-local
    (node = 2 * local row + flip)."""
    real = kmer_words.a != kc.SENTINEL
    shard = torch.where(real, kmer_shard_hash(kmer_words) % mesh.size, mesh.size)
    out = []
    for i, dev in enumerate(mesh.devices):
        rows = torch.nonzero(shard == mesh.global_index(i)).squeeze(1)
        nodes = torch.stack([2 * rows, 2 * rows + 1], 1).reshape(-1)
        tail = lambda x, *fill: torch.cat([x, x.new_tensor(fill)]).to(dev)
        out.append((W3(*(tail(w[rows], kc.SENTINEL) for w in kmer_words)),
                    tail(node_edge[nodes], -1, -1), tail(node_pos[nodes], 0, 0)))
    return Sharded(out, mesh)


def _dist_resolve(mesh: Mesh, dict_shards, queries, capacity: int | None):
    """Distributed dictionary resolve: each shard's queries (canon W3,
    flipped, ask) travel to their hash owner, which answers with a
    shard-local merge join; the answers come back in the caller's row
    order.  -> per shard (edge, epos, found).  A query past an owner's
    `capacity` resolves as not found (a missed kmer behaves as an error
    kmer), as the reference's."""
    cols, owner = [], []
    for canon, flipped, ask in queries:
        cols.append(torch.stack([canon.a, canon.b, canon.c, flipped.long()], 1))
        owner.append(torch.where(ask, kmer_shard_hash(canon) % mesh.size, mesh.size))
    recv, ctx, _ = mesh.exchange(cols, owner, mesh.size, AXIS, capacity)
    resp = []
    for q, (words, ne, npo) in zip(recv, dict_shards):
        row, found = kc.lookup_words_merge(words, W3(*(q[:, j].contiguous() for j in range(3))))
        node = 2 * row + q[:, 3]
        resp.append(torch.stack([torch.where(found, ne[node], -1),
                                 torch.where(found, npo[node], 0)], 1))
    back = mesh.give_back(resp, ctx, -1)
    return [(b[:, 0], b[:, 1].clamp(min=0), b[:, 0] >= 0) for b in back]


def sharded_path_vs(mesh: Mesh, dict_shards, from_v, to_v, edge_kmers, inputs,
                    capacity: int | None, max_path: int = MAX_PATH):
    """Value-sharded multi-shard pathing: reads data-parallel AND the
    kmer -> (edge, pos) dictionary hash-sharded (shard_dictionary).  Each
    shard makes its queries, one distributed resolve answers them all, and
    each shard places its hits -> per shard ReadPaths, equal to
    path_readset's per read."""
    queries, locates = [], []
    for inp in inputs:
        canon, flipped, invalid, locate = general_queries(
            inp["codes_ext"], inp["read_offsets"], inp["pos_read"], inp["rlen_pos"],
            inp["uniform_rl"])
        queries.append((canon, flipped, ~invalid))
        locates.append((invalid, locate))
    answers = _dist_resolve(mesh, dict_shards, queries, capacity)
    out = []
    for inp, dev, (edge_q, epos_q, found), (invalid, locate) in zip(
            inputs, mesh.devices, answers, locates):
        hit = found & ~invalid
        edge = torch.where(hit, edge_q, -1)
        epos = torch.where(hit, epos_q, 0)
        out.append(place_hits(hit, edge, epos, locate, inp["read_offsets"].shape[0] - 1,
                              max_path, from_v.to(dev), to_v.to(dev), edge_kmers.to(dev)))
    return Sharded(out, mesh)


def gather_paths(parts, blocks) -> ReadPaths:
    """Per-shard ReadPaths (this process's shards of the mesh) and each
    shard's read range -> one ReadPaths of the readset's reads, in read
    order (each shard's first n rows of its block), on the first shard's
    device: gathered over the fleet in a multi-process mesh, so that every
    process holds every read's path, as the reference's host_fetch."""
    from .dist import host_fetch

    dev = parts[0].edges.device
    if parts.mesh.group is None:
        return ReadPaths(*(torch.cat([getattr(p, f)[: hi - lo].to(dev)
                                      for p, (lo, hi) in zip(parts, blocks)])
                           for f in ReadPaths._fields))
    return ReadPaths(*(torch.from_numpy(host_fetch(Sharded(
        [getattr(p, f)[: hi - lo] for p, (lo, hi) in zip(parts, blocks)], parts.mesh))).to(dev)
        for f in ReadPaths._fields))
