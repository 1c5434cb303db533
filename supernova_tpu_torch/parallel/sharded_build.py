"""Multi-shard unipath graph build over the hash-sharded kmer table (port of
supernova_tpu/parallel/sharded_build.py).

The kmer table stays sharded by kmer hash, as sharded_count leaves it, and
the link structure and list ranking run distributed:

  1. neighbour resolution: each oriented node's neighbour kmer is owned
     by hash; the query travels to its owner (mesh.exchange), which looks
     it up in its table (kcodec.lookup_words_merge, K4) and answers with
     the neighbour's global node id and its degree check (give_back), so
     links form without a shard holding the whole table; the adjacency
     recompute asks the same way;
  2. pointer-doubling list ranking: ptr/dist/min live sharded by node id;
     each doubling step is a distributed gather (index exchange to the
     owner, value exchange back), log2(N) rounds.

compact_links then drops the per-shard padding, sorts the rows and remaps
the node ids, giving the single-device pair of table and Links, whose
table has trim_table's row count, so that materialize_edges gives the
single-device build's BaseGraph array for array.  Exchanges are the
reference's ragged ones (only real rows move; only valid rows query).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import kmer_codec as kc
from ..core.kmer_codec import W3
from ..dbg import build as dbuild
from ..dbg import graph as dgraph
from ..dbg.build import Links, popcount4, single_bit_index
from ..kmer.count import KmerTable, rev4
from .mesh import Mesh, Sharded
from .sharded_count import kmer_shard_hash

PAD_MULTIPLE = 1024  # trim_table's row pad, so the BaseGraph is the one-device build's

def _neighbor_query(mesh: Mesh, words, flips, pick, tables, cap: int):
    """Resolve neighbour kmers (per shard: W3, flip) on their owner shard ->
    per shard, the global oriented node id, or -1 (absent, or a degree that
    is not 1 on `pick`'s mask: "in" for successor links, "out" for
    predecessor links, None for membership only)."""
    owner = [kmer_shard_hash(w) % mesh.size for w in words]
    cols = [torch.stack([w.a, w.b, w.c, f.long()], 1) for w, f in zip(words, flips)]
    recv, ctx, _ = mesh.exchange(cols, owner, mesh.size)
    resp = []
    for o, (q, table) in enumerate(zip(recv, tables)):
        qw = W3(*(q[:, j].contiguous() for j in range(3)))
        srow, found = kc.lookup_words_merge(table.words, qw)
        qflip = q[:, 3]
        ok = found
        if pick is not None:
            lm, rm = table.left_mask[srow].long(), table.right_mask[srow].long()
            if pick == "in":
                mask = torch.where(qflip == 0, lm, rev4(rm))
            else:
                mask = torch.where(qflip == 0, rm, rev4(lm))
            ok = ok & (popcount4(mask) == 1)
        grow = mesh.global_index(o) * cap + srow
        resp.append(torch.where(ok, 2 * grow + qflip, -1)[:, None])
    return [r[:, 0] for r in mesh.give_back(resp, ctx, -1)]


def _dist_gather(mesh: Mesh, vals, idx, cap: int):
    """Distributed vals[idx] for global node ids idx; vals: per shard, a
    tuple of (2*cap,) tensors (its slice of each array).  Owner of node u
    is (u >> 1) // cap.  -> per shard, a tuple of gathered tensors."""
    owner = [(i >> 1) // cap for i in idx]
    recv, ctx, _ = mesh.exchange([i[:, None] for i in idx], owner, mesh.size)
    resp = []
    for o, (q, v) in enumerate(zip(recv, vals)):
        local = q[:, 0] - mesh.global_index(o) * 2 * cap
        resp.append(torch.stack([x[local] for x in v], 1))
    back = mesh.give_back(resp, ctx, 0)
    return [tuple(b[:, j] for j in range(b.shape[1])) for b in back]


def sharded_links(mesh: Mesh, tables, cap: int, steps: int):
    """Distributed Links over the sharded table (each shard cap rows): the
    adjacency recompute + build_links (the reference's _links_local body),
    every shard a step at a time -> per shard (next, prev, head, dist,
    left_mask, right_mask), node ids global."""
    n2 = 2 * cap
    nvalid = [int(t.n_valid) for t in tables]

    # adjacency recompute: keep a context bit only if the neighbour kmer is
    # in (some shard of) the table; only valid rows ask
    new_l, new_r = [], []
    for t in tables:
        new_l.append(torch.zeros_like(t.left_mask))
        new_r.append(torch.zeros_like(t.right_mask))
    rows = [W3(*(w[:nv] for w in t.words)) for t, nv in zip(tables, nvalid)]
    for x in range(4):
        for nbr, masks, new in ((kc.successor_words, "right_mask", new_r),
                                (kc.predecessor_words, "left_mask", new_l)):
            canon = [kc.canonicalize(nbr(w, x)) for w in rows]
            hit = _neighbor_query(mesh, [c for c, _ in canon], [f for _, f in canon], None,
                                  tables, cap)
            for s, t in enumerate(tables):
                m = getattr(t, masks)[: nvalid[s]]
                bit = (hit[s] >= 0) & (((m >> x) & 1) == 1)
                new[s][: nvalid[s]] |= bit.to(m.dtype) << x
    tables = [t._replace(left_mask=l, right_mask=r) for t, l, r in zip(tables, new_l, new_r)]

    # successor / predecessor links of the valid oriented nodes
    out = []
    nxt_l, prv_l = [], []
    for s, t in enumerate(tables):
        dev = t.count.device
        u = torch.arange(2 * nvalid[s], device=dev)
        in_mask, out_mask = dbuild._node_masks(t, u)
        ow = dbuild.oriented_words(t.words, u)
        out.append((u, in_mask, out_mask, ow))
    for pick, mask_j, nbr in (("in", 2, kc.successor_words), ("out", 1, kc.predecessor_words)):
        q = [kc.canonicalize(nbr(o[3], single_bit_index(o[mask_j]))) for o in out]
        v = _neighbor_query(mesh, [c for c, _ in q], [f for _, f in q], pick, tables, cap)
        res = nxt_l if pick == "in" else prv_l
        for s, (u, in_mask, out_mask, _) in enumerate(out):
            dev = u.device
            deg = popcount4(out_mask if pick == "in" else in_mask)
            gu = mesh.global_index(s) * n2 + u
            full = torch.full((n2,), -1, dtype=torch.int64, device=dev)
            full[: u.shape[0]] = torch.where((deg == 1) & (v[s] >= 0) & (v[s] != gu), v[s], -1)
            res.append(full)

    # cycle detection + break at the cycle's minimum node (global ids)
    ids = [mesh.global_index(s) * n2 + torch.arange(n2, device=p.device)
           for s, p in enumerate(prv_l)]
    ptr = [torch.where(p >= 0, p, u) for p, u in zip(prv_l, ids)]
    mn = ids
    for _ in range(steps):
        got = _dist_gather(mesh, list(zip(ptr, mn)), ptr, cap)
        ptr = [g[0] for g in got]
        mn = [torch.minimum(m, g[1]) for m, g in zip(mn, got)]
    prv_at = [g[0] for g in _dist_gather(mesh, [(p,) for p in prv_l], ptr, cap)]
    prv_l = [torch.where((pa >= 0) & (u == m), -1, p)
             for p, pa, u, m in zip(prv_l, prv_at, ids, mn)]

    # list ranking by pointer doubling
    ptr = [torch.where(p >= 0, p, u) for p, u in zip(prv_l, ids)]
    dist = [(p >= 0).long() for p in prv_l]
    for _ in range(steps):
        got = _dist_gather(mesh, list(zip(dist, ptr)), ptr, cap)
        dist = [d + g[0] for d, g in zip(dist, got)]
        ptr = [g[1] for g in got]
    return [(n, p, h, d, t.left_mask, t.right_mask)
            for n, p, h, d, t in zip(nxt_l, prv_l, ptr, dist, tables)]


def _all_shards(mesh: Mesh, xs) -> np.ndarray:
    """Every shard's tensor of one length -> their host concatenation in
    mesh order: gathered over the fleet (dist.host_fetch), or this
    process's shards where they are all of the mesh."""
    from .dist import host_fetch

    return host_fetch(Sharded(list(xs), mesh))


def compact_links(mesh: Mesh, tables, links6):
    """Host: drop the per-shard padding, sort the rows, remap node ids.
    Every shard's table and links are gathered first (over the fleet in a
    multi-process mesh, as the reference's host_fetch), so every process
    gets the same pair.  -> (merged KmerTable, Links) as host-ordered
    numpy-built tensors equal to the single-device pair; the table's row
    count is trim_table's (geom_bucket), the masks the distributed
    recompute's."""
    n_dev = mesh.size
    cap = tables[0].count.shape[0]
    nv = _all_shards(mesh, (t.n_valid.reshape(1) for t in tables)).astype(np.int64)
    shard = np.repeat(np.arange(n_dev), nv)
    row = np.concatenate([np.arange(n) for n in nv]) if nv.sum() else np.zeros(0, np.int64)
    old_rows = shard * cap + row
    full = lambda get: _all_shards(mesh, (get(t) for t in tables))
    a, b, c = (full(lambda t, j=j: t.words[j])[old_rows] for j in range(3))
    order = np.lexsort((c, b, a))
    n = len(order)
    m = dbuild.geom_bucket(max(n, 1), PAD_MULTIPLE)
    old_rows = old_rows[order]
    new_of_old = np.full(n_dev * cap, -1, np.int64)
    new_of_old[old_rows] = np.arange(n)

    nxt, prv, head, dist, new_l, new_r = (
        _all_shards(mesh, (l[j] for l in links6)) for j in range(6))
    old_u = (2 * old_rows[:, None] + np.array([0, 1])[None, :]).reshape(-1)

    def remap(vals):
        ok = vals >= 0
        vrow = new_of_old[np.clip(vals >> 1, 0, n_dev * cap - 1)]
        return np.where(ok & (vrow >= 0), 2 * vrow + (vals & 1), -1)

    def nodes(vals, fill_tail):
        out = np.empty(2 * m, np.int64)
        out[: 2 * n] = vals
        out[2 * n:] = fill_tail
        return out

    tail = np.arange(2 * n, 2 * m, dtype=np.int64)
    hv = head[old_u]
    links = (nodes(remap(nxt[old_u]), -1), nodes(remap(prv[old_u]), -1),
             nodes(2 * new_of_old[np.clip(hv >> 1, 0, n_dev * cap - 1)] + (hv & 1), tail),
             nodes(dist[old_u], 0))

    def pick(arr, fill):
        out = np.full(m, fill, arr.dtype)
        out[:n] = arr.reshape(-1)[old_rows]
        return out

    words = [np.full(m, kc.SENTINEL, np.int64) for _ in range(3)]
    for w, x in zip(words, (a, b, c)):
        w[:n] = x[order]
    host = (words, pick(full(lambda t: t.count), 0), pick(full(lambda t: t.nbc), 0),
            pick(new_l, 0), pick(new_r, 0), n)
    return host, links


def trim_shard_tables(mesh: Mesh, tables):
    """Every shard's table cut or padded to one shared row count,
    geom_bucket(the largest n_valid of any shard of the mesh, across the
    fleet in a multi-process mesh): the distributed phase's global node
    ids are shard * cap + row, and every process must agree on them."""
    cap = dbuild.geom_bucket(max(mesh.pmax(int(t.n_valid) for t in tables), 1), PAD_MULTIPLE)

    def fit(x, fill):
        out = torch.full((cap,), fill, dtype=x.dtype, device=x.device)
        k = min(cap, x.shape[0])
        out[:k] = x[:k]
        return out

    out = [KmerTable(W3(*(fit(w, kc.SENTINEL) for w in t.words)), fit(t.count, 0),
                     fit(t.nbc, 0), fit(t.left_mask, 0), fit(t.right_mask, 0), t.n_valid)
           for t in tables]
    return Sharded(out, mesh)


def sharded_build_graph(mesh: Mesh, tables, device=None) -> dgraph.BaseGraph:
    """Sharded tables (this process's shards of `mesh`) -> BaseGraph: the
    distributed links, then the single-device materialization on `device`
    (the first shard's by default), on every process of a fleet."""
    tables = trim_shard_tables(mesh, tables)
    cap = tables[0].count.shape[0]
    steps = int(math.ceil(math.log2(max(2 * mesh.size * cap, 2)))) + 1
    links6 = sharded_links(mesh, tables, cap, steps)
    (words, count, nbc, lm, rm, n), links = compact_links(mesh, tables, links6)
    dev = torch.device(device) if device is not None else mesh.devices[0]
    t = lambda a, dt=torch.int64: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    table = KmerTable(W3(*(t(w) for w in words)), t(count, torch.int32), t(nbc, torch.int32),
                      t(lm, torch.int32), t(rm, torch.int32),
                      torch.tensor(n, dtype=torch.int64, device=dev))
    lk = Links(*(t(x) for x in links))
    dg = dbuild.materialize_edges(table, lk, dbuild._edge_count(lk, n))
    return dgraph.from_device(dg, table)
