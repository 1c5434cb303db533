"""Sharded barcode-link accumulation (port of
supernova_tpu/parallel/sharded_scaffold.py): AllTinks qept over the mesh.

SURVEY §5.8: the reference accumulates barcode-link triples (edge, edge,
#shared good barcodes) in 20 batched host passes over an inverted
barcode->edge index (SecretOps.cc:807-867).  Here, as in the JAX package:

  1. (barcode, item) incidence rows live data-parallel across the mesh;
  2. rows travel to their OWNER shard by barcode hash (Mesh.exchange, the
     reference's ragged exchange) - a barcode's rows are then complete on
     one shard, so pair generation is shard-local;
  3. every two rows of a barcode run of the (barcode, item)-sorted rows
     make a pair (runs longer than CAP make none - the hot-barcode gate,
     the host engine's max_per_bc);
  4. local (i1, i2) partial counts are pre-reduced by one sort + run-sum,
     then travel to their owner shard by pair hash;
  5. the final sort + run-sum yields globally-correct triples, filtered at
     min_shared (>= 4 in the reference).

Every sort is kcodec.lex_argsort (kernel K4 on the card) and every
compaction segments.stable_compact (kernel K2 on the card).  The pairs and
triples are sized exactly; the reference's (cap-1)*N shifted copies and
its out_cap budgets are static-shape forms of the same sets, and its
budgets drop triples past them (the port keeps out_cap in the signatures
and never clips).  Tested equal to asm/links.link_triples_np and to the
reference on the CPU (tests/test_torch_sharded_scaffold.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import segments as seg
from ..ops.kernels.scan_max import scan_max
from ..ops.kernels.sort import lex_argsort
from .mesh import AXIS

SENT = np.int32(0x7FFFFFFF)  # split_incidence's pad value; never a real barcode/item id
M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    by 16-bit halves of x so that no product leaves int64."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fnv_mix(x):
    """The reference's 32-bit mix of x's low 32 bits -> int64 in [0, 2^32)."""
    x = x.long() & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _rows(x, device) -> torch.Tensor:
    """An id column (numpy or tensor) -> contiguous int64 tensor on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).contiguous()
    return torch.from_numpy(np.asarray(x, np.int64)).to(device)


def _pairs_from_sorted(bc_s, it_s, cap: int):
    """(barcode, item)-sorted rows, no pad rows -> the pair columns (e1, e2):
    each row with every later row of its barcode run, sized exactly (the sum
    of k(k-1)/2 over the runs of length k <= cap; longer runs give nothing,
    the hot-barcode gate)."""
    n = bc_s.shape[0]
    if n == 0:
        return it_s, it_s
    p = torch.arange(n, device=bc_s.device)
    starts = seg.run_starts(bc_s)
    run_start = scan_max(None, starts, 0)
    # end of each row's run = the NEAREST end at or after the row
    ends = seg.run_end_mask(starts)
    run_end = torch.cummin(torch.where(ends, p, n).flip(0), 0).values.flip(0)
    later = torch.where(run_end - run_start + 1 <= cap, run_end - p, 0)
    src = torch.repeat_interleave(p, later)
    first = torch.cumsum(later, 0) - later
    q = src + 1 + torch.arange(src.shape[0], device=p.device) - first[src]
    return it_s[src], it_s[q]


def _reduce_pairs(e1, e2, weight):
    """Sort pairs by (e1, e2), sum the weights of each pair's run, compact
    the run totals -> (e1, e2, total) of the distinct pairs in (e1, e2)
    order, sized exactly (the reference pads them to an out_cap)."""
    if e1.shape[0] == 0:
        return e1, e2, weight
    order = lex_argsort(e1, e2)
    k1, k2, w = e1[order], e2[order], weight[order]
    starts = seg.run_starts(k1, k2)
    cs = torch.cumsum(w, 0)
    total = cs - seg.run_broadcast_from_start(cs - w, starts)
    nv, (o1, o2, ot) = seg.stable_compact(seg.run_end_mask(starts), k1, k2, total)
    nv = int(nv)
    return o1[:nv], o2[:nv], ot[:nv]


def _filter(o1, o2, tot, min_shared: int):
    nv, (o1, o2, tot) = seg.stable_compact(tot >= min_shared, o1, o2, tot)
    k = int(nv)
    return o1[:k], o2[:k], tot[:k], nv


def bc_link_triples(bc, item, cap: int = 16, out_cap: int | None = None,
                    min_shared: int = 1, device="cuda"):
    """Single-device AllTinks: (barcode, item) incidence rows (SENT rows are
    padding; ids in [0, 2^31)) -> (i1, i2, shared >= min_shared, n) sorted
    by (i1, i2): int64 tensors on `device` of exactly n rows, n a 0-d
    tensor.  Device analogue of asm/links.link_triples_np(max_per_bc=cap).
    The reference pads to out_cap (default: the input rows) and drops the
    triples past it; here out_cap is accepted and nothing is dropped."""
    dev = resolve_device(device)
    bc, item = _rows(bc, dev), _rows(item, dev)
    real = bc != int(SENT)
    bc, item = bc[real], item[real]
    order = lex_argsort(bc, item)
    e1, e2 = _pairs_from_sorted(bc[order], item[order], cap)
    o1, o2, tot = _reduce_pairs(e1, e2, torch.ones_like(e1))
    return _filter(o1, o2, tot, min_shared)


def sharded_bc_links(mesh, bc_shards, item_shards, cap: int = 16,
                     cap_rows: int | None = None, out_cap: int = 4096,
                     min_shared: int = 1, use_ragged: bool = False, info=None):
    """Barcode-link triples over the mesh's shards (in a fleet, every
    process's: each takes its own shards' rows and gets every triple).

    bc_shards/item_shards: (n_dev, rows) SENT-padded (split_incidence), or
    one id column per shard of the mesh (every process holds them all).
    cap_rows bounds the rows a shard receives in each exchange (none by
    default; rows past it are dropped and counted).
    out_cap is accepted and not applied (the reference keeps at most
    out_cap triples a shard); the exchange is always ragged, so use_ragged
    is accepted and ignored.  `info` (a dict) receives `dropped` (rows a
    shard dropped over both exchanges, this process's shards),
    `pair_rows` (the pairs generated) and `local_rows` (the pre-reduced
    pairs sent to their owners), both summed over the mesh.
    -> (i1, i2, shared) int64 numpy arrays, sorted by (i1, i2)."""
    from .dist import host_fetch
    from .mesh import Sharded

    n = mesh.size
    cols, keys = [], []
    for i, d in enumerate(mesh.devices):
        g = mesh.global_index(i)
        bc, it = _rows(bc_shards[g], d), _rows(item_shards[g], d)
        real = bc != int(SENT)  # pad rows go nowhere
        bc, it = bc[real], it[real]
        cols.append(torch.stack([bc, it], 1))
        keys.append(_fnv_mix(bc) % n)
    recv, _, dropped_bc = mesh.exchange(cols, keys, n, AXIS, cap_rows)
    cols, keys, pair_rows = [], [], 0
    for r in recv:
        bc, it = r[:, 0].contiguous(), r[:, 1].contiguous()
        order = lex_argsort(bc, it)
        e1, e2 = _pairs_from_sorted(bc[order], it[order], cap)
        pair_rows += e1.shape[0]
        # local pre-reduce: one row per (pair, this shard)
        l1, l2, lw = _reduce_pairs(e1, e2, torch.ones_like(e1))
        cols.append(torch.stack([l1, l2, lw], 1))
        keys.append((_fnv_mix(l1) ^ _fnv_mix(l2)) % n)
    local_rows = sum(c.shape[0] for c in cols)
    recv, _, dropped_pairs = mesh.exchange(cols, keys, n, AXIS, cap_rows)
    out = []
    for g in recv:
        o1, o2, tot = _reduce_pairs(*(g[:, j].contiguous() for j in range(3)))
        o1, o2, tot, _ = _filter(o1, o2, tot, min_shared)
        out.append(torch.stack([o1, o2, tot], 1))
    if info is not None:
        info.update(dropped=[a + b for a, b in zip(dropped_bc, dropped_pairs)],
                    pair_rows=mesh.psum([pair_rows]), local_rows=mesh.psum([local_rows]))
    i1, i2, s = host_fetch(Sharded(out, mesh)).T
    order = np.lexsort((i2, i1))
    return i1[order], i2[order], s[order]


def split_incidence(bcv, item, n_dev: int, bucket: int = 256):
    """Host prep: flat incidence rows -> (n_dev, rows) SENT-padded shards."""
    n = len(bcv)
    per = -(-max(n, 1) // n_dev)
    per = -(-per // bucket) * bucket
    bc_sh = np.full((n_dev, per), SENT, np.int32)
    it_sh = np.full((n_dev, per), SENT, np.int32)
    for d in range(n_dev):
        lo, hi = d * per, min((d + 1) * per, n)
        if hi > lo:
            bc_sh[d, : hi - lo] = bcv[lo:hi]
            it_sh[d, : hi - lo] = item[lo:hi]
    return bc_sh, it_sh
