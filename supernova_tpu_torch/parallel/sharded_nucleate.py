"""Mesh-sharded NucleateGraph glue: the closure gluing over a mesh of
shards (port of supernova_tpu/parallel/sharded_nucleate.py).

The steps are parallel/device_nucleate.py's, distributed as the
reference's:
  * closure position rows are sharded in closure-aligned blocks
    (split_closure_rows), so seed selection is shard-local;
  * per-edge multiplicity and the seed-partner join run on EDGE-HASH owner
    shards (mesh.exchange by _fnv of the edge): all rows of an edge meet
    there, its sorts are K4 and its seed compaction K2;
  * pairwise match extension reads the closure VALUES, replicated on every
    shard, or range-sharded (value_shard) and read by distributed gathers;
    its loops step every shard until no row on any shard extends;
  * the adaptive overlap gate is the exact order statistic over every
    shard's candidate overlaps;
  * boundary labels are range-sharded: union hooking sends (node, min)
    pairs to the label owners, pointer jumping is a distributed gather, and
    the Zipper groups rows by (head class, edge label) hash on owner
    shards, each iterated until the psum over shards says nothing changed.

The partition equals device_nucleate.glue_device's (and so the host
cores').  As in the port's device glue, each ragged expansion is sized
exactly unless a row budget is given; a given budget keeps its overflow
meaning (the pairs past it are counted and the caller runs another core).
Exchanges move only real rows; the label owners' per-shard padding is the
reference's (256-row multiples).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import segments as seg
from ..ops.kernels.compact import compact
from ..ops.kernels.scan_max import scan_max
from .device_nucleate import (BIG, UBIG, _bcast_back, _scatter, _seg_count_at_rows, _sorted,
                              k30_index, ragged_expand)
from .mesh import AXIS, Mesh

M32 = 0xFFFFFFFF


def _fnv(x):
    """The reference's 32-bit avalanche of edge ids / labels (int64 held)."""
    x = x & M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _label_owner(node, per: int, n_dev: int):
    return torch.clamp(node // per, max=n_dev - 1)


def _dist_range_gather(mesh: Mesh, local, idx, valid, per: int, fill):
    """Distributed local[idx] over a range-sharded array (owner =
    idx // per; each shard's slice `local`); rows not `valid` read fill."""
    n_dev = mesh.size
    owner = [torch.where(v, _label_owner(i, per, n_dev), n_dev) for i, v in zip(idx, valid)]
    recv, ctx, _ = mesh.exchange([i[:, None] for i in idx], owner, n_dev, AXIS)
    resp = []
    for o, (q, loc) in enumerate(zip(recv, local)):
        at = torch.clamp(q[:, 0] - mesh.global_index(o) * per, 0, per - 1)
        resp.append(loc[at][:, None])
    back = mesh.give_back(resp, ctx, fill)
    return [torch.where(v, b[:, 0], fill) for b, v in zip(back, valid)]


def _dist_label_min(mesh: Mesh, labels, idx, val, valid, per: int):
    """Distributed label[idx] = min(label[idx], val)."""
    n_dev = mesh.size
    owner = [torch.where(v, _label_owner(i, per, n_dev), n_dev) for i, v in zip(idx, valid)]
    recv, _, _ = mesh.exchange([torch.stack([i, x], 1) for i, x in zip(idx, val)], owner,
                               n_dev, AXIS)
    out = []
    for o, (q, lab) in enumerate(zip(recv, labels)):
        at = torch.clamp(q[:, 0] - mesh.global_index(o) * per, 0, per - 1)
        out.append(lab.scatter_reduce(0, at, q[:, 1], "amin", include_self=True))
    return out


def _jump(mesh: Mesh, labels, per: int, times: int):
    """Pointer jumps label <- min(label, label[label]), distributed."""
    for _ in range(times):
        jv = _dist_range_gather(mesh, labels, labels, [lab < BIG for lab in labels], per, BIG)
        labels = [torch.minimum(lab, torch.where(j < BIG, j, lab)) for lab, j in zip(labels, jv)]
    return labels


def _owner_multiplicity(rows, E: int):
    """On an edge owner: the distinct closures of each received row's edge
    (all rows of an edge meet on its owner)."""
    e, c = rows[:, 0].contiguous(), rows[:, 1].contiguous()
    if e.shape[0] == 0:
        return rows[:, :1]
    (e_s, c_s), _ = _sorted((e, c), ())
    est = seg.run_starts(e_s)
    dcount = _seg_count_at_rows(seg.run_starts(e_s, c_s), est)
    eend = seg.run_end_mask(est)
    emult = torch.zeros(E, dtype=torch.int64, device=e.device)
    emult[e_s[eend]] = dcount[eend]
    return emult[e][:, None]


def _owner_candidates(rows, C: int, P: int, cand_budget):
    """On an edge owner: rows sorted by (edge, closure, pos), each seed
    paired with its edge run's other rows (the seed rows compacted by K2,
    the pairs ragged-expanded), deduplicated on (c1, c2, offset).  ->
    (owner rows (e3, c3, p3, run_end3, run_len3), candidates (c1, j1, c2,
    j2, live), overflow)."""
    dev = rows.device
    (e3, c3, p3), (s3,) = _sorted(tuple(rows[:, j].contiguous() for j in range(3)),
                                  (rows[:, 3] == 1,))
    R3 = e3.shape[0]
    ps = torch.arange(R3, device=dev)
    est3 = seg.run_starts(e3) if R3 else torch.zeros(0, dtype=torch.bool, device=dev)
    run_start3 = scan_max(None, est3, 0)
    run_end3 = _bcast_back(torch.where(seg.run_end_mask(est3), ps, BIG)) if R3 else ps
    run_len3 = run_end3 - run_start3 + 1
    nseed, cols = compact(s3, ps, run_start3, run_len3, c3, p3)
    CS = min(C, R3)
    srow, s_rs, s_rl, s_c, s_p = (x[:CS] for x in cols)
    sizes = torch.where(torch.arange(CS, device=dev) < nseed, s_rl - 1, 0)
    owner, t, ovf = ragged_expand(sizes, cand_budget)
    in_run_seed = srow[owner] - s_rs[owner]
    prow = s_rs[owner] + t + (t >= in_run_seed).long()
    ca, cj1, cb, cj2 = s_c[owner], s_p[owner], c3[prow], p3[prow]
    other = cb != ca
    ca, cb = torch.where(other, ca, BIG), torch.where(other, cb, BIG)
    (k1, k2, k3), (q1, q2) = _sorted((ca, cb, cj1 - cj2 + P), (cj1, cj2))
    first = seg.run_starts(k1, k2, k3) if k1.shape[0] else k1 > 0
    live0 = first & (k1 < BIG)
    cand = (torch.where(live0, k1, BIG), torch.where(live0, q1, 0),
            torch.where(live0, k2, BIG), torch.where(live0, q2, 0), live0)
    return (e3, c3, p3, run_end3, run_len3), cand, ovf


def _extend_mesh(mesh: Mesh, fetch, coffs, clen, c1, j1, c2, j2, live):
    """The maximal matches of every shard's rows with values read through
    `fetch` (distributed gathers), each step on the rows still extending,
    until no row of any shard extends -> per shard (start1, start2, length,
    o1, l1)."""
    geo = []
    for s in range(len(c1)):
        C = clen[s].shape[0]
        c1s, c2s = torch.clamp(c1[s], max=C - 1), torch.clamp(c2[s], max=C - 1)
        geo.append((coffs[s][c1s], coffs[s][c2s], clen[s][c1s], clen[s][c2s]))

    def run(start, back):
        n = [torch.full_like(j, start) for j in j1]
        rows = [torch.nonzero(lv).squeeze(1) for lv in live]
        while mesh.any(r.numel() for r in rows):
            i1, i2, ok = [], [], []
            for s, r in enumerate(rows):
                o1, o2, l1, l2 = (g[r] for g in geo[s])
                if back:
                    x1, x2 = j1[s][r] - n[s][r] - 1, j2[s][r] - n[s][r] - 1
                    k = (x1 >= 0) & (x2 >= 0)
                else:
                    x1, x2 = j1[s][r] + n[s][r], j2[s][r] + n[s][r]
                    k = (x1 < l1) & (x2 < l2)
                i1.append(o1 + x1)
                i2.append(o2 + x2)
                ok.append(k)
            v1, v2 = fetch(i1, ok), fetch(i2, ok)
            rows = [r[k & (a == b) & (a < BIG)] for r, k, a, b in zip(rows, ok, v1, v2)]
            for s, r in enumerate(rows):
                n[s][r] += 1
        return n

    a, b = run(0, True), run(1, False)
    return [(j1[s] - a[s], j2[s] - a[s], a[s] + b[s], geo[s][0], geo[s][2])
            for s in range(len(j1))]


def _sharded_glue_local(mesh: Mesh, blocks, tabs, *, n_bound: int, per_label: int, min_over: int,
                        min_over_floor: int, adaptive: bool, long_shift: int, budgets,
                        value_shard: bool, per_val: int):
    """Every shard's body, a step at a time.  blocks: per shard (cvals,
    ccid, cpos); tabs: per shard the replicated tables (cvals_flat or its
    range slice, prefx or its slice, coffs, cstart, clen, cinv, kmers).
    -> (per-shard label slices, overflow total)."""
    n_dev = mesh.size
    cand_b, long_b, pair_b = budgets
    S = range(mesh.n_local)
    cvals = [b[0] for b in blocks]
    ccid = [b[1] for b in blocks]
    cpos = [b[2] for b in blocks]
    flat, prefx, coffs, cstart, clen, cinv, kmers = (list(x) for x in zip(*tabs))
    C, E = clen[0].shape[0], kmers[0].shape[0]
    P = per_val * n_dev if value_shard else flat[0].shape[0]
    pall = [torch.arange(v.shape[0], device=v.device) for v in cvals]

    # ---- seed selection is shard-local (closures never split)
    in_window = []
    for s in S:
        km_pos = kmers[s][cvals[s]]
        csum = torch.cumsum(km_pos, 0)
        pend = seg.run_end_mask(seg.run_starts(ccid[s])) if csum.shape[0] else ccid[s] > 0
        rend_pos = _bcast_back(torch.where(pend, pall[s], BIG)) if csum.shape[0] else pall[s]
        in_window.append(csum[rend_pos] - csum < min_over)

    # per-edge distinct-closure multiplicity, asked of the edge's owner
    e_owner = [_fnv(v) % n_dev for v in cvals]
    recv, ctx, _ = mesh.exchange([torch.stack([v, c], 1) for v, c in zip(cvals, ccid)],
                                 e_owner, n_dev, AXIS)
    mult = [m[:, 0] for m in mesh.give_back([_owner_multiplicity(r, E) for r in recv], ctx, BIG)]
    is_seed = []
    for s in S:
        cmin = _scatter(torch.full((C + 1,), BIG, dtype=torch.int64, device=cvals[s].device),
                        torch.where(in_window[s], ccid[s], C), mult[s], "amin")
        tied = in_window[s] & (mult[s] == cmin[ccid[s]])
        cseed = _scatter(torch.full((C + 1,), -1, dtype=torch.int64, device=cvals[s].device),
                         torch.where(tied, ccid[s], C), cpos[s], "amax")
        is_seed.append(tied & (cpos[s] == cseed[ccid[s]]))

    # ---- candidate join on edge-hash owners
    recv, _, _ = mesh.exchange(
        [torch.stack([v, c, p, sd.long()], 1) for v, c, p, sd in zip(cvals, ccid, cpos, is_seed)],
        e_owner, n_dev, AXIS)
    own, cands, ovf = [], [], 0
    for r in recv:
        o, cnd, x = _owner_candidates(r, C, P, cand_b)
        own.append(o)
        cands.append(cnd)
        ovf += x

    # ---- extension: replicated values, or distributed range gathers
    if value_shard:
        def fetch_val(idx, valid):
            inr = [v & (i >= 0) & (i < P) for i, v in zip(idx, valid)]
            return _dist_range_gather(mesh, flat, idx, inr, per_val, BIG)

        def fetch_pref(idx, valid):
            inr = [v & (i >= 0) & (i < P) for i, v in zip(idx, valid)]
            return _dist_range_gather(mesh, prefx, idx, inr, per_val, 0)
    else:
        def fetch_val(idx, valid):
            return [torch.where(v, flat[s][torch.clamp(i, 0, P - 1)], BIG)
                    for s, (i, v) in enumerate(zip(idx, valid))]

        def fetch_pref(idx, valid):
            return [torch.where(v, prefx[s][torch.clamp(i, 0, P - 1)], 0)
                    for s, (i, v) in enumerate(zip(idx, valid))]

    c1v, j1v, c2v, j2v, live0 = (list(x) for x in zip(*cands))
    ext = _extend_mesh(mesh, fetch_val, coffs, clen, c1v, j1v, c2v, j2v, live0)

    # ---- end-reaching filter + the exact adaptive gate over every shard
    hi = fetch_pref([o1 + s1 + L for s1, _, L, o1, _ in ext], live0)
    lo = fetch_pref([o1 + s1 for s1, _, _, o1, _ in ext], live0)
    over, cand_ok = [], []
    for s in S:
        s1, s2, L, _, l1c = ext[s]
        over.append(torch.where(live0[s], hi[s] - lo[s], 0))
        cand_ok.append(live0[s] & (s1 + L >= l1c) & ((s1 == 0) | (s2 == 0)))
    gate = min_over
    if adaptive:
        n_c = mesh.psum(int(ok.sum()) for ok in cand_ok)
        if n_c:
            # every shard's overlaps (UBIG where not a candidate), padded to
            # one length and all-gathered: the same order statistic
            lens = mesh.all_gather([torch.tensor([o.shape[0]], device=o.device) for o in over])
            width = int(lens[0].max())
            over_m = [torch.cat([torch.where(ok, o, UBIG),
                                 torch.full((width - o.shape[0],), UBIG, device=o.device)])
                      for o, ok in zip(over, cand_ok)]
            (overs_sorted,), _ = _sorted((mesh.all_gather(over_m)[0].reshape(-1),), ())
            gate = min(max(int(overs_sorted[k30_index(n_c)]), min_over_floor), min_over)
    acc = [ok & (o >= gate) for o, ok in zip(over, cand_ok)]

    # ---- long-edge matches on the same owner rows
    longs = []
    for s in S:
        e3, c3, p3, run_end3, run_len3 = own[s]
        ps = torch.arange(e3.shape[0], device=e3.device)
        longrow = kmers[s][e3] >= gate
        lsizes = torch.where(longrow & (run_len3 > 1),
                             torch.clamp(run_end3 - ps, max=long_shift), 0)
        lowner, lt, x = ragged_expand(lsizes, long_b)
        ovf += x
        lprow = lowner + 1 + lt
        longs.append((c3[lowner], p3[lowner], c3[lprow], p3[lprow]))
    la, lj1, lb, lj2 = (list(x) for x in zip(*longs))
    lext = _extend_mesh(mesh, fetch_val, coffs, clen, la, lj1, lb, lj2,
                        [torch.ones_like(x, dtype=torch.bool) for x in la])

    # ---- boundary union pairs + rc images, ragged-expanded
    ua, ub = [], []
    for s in S:
        s1, s2, L, _, _ = ext[s]
        ls1, ls2, lL, _, _ = lext[s]
        a = acc[s]
        mc1 = torch.cat([c1v[s][a], la[s]])
        ms1 = torch.cat([s1[a], ls1])
        mc2 = torch.cat([c2v[s][a], lb[s]])
        ms2 = torch.cat([s2[a], ls2])
        mL = torch.cat([L[a], lL])
        ac = torch.cat([mc1, cinv[s][mc1]])
        av = torch.cat([ms1, clen[s][mc1] - (ms1 + mL)])
        bc_ = torch.cat([mc2, cinv[s][mc2]])
        bv = torch.cat([ms2, clen[s][mc2] - (ms2 + mL)])
        b1, b2 = cstart[s][ac] + av, cstart[s][bc_] + bv
        uowner, ut, x = ragged_expand(torch.cat([mL, mL]) + 1, pair_b)
        ovf += x
        ua.append(b1[uowner] + ut)
        ub.append(b2[uowner] + ut)

    # ---- distributed union-find over range-sharded labels
    label = [mesh.global_index(s) * per_label + torch.arange(per_label, device=d)
             for s, d in enumerate(mesh.devices)]
    on = [torch.ones_like(x, dtype=torch.bool) for x in ua]

    def hook_round(lab):
        la_ = _dist_range_gather(mesh, lab, ua, on, per_label, BIG)
        lb_ = _dist_range_gather(mesh, lab, ub, on, per_label, BIG)
        m = [torch.minimum(x, y) for x, y in zip(la_, lb_)]
        lab = _dist_label_min(mesh, lab, ua, m, on, per_label)
        lab = _dist_label_min(mesh, lab, ub, m, on, per_label)
        return _jump(mesh, lab, per_label, 2)

    def fixpoint(step, lab):
        while True:
            nxt = step(lab)
            if not mesh.any(bool((x != y).any()) for x, y in zip(nxt, lab)):
                return nxt
            lab = nxt

    label = fixpoint(hook_round, hook_round(label))

    # ---- Zipper over (head-class, edge-label)-hash owners
    inst_b = [cstart[s][ccid[s]] + cpos[s] for s in S]
    allv = [torch.ones_like(v, dtype=torch.bool) for v in cvals]

    def zip_pass(lab, heads_off, tails_off):
        h = _dist_range_gather(mesh, lab, [b + heads_off for b in inst_b], allv, per_label, BIG)
        t_ = _dist_range_gather(mesh, lab, [b + tails_off for b in inst_b], allv, per_label, BIG)
        zowner = [(_fnv(x) ^ _fnv(v)) % n_dev for x, v in zip(h, cvals)]
        recv, _, _ = mesh.exchange([torch.stack([x, v, t], 1) for x, v, t in zip(h, cvals, t_)],
                                   zowner, n_dev, AXIS)
        ta, tb, same = [], [], []
        for r in recv:
            (hk, lk), (tk,) = _sorted((r[:, 0].contiguous(), r[:, 1].contiguous()),
                                      (r[:, 2],))
            sm = (hk[1:] == hk[:-1]) & (lk[1:] == lk[:-1])
            ta.append(tk[1:][sm])
            tb.append(tk[:-1][sm])
        m = [torch.minimum(x, y) for x, y in zip(ta, tb)]
        ok = [torch.ones_like(x, dtype=torch.bool) for x in ta]
        lab = _dist_label_min(mesh, lab, ta, m, ok, per_label)
        lab = _dist_label_min(mesh, lab, tb, m, ok, per_label)
        return _jump(mesh, lab, per_label, 2)

    label = fixpoint(lambda lab: zip_pass(zip_pass(lab, 0, 1), 1, 0), label)
    return _jump(mesh, label, per_label, 4), mesh.psum([ovf])


def sharded_glue(mesh: Mesh, blocks, flat, prefx, coffs, cstart, clen, cinv, kmers,
                 n_bound: int, min_over: int, min_over_floor: int, adaptive: bool,
                 long_shift: int = 40, value_shard: bool = False, budgets=(None, None, None)):
    """Closure-aligned row blocks (split_closure_rows, per shard) + the flat
    closure values and their exclusive kmer prefix (replicated, or
    range-sharded with value_shard=True) + the closure and edge tables
    (int64 tensors) -> (labels (B,) numpy, overflow total)."""
    n_dev = mesh.size
    per_label = -(-n_bound // n_dev)
    per_label = max(256, -(-per_label // 256) * 256)
    per_val = -(-flat.shape[0] // n_dev)
    if value_shard:
        pad = per_val * n_dev - flat.shape[0]
        flat = torch.cat([flat, torch.full((pad,), BIG, dtype=flat.dtype, device=flat.device)])
        prefx = torch.cat([prefx, prefx[-1:].expand(pad)])
    tabs = []
    for i, d in enumerate(mesh.devices):
        g = mesh.global_index(i)
        part = (lambda x: x[g * per_val:(g + 1) * per_val]) if value_shard else (lambda x: x)
        tabs.append((part(flat).to(d), part(prefx).to(d), coffs.to(d), cstart.to(d),
                     clen.to(d), cinv.to(d), kmers.to(d)))
    blocks = [tuple(x.to(d) for x in b) for b, d in zip(blocks, mesh.devices)]
    labels, ovf = _sharded_glue_local(
        mesh, blocks, tabs, n_bound=n_bound, per_label=per_label, min_over=min_over,
        min_over_floor=min_over_floor, adaptive=adaptive, long_shift=long_shift,
        budgets=budgets, value_shard=value_shard, per_val=per_val)
    from .dist import from_global
    from .mesh import Sharded

    return from_global(Sharded(labels, mesh))[:n_bound], ovf


def split_closure_rows(cls, n_dev: int):
    """Flat closure position rows -> per shard (cvals, ccid, cpos) int64
    arrays of closure-aligned blocks (a closure's rows never split; the
    reference's greedy assignment, without its padding)."""
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    target = -(-int(lens.sum()) // n_dev)
    blocks = [[] for _ in range(n_dev)]
    acc = d = 0
    for i in range(len(cls)):
        if acc >= target and d < n_dev - 1:
            d += 1
            acc = 0
        blocks[d].append(i)
        acc += int(lens[i])
    out = []
    for ids in blocks:
        ids = np.asarray(ids, np.int64)
        bl = lens[ids]
        cv = (np.concatenate([np.asarray(cls[i], np.int64) for i in ids]) if len(ids)
              else np.zeros(0, np.int64))
        ci = np.repeat(ids, bl)
        cp = np.arange(len(cv), dtype=np.int64) - np.repeat(np.cumsum(bl) - bl, bl)
        out.append((cv, ci, cp))
    return out


def glue_closures_sharded(mesh: Mesh, bg, cls, min_over_bases: int, adaptive: bool,
                          min_over_floor_bases: int = 100, value_shard: bool = False,
                          budgets=(None, None, None)):
    """device_nucleate.glue_closures_device over the mesh -> (labels int64
    (B,), overflow): the same partition."""
    from ..core.kmer_codec import K

    n = len(cls)
    if n == 0:
        return np.zeros(0, np.int64), 0
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=cstart[1:])
    inv = bg.inv
    idx = {c: i for i, c in enumerate(cls)}
    cin = np.array([idx[tuple(int(inv[e]) for e in reversed(c))] for c in cls], dtype=np.int64)
    flat = np.concatenate([np.asarray(c, np.int64) for c in cls])
    kmers = (bg.edges.lengths() - (K - 1)).astype(np.int64)
    prefx = np.zeros(len(flat) + 1, np.int64)
    np.cumsum(kmers[flat], out=prefx[1:])
    flat = np.append(flat, BIG)  # the value past the end, as the device glue's
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.devices[0])
    blocks = [tuple(torch.from_numpy(x) for x in b) for b in
              [split_closure_rows(cls, mesh.size)[mesh.global_index(i)]
               for i in range(mesh.n_local)]]
    labels, ovf = sharded_glue(
        mesh, blocks, t(flat), t(prefx), t(np.cumsum(lens) - lens), t(cstart[:n]), t(lens),
        t(cin), t(kmers), n_bound=int(cstart[-1]),
        min_over=max(min_over_bases - (K - 1), 1),
        min_over_floor=max(min_over_floor_bases - (K - 1), 1),
        adaptive=adaptive, value_shard=value_shard, budgets=budgets)
    return labels.astype(np.int64), ovf
