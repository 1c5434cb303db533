"""Device formulation of the NucleateGraph glue phase (port of
supernova_tpu/parallel/device_nucleate.py).

The host path (asm/nucleate.py + native/nucleate_core.cpp) walks hash maps
and a pointer union-find — correct but serial.  This module re-expresses
the same semantics as sorts, segment reductions, ragged joins and
min-label propagation on torch tensors of one device, step for step as
the reference's ten steps:
  1. per-edge distinct-closure multiplicity (sorted dedup + segment count);
  2. per-closure seed: least-multiplicity position within the tail window
     holding < MIN_OVER kmers after it, ties -> closest to the end;
  3. candidate join: rows sorted by (edge, closure, pos); the seed rows
     compacted (K2); every seed pairs with every other row of its edge run
     (ragged expansion), under a row budget where one is given;
  4. candidate dedup on (c1, c2, j1-j2) (stable sort + first of run);
  5. pairwise maximal extension, one gather pair a step;
  6. end-reaching filter + adaptive overlap gate (30th percentile);
  7. long-edge matches: each row of a long-edge run pairs with its next
     <= 40 run neighbours;
  8. boundary union pairs (match + rc image), ragged-expanded;
  9. union-find: scatter-min label hooking + pointer jumping to fixpoint;
 10. Zipper: sorted (class(head), edge label) joins -> more unions, to a
     fixpoint.
Output: fully compressed labels (the least boundary id of each class), the
partition the host cores give; asm/nucleate._quotient consumes it.

Every sort is ops.kernels.sort.lex_argsort (K4 on the card, its plain twin
on the CPU) with the payloads gathered by the permutation; the step-3
compaction is ops.kernels.compact.compact (K2).  Scatters go to a tensor
with one dump slot past its end (the reference's mode="drop"); its
lax.while_loops are Python loops that end when no row is live.  Values are
int64 throughout; the reference's uint32 prefix sums wrap, but only their
per-closure differences are read, which are exact in both.  Its compile
buckets (the padding of positions, closures, edges and boundaries) are
left out, and each ragged expansion is exactly as long as its pairs.
Its row budgets (the static lengths of those arrays, 4P / 4P / 8P) clip
real closure sets (a 10 Mb genome needs ~21P union pairs), so here they
apply only where a caller passes them: then, as in the reference, budget
overflows are returned as diagnostics and the caller runs the host core.
With no budget the expansions take the device memory they need, and a
card without room raises torch.cuda.OutOfMemoryError.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import segments as seg
from ..ops.kernels.compact import compact
from ..ops.kernels.scan_max import scan_max
from ..ops.kernels.sort import lex_argsort

BIG = 0x7FFFFFFF
UBIG = 0xFFFFFFFF


def _seg_count_at_rows(ind, starts):
    """Per-run inclusive count of `ind` at each row (runs from `starts`)."""
    cs = torch.cumsum(ind.long(), 0)
    base = seg.run_broadcast_from_start(cs - ind.long(), starts)
    return cs - base


def _bcast_back(vals_at_end):
    """Broadcast run-end values backward over the run (reverse cummin);
    valid only for values that increase along the array (positions), with
    BIG at the rows that are not run ends."""
    return torch.flip(torch.cummin(torch.flip(vals_at_end, (0,)), 0).values, (0,))


def _scatter(out, index, src, reduce):
    """out[index] = reduce(out[index], src) with the last slot of `out` as
    the dump slot; returns out without it."""
    out.scatter_reduce_(0, index, src, reduce, include_self=True)
    return out[:-1]


def _sorted(keys, payloads):
    """Rows sorted by `keys` (stable, K4): (sorted keys, gathered payloads)."""
    perm = lex_argsort(*keys)
    return [k[perm] for k in keys], [p[perm] for p in payloads]


def ragged_expand(sizes, budget: int | None):
    """Enumerate sum(sizes) (owner, t) pairs, t in [0, sizes[owner]), at
    most `budget` of them (None: all).

    Returns (owner, t, overflow): min(total, budget) rows, and the number
    of pairs past the budget.  The reference's arrays are `budget` rows
    long with the rows past the total masked; those rows take part in
    nothing, so they are left out here."""
    n = sizes.shape[0]
    dev = sizes.device
    dst = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum())
    rows = total if budget is None else min(total, budget)
    owner = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
    at = torch.where((sizes > 0) & (dst < rows), dst, rows)
    owner = _scatter(owner, at, torch.arange(n, device=dev), "amax")
    owner = scan_max(owner)
    t = torch.arange(rows, device=dev) - dst[owner]
    return owner, t, max(total - rows, 0)


def _extend(cvp, coffs, clen, c1, j1, c2, j2, live):
    """Maximal match around closure c1's position j1 == c2's j2 on the live
    rows -> (start1, start2, length, o1, l1, l2): one gather pair a step,
    each step on the rows still extending."""
    C, P = clen.shape[0], cvp.shape[0] - 1
    c1s, c2s = torch.clamp(c1, max=C - 1), torch.clamp(c2, max=C - 1)
    o1, o2, l1, l2 = coffs[c1s], coffs[c2s], clen[c1s], clen[c2s]

    def run(start, ok_at):
        n = torch.full_like(j1, start)
        rows = torch.nonzero(live).squeeze(1)
        while rows.numel():
            rows = rows[ok_at(rows, n[rows])]
            n[rows] += 1
        return n

    def back_ok(r, a):
        x1, x2 = j1[r] - a - 1, j2[r] - a - 1
        return (x1 >= 0) & (x2 >= 0) & (
            cvp[torch.clamp(o1[r] + x1, 0, P)] == cvp[torch.clamp(o2[r] + x2, 0, P)])

    def fwd_ok(r, b):
        x1, x2 = j1[r] + b, j2[r] + b
        return (x1 < l1[r]) & (x2 < l2[r]) & (
            cvp[torch.clamp(o1[r] + x1, 0, P)] == cvp[torch.clamp(o2[r] + x2, 0, P)])

    a = run(0, back_ok)
    b = run(1, fwd_ok)
    return j1 - a, j2 - a, a + b, o1, l1, l2


def k30_index(n_c: int) -> int:
    """The adaptive gate's order statistic: float32(max(n_c - 1, 0)) * 0.30
    in float32, truncated, as the reference's device glue computes it (a
    float64 product differs by one for some n_c)."""
    x = torch.tensor(float(max(n_c - 1, 0)), dtype=torch.float32)
    return int((x * torch.tensor(0.30, dtype=torch.float32)).to(torch.int32))


def glue_device(
    cvals,      # (P,) edge id per closure position
    ccid,       # (P,) closure id per position (ascending)
    cpos,       # (P,) position within the closure
    cstart,     # (C,) boundary-node offset per closure
    clen,       # (C,) closure length
    cinv,       # (C,) closure involution
    kmers,      # (E,) kmers per base edge
    n_bound: int,
    min_over: int = 153,
    min_over_floor: int = 53,
    adaptive: bool = True,
    long_shift: int = 40,
    cand_budget: int | None = None,
    long_budget: int | None = None,
    pair_budget: int | None = None,
):
    """int64 tensors on one device -> (labels (B,) int64 min-id partition,
    (cand_overflow, long_overflow, pair_overflow) ints, the three ragged
    expansions' rows).

    A budget left at None bounds nothing: that expansion is sized exactly.
    A budget given caps its expansion at that many rows, as the
    reference's static arrays do, and the pairs past it are counted as
    overflow."""
    P = cvals.shape[0]
    C = cstart.shape[0]
    E = kmers.shape[0]
    B = n_bound
    dev = cvals.device

    # ---- 1. per-edge distinct-closure multiplicity
    (e_s, c_s), _ = _sorted((cvals, ccid), ())
    st_ec = seg.run_starts(e_s, c_s)
    est = seg.run_starts(e_s)
    dcount = _seg_count_at_rows(st_ec, est)
    eend = seg.run_end_mask(est)
    emult = torch.zeros(E, dtype=torch.int64, device=dev)
    emult[e_s[eend]] = dcount[eend]
    mult_pos = emult[cvals]
    km_pos = kmers[cvals]

    # ---- 2. per-closure tail-window seed
    pstart = seg.run_starts(ccid)
    csum = torch.cumsum(km_pos, 0)
    pend = seg.run_end_mask(pstart)
    pall = torch.arange(P, device=dev)
    rend_pos = _bcast_back(torch.where(pend, pall, BIG))
    suf_excl = csum[rend_pos] - csum  # kmers strictly after the position
    in_window = suf_excl < min_over
    cmin_mult = _scatter(torch.full((C + 1,), BIG, dtype=torch.int64, device=dev),
                         torch.where(in_window, ccid, C), mult_pos, "amin")
    tied = in_window & (mult_pos == cmin_mult[ccid])
    cseed_pos = _scatter(torch.full((C + 1,), -1, dtype=torch.int64, device=dev),
                         torch.where(tied, ccid, C), cpos, "amax")
    is_seed = tied & (cpos == cseed_pos[ccid])

    # ---- 3. candidate join: seeds x their edge-run partners
    (e3, c3, p3), (s3,) = _sorted((cvals, ccid, cpos), (is_seed,))
    ps = pall
    est3 = seg.run_starts(e3)
    run_start3 = scan_max(None, est3, 0)
    rend3 = seg.run_end_mask(est3)
    run_end3 = _bcast_back(torch.where(rend3, ps, BIG))
    run_len3 = run_end3 - run_start3 + 1

    # compact the seed rows to (C,) arrays (K2); rows past nseed are never
    # read (no seed owns a partner there)
    nseed, cols = compact(s3, ps, run_start3, run_len3, c3, p3)
    srow, s_rs, s_rl, s_c, s_p = (x[:C] for x in cols)
    live_seed = torch.arange(C, device=dev) < nseed
    sizes = torch.where(live_seed, s_rl - 1, 0)
    owner, t, cand_overflow = ragged_expand(sizes, cand_budget)
    # partner row: skip the seed's own slot within its run
    in_run_seed = srow[owner] - s_rs[owner]
    prow = s_rs[owner] + t + (t >= in_run_seed).long()
    ca, cj1, cb, cj2 = s_c[owner], s_p[owner], c3[prow], p3[prow]
    other = cb != ca  # host skips i2 == i1
    ca = torch.where(other, ca, BIG)
    cb = torch.where(other, cb, BIG)

    # ---- 4. dedup on (c1, c2, offset)
    off = cj1 - cj2 + P
    (k1, k2, k3), (q1, q2) = _sorted((ca, cb, off), (cj1, cj2))
    first = seg.run_starts(k1, k2, k3)
    live0 = first & (k1 < BIG)
    c1v, c2v = torch.where(live0, k1, BIG), torch.where(live0, k2, BIG)
    j1v, j2v = torch.where(live0, q1, 0), torch.where(live0, q2, 0)

    # ---- 5. pairwise maximal extension
    coffs = torch.cumsum(clen, 0) - clen
    cvp = torch.cat([cvals, torch.full((1,), BIG, dtype=torch.int64, device=dev)])
    s1, s2, L, o1c, l1c, _ = _extend(cvp, coffs, clen, c1v, j1v, c2v, j2v, live0)

    # ---- 6. end-reaching filter + adaptive gate
    prefx = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), csum])
    over = torch.where(live0, prefx[torch.clamp(o1c + s1 + L, 0, P)]
                       - prefx[torch.clamp(o1c + s1, 0, P)], 0)
    reach = (s1 + L >= l1c) & ((s1 == 0) | (s2 == 0))
    cand_ok = live0 & reach
    gate = min_over
    if adaptive:
        n_c = int(cand_ok.sum())
        if n_c:
            (overs_sorted,), _ = _sorted((torch.where(cand_ok, over, UBIG),), ())
            p30 = int(overs_sorted[k30_index(n_c)])
            gate = min(max(p30, min_over_floor), min_over)
    acc = cand_ok & (over >= gate)

    # ---- 7. long-edge matches: next <= long_shift run neighbours per row
    longrow = kmers[e3] >= gate
    big_run = run_len3 > 1
    lsizes = torch.where(longrow & big_run, torch.clamp(run_end3 - ps, max=long_shift), 0)
    lowner, lt, long_overflow = ragged_expand(lsizes, long_budget)
    lprow = lowner + 1 + lt
    la, lj1, lb, lj2 = c3[lowner], p3[lowner], c3[lprow], p3[lprow]
    ls1, ls2, lL, _, _, _ = _extend(cvp, coffs, clen, la, lj1, lb, lj2,
                                    torch.ones_like(la, dtype=torch.bool))

    # ---- 8. boundary union pairs + rc images, ragged-expanded
    mc1 = torch.cat([c1v[acc], la])
    ms1 = torch.cat([s1[acc], ls1])
    mc2 = torch.cat([c2v[acc], lb])
    ms2 = torch.cat([s2[acc], ls2])
    mL = torch.cat([L[acc], lL])
    ac = torch.cat([mc1, cinv[mc1]])
    av = torch.cat([ms1, clen[mc1] - (ms1 + mL)])
    bc_ = torch.cat([mc2, cinv[mc2]])
    bv = torch.cat([ms2, clen[mc2] - (ms2 + mL)])
    b1 = cstart[ac] + av
    b2 = cstart[bc_] + bv
    uowner, ut, pair_overflow = ragged_expand(torch.cat([mL, mL]) + 1, pair_budget)
    ua = b1[uowner] + ut
    ub = b2[uowner] + ut

    # ---- 9. union-find to fixpoint (hook by scatter-min + pointer jumps)
    def hook(lab, ta, tb, m):
        """lab[ta] and lab[tb] lowered to m."""
        lab = lab.scatter_reduce(0, ta, m, "amin", include_self=True)
        return lab.scatter_reduce_(0, tb, m, "amin", include_self=True)

    def jump(lab, times):
        for _ in range(times):
            lab = torch.minimum(lab, lab[lab])
        return lab

    def fixpoint(step, lab):
        while True:
            nxt = step(lab)
            if torch.equal(nxt, lab):
                return nxt
            lab = nxt

    uf_round = lambda lab: jump(hook(lab, ua, ub, torch.minimum(lab[ua], lab[ub])), 2)
    label = fixpoint(uf_round, uf_round(torch.arange(B, device=dev)))

    # ---- 10. Zipper to fixpoint
    inst_b = cstart[ccid] + cpos

    def zip_pass(lab, heads_off, tails_off):
        h = lab[torch.clamp(inst_b + heads_off, 0, B - 1)]
        t_ = lab[torch.clamp(inst_b + tails_off, 0, B - 1)]
        (hk, lk), (tk,) = _sorted((h, cvals), (t_,))
        same = (hk[1:] == hk[:-1]) & (lk[1:] == lk[:-1])
        ta, tb = tk[1:][same], tk[:-1][same]
        return jump(hook(lab, ta, tb, torch.minimum(ta, tb)), 3)

    label = fixpoint(lambda lab: zip_pass(zip_pass(lab, 0, 1), 1, 0), label)
    rows = (owner.shape[0], lowner.shape[0], uowner.shape[0])
    return jump(label, 4), (cand_overflow, long_overflow, pair_overflow), rows


# ------------------------------------------------------------------- host IO

def glue_closures_device(bg, cls, min_over_bases, adaptive: bool, device,
                         min_over_floor_bases: int = 100, info: dict | None = None,
                         budgets: tuple | None = None):
    """Host wrapper: sanitized closures -> boundary labels (numpy int64),
    the same partition as the native/python cores, computed on `device`
    (CUDA: K4 and K2; the CPU: their plain twins).  `budgets`, when given,
    are the (candidate, long-pair, union-pair) row budgets of glue_device;
    None sizes every expansion exactly.  Returns None when a budget
    overflowed (the caller runs the host core).  `info`, when given,
    receives "overflow" (the three overflow counts), "positions" (P) and
    "rows" (the candidate, long-pair and union-pair rows)."""
    from ..core.kmer_codec import K

    n = len(cls)
    if n == 0:
        return np.zeros(0, np.int64)
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=cstart[1:])
    total = int(cstart[-1])
    offs = np.cumsum(lens) - lens
    cvals = np.concatenate([np.asarray(c, np.int64) for c in cls])
    ccid = np.repeat(np.arange(n, dtype=np.int64), lens)
    cpos = np.arange(len(cvals), dtype=np.int64) - np.repeat(offs, lens)
    inv = bg.inv
    idx = {c: i for i, c in enumerate(cls)}
    cin = np.array(
        [idx[tuple(int(inv[e]) for e in reversed(c))] for c in cls], dtype=np.int64
    )
    kmers = (bg.edges.lengths() - (K - 1)).astype(np.int64)
    cand_b, long_b, pair_b = budgets or (None, None, None)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    labels, ovf, rows = glue_device(
        t(cvals), t(ccid), t(cpos), t(cstart[:n]), t(lens), t(cin), t(kmers),
        n_bound=total,
        min_over=max(min_over_bases - (K - 1), 1),
        min_over_floor=max(min_over_floor_bases - (K - 1), 1),
        adaptive=adaptive,
        cand_budget=cand_b, long_budget=long_b, pair_budget=pair_b,
    )
    if info is not None:
        info.update(overflow=tuple(int(x) for x in ovf), positions=len(cvals), rows=rows)
    if any(x > 0 for x in ovf):
        return None
    return labels.cpu().numpy()
