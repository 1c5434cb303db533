"""The plain reference of the 48-mer count: reads -> the kmer table.

What the table holds, from the reads alone:

- a read's good length is the longest prefix whose last 48 bases all have
  quality >= MIN_QUAL (0 if none); a read whose good length is below
  MIN_READ_LEN gives nothing;
- each 48-mer inside the good prefix is one occurrence of its canonical
  form (the smaller of it and its reverse complement), with the base
  before it (when it is not the read's first) and the base after it (when
  that base lies inside the good prefix) as one-bit masks, both turned
  over with the kmer when it is flipped;
- per canonical kmer: count = occurrences, nbc = distinct barcode ids > 0,
  and the masks OR-ed; it is kept when count >= MIN_FREQ and (an
  occurrence is unbarcoded or nbc >= MIN_BC);
- the kept kmers ascending, padded with sentinel rows (all-ones words,
  zero counts) to `geom_bucket(n)` rows;
- each mask bit survives only where the neighbouring kmer it names is in
  the table.

`lo_mask` is the control: kmers counted on a key that keeps only the
masked bits of `lo` (the first 32 bases at 0xFFFF00000000), each group
reported under its smallest kmer; the table's other rules stay.
"""
from __future__ import annotations

import torch

from .kmers import K, MASK48, canonical, halves_at, lookup, predecessor, rev_comp, successor

MIN_QUAL = 7
MIN_FREQ = 3
MIN_BC = 2
MIN_READ_LEN = K + 1


def geom_bucket(n: int, quantum: int = 1024, ratio: float = 1.25) -> int:
    """The table's row count for n kmers: the first rung >= n of the
    ladder quantum, then each rung ratio times the last, rounded up to a
    multiple of quantum."""
    m = quantum
    while m < n:
        m = -(-int(m * ratio) // quantum) * quantum
    return m


def good_lengths(quals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per read, the longest prefix whose last K bases all have quality >=
    MIN_QUAL, 0 where there is none."""
    n = quals.shape[0]
    dev = quals.device
    nreads = offsets.shape[0] - 1
    bad = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    bad[1:] = torch.cumsum((quals < MIN_QUAL).long(), 0)
    lens = offsets[1:] - offsets[:-1]
    read = torch.repeat_interleave(torch.arange(nreads, device=dev), lens, output_size=n)
    end = torch.arange(1, n + 1, device=dev)  # a prefix ending after this base
    start = offsets[read]
    clean = (end - start >= K) & (bad[end] - bad[(end - K).clamp(min=0)] == 0)
    glen = torch.zeros(nreads, dtype=torch.int64, device=dev)
    glen.scatter_reduce_(0, read, torch.where(clean, end - start, 0), "amax")
    return glen


def occurrences(codes: torch.Tensor, quals: torch.Tensor, offsets: torch.Tensor,
                bc: torch.Tensor, chunk: int = 1 << 26):
    """Every occurrence -> (hi, lo, bc, left mask, right mask), canonical,
    in blocks of `chunk` positions."""
    dev = codes.device
    codes = codes.long()
    offsets = offsets.long()
    glen = good_lengths(quals, offsets)
    nk = torch.where(glen >= MIN_READ_LEN, glen - K + 1, 0)  # kmers a read gives
    nocc = int(nk.sum())
    read = torch.repeat_interleave(torch.arange(nk.shape[0], device=dev), nk, output_size=nocc)
    pir = torch.arange(nocc, device=dev) - (torch.cumsum(nk, 0) - nk)[read]
    parts = []
    for s in range(0, nocc, chunk):
        r, p = read[s : s + chunk], pir[s : s + chunk]
        at = offsets[r] + p
        hi, lo = halves_at(codes, at)
        rhi, rlo = halves_at(codes, at, rc=True)
        chi, clo, flip = canonical(hi, lo, rhi, rlo)
        del hi, lo, rhi, rlo
        has_pred = p > 0
        has_succ = p + K < glen[r]
        pred = codes[(at - 1).clamp(min=0)]
        succ = codes[(at + K).clamp(max=codes.shape[0] - 1)]
        one = torch.ones_like(p)
        lm = torch.where(has_pred, one << pred, 0)
        rm = torch.where(has_succ, one << succ, 0)
        lm_f = torch.where(has_succ, one << (succ ^ 3), 0)
        rm_f = torch.where(has_pred, one << (pred ^ 3), 0)
        parts.append((chi, clo, bc[r].long(), torch.where(flip, lm_f, lm),
                      torch.where(flip, rm_f, rm)))
    if not parts:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z, z, z
    return tuple(torch.cat(c) for c in zip(*parts))


def _sort_rows(*keys):
    """The permutation that sorts rows by keys[0], then keys[1], ... (stable
    sorts from the last key to the first)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def count_table(codes, quals, offsets, bc, lo_mask: int = MASK48) -> dict:
    """The reads' kmer table: dict of hi, lo, count, nbc, lm, rm (n rows,
    ascending) and rows (the padded row count)."""
    hi, lo, obc, lm, rm = occurrences(codes, quals, offsets, bc)
    keys = (hi, lo, obc) if lo_mask == MASK48 else (hi, lo & lo_mask, lo, obc)
    perm = _sort_rows(*keys)
    hi, lo, obc, lm, rm = hi[perm], lo[perm], obc[perm], lm[perm], rm[perm]
    del perm
    key = lo & lo_mask
    n = hi.shape[0]
    dev = hi.device
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (hi[1:] != hi[:-1]) | (key[1:] != key[:-1])
    gid = torch.cumsum(new.long(), 0) - 1
    first = torch.nonzero(new).squeeze(1)
    g = first.shape[0]

    def total(x):
        return torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, gid, x.long())

    count = total(torch.ones_like(gid))
    new_bc = new.clone()
    new_bc[1:] |= obc[1:] != obc[:-1]
    nbc = total(new_bc & (obc > 0))
    unbarcoded = total(obc == 0) > 0
    lmask = torch.zeros(g, dtype=torch.int64, device=dev)
    rmask = torch.zeros(g, dtype=torch.int64, device=dev)
    for b in range(4):
        lmask |= (total((lm >> b) & 1) > 0).long() << b
        rmask |= (total((rm >> b) & 1) > 0).long() << b
    keep = (count >= MIN_FREQ) & (unbarcoded | (nbc >= MIN_BC))
    t = dict(hi=hi[first][keep], lo=lo[first][keep], count=count[keep], nbc=nbc[keep],
             lm=lmask[keep], rm=rmask[keep])
    return recompute_masks(t)


def recompute_masks(t: dict) -> dict:
    """Keep a mask bit only where the kmer it leads to is in the table."""
    hi, lo = t["hi"], t["lo"]
    rhi, rlo = rev_comp(hi, lo)
    lm = torch.zeros_like(t["lm"])
    rm = torch.zeros_like(t["rm"])
    for b in range(4):
        # the successor by b, and its reverse complement: the predecessor
        # of the reverse complement by the complement of b
        shi, slo = successor(hi, lo, b)
        srhi, srlo = predecessor(rhi, rlo, b ^ 3)
        chi, clo, _ = canonical(shi, slo, srhi, srlo)
        rm |= lookup(hi, lo, chi, clo)[1].long() << b
        phi, plo = predecessor(hi, lo, b)
        prhi, prlo = successor(rhi, rlo, b ^ 3)
        chi, clo, _ = canonical(phi, plo, prhi, prlo)
        lm |= lookup(hi, lo, chi, clo)[1].long() << b
    out = dict(t)
    out["lm"] = t["lm"] & lm
    out["rm"] = t["rm"] & rm
    out["rows"] = geom_bucket(max(int(hi.shape[0]), 1))
    return out
