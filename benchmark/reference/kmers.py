"""48-mers as two 48-bit halves, for the plain reference.

A 48-mer is (hi, lo): hi packs bases 0..23 and lo bases 24..47, two bits
a base (A=0, C=1, G=2, T=3), the first base highest, each in a
non-negative int64.  (hi, lo) order is base order.  The complement of a
base code c is c ^ 3.
"""
from __future__ import annotations

import math

import torch

K = 48
HALF = 24
MASK48 = (1 << 48) - 1


def halves_at(codes: torch.Tensor, starts: torch.Tensor, rc: bool = False):
    """(hi, lo) of the 48-mers starting at flat positions `starts` of the
    int64 base codes `codes`, or of their reverse complements."""
    hi = torch.zeros_like(starts)
    lo = torch.zeros_like(starts)
    for k in range(HALF):
        if rc:
            hi = (hi << 2) | (codes[starts + (K - 1 - k)] ^ 3)
            lo = (lo << 2) | (codes[starts + (HALF - 1 - k)] ^ 3)
        else:
            hi = (hi << 2) | codes[starts + k]
            lo = (lo << 2) | codes[starts + HALF + k]
    return hi, lo


def rev_comp(hi, lo):
    """Reverse complement of 48-mers given as halves."""
    def rev(x):
        out = torch.zeros_like(x)
        for k in range(HALF):
            out = (out << 2) | (((x >> (2 * k)) & 3) ^ 3)
        return out
    return rev(lo), rev(hi)


def less(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def canonical(hi, lo, rhi, rlo):
    """(canonical hi, lo, flipped): the smaller of a kmer and its reverse
    complement (rhi, rlo); flipped where the reverse complement is
    strictly smaller."""
    flip = less(rhi, rlo, hi, lo)
    return torch.where(flip, rhi, hi), torch.where(flip, rlo, lo), flip


def successor(hi, lo, b):
    """Drop the first base, append base b."""
    return ((hi << 2) & MASK48) | (lo >> 46), ((lo << 2) & MASK48) | b


def predecessor(hi, lo, b):
    """Drop the last base, prepend base b."""
    return (hi >> 2) | (b << 46), ((hi & 3) << 46) | (lo >> 2)


def lookup(thi, tlo, qhi, qlo, lo_mask: int = MASK48):
    """Rows of the queries in the table sorted by (thi, tlo) -> (row,
    found); row is 0 where not found.  torch.searchsorted finds each
    query's run of equal `hi`, a binary search on `lo` inside it.
    lo_mask < MASK48 compares only those bits of `lo` (the control's
    shortened key; the table's masked `lo` must then be sorted too)."""
    m = thi.shape[0]
    if m == 0:
        z = torch.zeros_like(qhi)
        return z, z.bool()
    first = torch.searchsorted(thi, qhi, side="left")
    end = torch.searchsorted(thi, qhi, side="right")
    widest = int((end - first).max()) if qhi.numel() else 0
    a, b = first, end
    qlo = qlo & lo_mask
    for _ in range(max(1, math.ceil(math.log2(widest + 1)) + 1)):
        mid = (a + b) >> 1
        go_right = (mid < b) & ((tlo[mid.clamp(max=m - 1)] & lo_mask) < qlo)
        a, b = torch.where(go_right, mid + 1, a), torch.where(go_right, b, mid)
    at = a.clamp(max=m - 1)
    found = (a < end) & (thi[at] == qhi) & ((tlo[at] & lo_mask) == qlo)
    return torch.where(found, a, 0), found
