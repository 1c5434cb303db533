"""48-mer codec on torch tensors: pack / reverse-complement / canonicalize /
lexicographic sort / search.  Port of supernova_tpu/core/kmer_codec.py.

A 48-mer is 96 bits: three 32-bit words of 16 bases, 2 bits per base, MSB
first, so lexicographic (a, b, c) order is base order with A<C<G<T.  The
port holds every word ZERO-EXTENDED IN int64, on the CPU and on the card
alike: torch on the CPU has no `<`, `>>`, cummax, searchsorted or scatter
for uint32, and one layout lets the plain path and the kernels exchange the
same tensors (torch.equal compares them).  Two consequences:
  * `~w` and left shifts leave bits above 31; they are masked back with
    M32 wherever the result is a word;
  * a word with its top bit set is a large positive int64, so signed
    compares order it like the unsigned word (the uint32 hazard of a
    signed 32-bit layout does not arise).

Every multi-key sort goes through `lex_argsort` (ops/kernels/sort.py): the
stable radix argsort K4 on the card, chained stable torch.sort passes on
the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels.sort import lex_argsort

K = 48
BASES_PER_WORD = 16
KWORDS = K // BASES_PER_WORD  # 3
SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF


class W3(NamedTuple):
    """A batch of packed 48-mers as three parallel int64 tensors."""

    a: torch.Tensor  # bases 0..15
    b: torch.Tensor  # bases 16..31
    c: torch.Tensor  # bases 32..47

    def gather(self, idx):
        return W3(self.a[idx], self.b[idx], self.c[idx])

    def where(self, cond, other):
        """elementwise select: cond ? self : other (other may be a scalar)."""
        if isinstance(other, W3):
            return W3(*(torch.where(cond, x, o) for x, o in zip(self, other)))
        return W3(*(torch.where(cond, x, other) for x in self))

    @property
    def shape(self):
        return self.a.shape


def soa_to_np(w: W3) -> np.ndarray:
    """W3 -> host (N, 3) uint32 (the reference's serialization layout)."""
    return np.stack(
        [x.cpu().numpy().astype(np.uint32) for x in (w.a, w.b, w.c)], axis=-1
    )


def np_to_soa(arr: np.ndarray, device) -> W3:
    """(N, 3) uint32 host array -> W3 of int64 tensors on `device`."""
    arr = np.asarray(arr, dtype=np.uint32).astype(np.int64)
    return W3(*(torch.from_numpy(np.ascontiguousarray(arr[:, j])).to(device)
                for j in range(3)))


# ------------------------------------------------------------------ packing

def sliding_words(codes: torch.Tensor, n: int) -> W3:
    """Packed kmer words at every start position 0..n-1.

    codes: (M,) int32 base codes 0..3, M >= n + K - 1.  A CUDA tensor goes
    through kernel K1 (csrc/kmer_extract.cu); a CPU tensor through its plain
    shift-or twin."""
    from ..ops.kernels.kmer_extract import sliding_words as k1

    return W3(*k1(codes, n))


def _rev16(w):
    """Reverse the 16 2-bit base fields within each 32-bit word."""
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) & M32) | (w >> 16)


def rc_words(w: W3) -> W3:
    """Reverse complement (complement is bitwise NOT; order reverses)."""
    return W3(_rev16(~w.c & M32), _rev16(~w.b & M32), _rev16(~w.a & M32))


def lex_lt(x: W3, y: W3):
    """x < y lexicographically -> (N,) bool."""
    return (x.a < y.a) | ((x.a == y.a) & ((x.b < y.b) | ((x.b == y.b) & (x.c < y.c))))


def lex_eq(x: W3, y: W3):
    return (x.a == y.a) & (x.b == y.b) & (x.c == y.c)


def is_sentinel(x: W3):
    return (x.a == SENTINEL) & (x.b == SENTINEL) & (x.c == SENTINEL)


def canonicalize(w: W3):
    """Canonical = min(fwd, rc).  Returns (canon W3, flipped (N,) bool)."""
    rc = rc_words(w)
    flipped = lex_lt(rc, w)
    return rc.where(flipped, w), flipped


def successor_words(w: W3, base) -> W3:
    """Shift one base left, append `base` (0..3) at the 3' end."""
    return W3(
        ((w.a << 2) & M32) | (w.b >> 30),
        ((w.b << 2) & M32) | (w.c >> 30),
        ((w.c << 2) & M32) | base,
    )


def predecessor_words(w: W3, base) -> W3:
    """Shift one base right, prepend `base` (0..3) at the 5' end."""
    return W3(
        (w.a >> 2) | (base << 30),
        (w.b >> 2) | ((w.a & 3) << 30),
        (w.c >> 2) | ((w.b & 3) << 30),
    )


def last_base(w: W3):
    return w.c & 3


def unpack_bases(w: W3):
    """W3 -> (N, 48) int64 base codes."""
    shifts = 2 * (15 - torch.arange(16, device=w.a.device))
    return torch.cat(
        [(word[:, None] >> shifts[None, :]) & 3 for word in (w.a, w.b, w.c)],
        dim=1,
    )


# ---------------------------------------------------------------- sorting

def sort_by_words(w: W3, extra_keys=(), payloads=()):
    """Lexicographic (stable) sort by the 3 kmer words + extra key columns.

    Returns (W3 sorted, extra_keys_sorted tuple, payloads_sorted tuple).
    The reference's `lax.sort` may order fully-equal rows differently only
    where the rows are identical, so results agree."""
    perm = lex_argsort(w.a, w.b, w.c, *extra_keys)
    return (
        w.gather(perm),
        tuple(k[perm] for k in extra_keys),
        tuple(p[perm] for p in payloads),
    )


def searchsorted_words(table: W3, query: W3):
    """First index i in sorted `table` with table[i] >= query row (the
    reference's branchless binary search, clamped gathers included).
    Returns (idx (N,) int64, found (N,) bool)."""
    m = table.a.shape[0]
    n = query.a.shape[0]
    dev = query.a.device
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), m, dtype=torch.int64, device=dev)
    steps = max(1, int(math.ceil(math.log2(max(m, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        less = lex_lt(table.gather(mid.clamp(0, m - 1)), query)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    hit = lex_eq(table.gather(lo.clamp(0, m - 1)), query) & (lo < m)
    return lo, hit


def lookup_words_merge(table: W3, query: W3):
    """Bulk dictionary lookup as a sort-merge join.

    table must be lexicographically sorted (sentinel-padded).  Returns
    (row (N,) int64 = matching table row (unspecified when not found),
     found (N,) bool)."""
    m = table.a.shape[0]
    n = query.a.shape[0]
    dev = query.a.device
    ka = torch.cat([table.a, query.a])
    kb = torch.cat([table.b, query.b])
    kc_ = torch.cat([table.c, query.c])
    tag = torch.cat([
        torch.zeros(m, dtype=torch.int64, device=dev),
        torch.ones(n, dtype=torch.int64, device=dev),
    ])
    perm = lex_argsort(ka, kb, kc_, tag)
    sa, sb, sc = ka[perm], kb[perm], kc_[perm]
    is_table = perm < m
    sidx = torch.where(is_table, perm, perm - m)
    pos = torch.arange(m + n, device=dev)
    # table rows arrive pre-sorted, so their row ids increase in merged
    # order and a cummax propagates the latest table row exactly
    last_tpos = torch.cummax(torch.where(is_table, pos, -1), 0).values
    last_trow = torch.cummax(torch.where(is_table, sidx, -1), 0).values
    wstarts = torch.ones(m + n, dtype=torch.bool, device=dev)
    wstarts[1:] = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1]) | (sc[1:] != sc[:-1])
    last_run_start = torch.cummax(torch.where(wstarts, pos, 0), 0).values
    found_here = last_tpos >= last_run_start
    # back to query order: query slots are a permutation, so every target
    # index is written exactly once
    isq = ~is_table
    qslot = sidx[isq]
    row = torch.empty(n, dtype=torch.int64, device=dev)
    row[qslot] = last_trow[isq].clamp(min=0)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    found[qslot] = found_here[isq]
    return row, found


# ------------------------------------------------------------- host helpers

def words_from_codes_np(codes: np.ndarray) -> np.ndarray:
    """Reference numpy packing of a single K-length code array -> (3,) uint32."""
    codes = np.asarray(codes, dtype=np.uint64)
    assert codes.shape[0] == K
    out = np.zeros(KWORDS, dtype=np.uint32)
    for w in range(KWORDS):
        acc = np.uint64(0)
        for i in range(BASES_PER_WORD):
            acc = (acc << np.uint64(2)) | codes[w * BASES_PER_WORD + i]
        out[w] = np.uint32(acc)
    return out


def codes_from_words_np(words: np.ndarray) -> np.ndarray:
    """(3,) uint32 -> (48,) uint8 base codes."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.zeros(K, dtype=np.uint8)
    for w in range(KWORDS):
        v = int(words[w])
        for i in range(BASES_PER_WORD):
            out[w * BASES_PER_WORD + i] = (v >> (2 * (BASES_PER_WORD - 1 - i))) & 3
    return out
