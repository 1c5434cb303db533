"""K4: stable multi-key argsort (kernel in csrc/radix_sort.cu).

Replaces supernova_tpu/ops/pallas/sort.py:sort_bitonic_pallas.
`lex_argsort(*keys)` is the permutation that sorts the rows
lexicographically by 1..6 keys, first key most significant, STABLE (ties
keep their input order, so the permutation is unique and the kernel equals
its plain twin exactly).  Each key is a contiguous int64 tensor holding a
value in [0, 2^32) (the port's word layout, core/kmer_codec.py).  With all
operands as keys it is the TPU kernel's sort; payloads are gathered by the
permutation.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

MAX_KEYS = 6
RADIX = 256
DIGITS = 4  # 8-bit digits of a 32-bit key


def launch_bytes(rows: int, keys: int) -> int:
    """Bytes one sort moves: read every int64 key once, write the int64
    permutation."""
    return rows * 8 * (keys + 1)


def _pair(hi, lo):
    """Two keys in [0, 2^32) -> one int64 key with the same order: hi is
    shifted to [-2^31, 2^31) (the sign-bit flip) so hi * 2^32 + lo spans
    the whole int64 range without overflow."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def lex_argsort_plain(*keys):
    """Plain PyTorch twin: keys packed two per int64, sorted by chained
    stable torch.sort passes from the last packed key to the first."""
    packed = [
        _pair(keys[i], keys[i + 1]) if i + 1 < len(keys) else keys[i]
        for i in range(0, len(keys), 2)
    ]
    perm = None
    for k in reversed(packed):
        kk = k if perm is None else k[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def live_digits(and_bits: int, or_bits: int) -> list[int]:
    """The 8-bit digits (0 = least significant) of a 32-bit key that differ
    between rows, from the AND and the OR of its rows: a digit whose bits
    agree in both is the same in every row, and its pass would leave the
    order as it is.  The rule live_digits_from_hist is held to in tests."""
    vary = (and_bits ^ or_bits) & 0xFFFFFFFF
    return [d for d in range(DIGITS) if (vary >> (8 * d)) & 0xFF]


def live_digits_from_hist(hist: torch.Tensor, n: int) -> list[int]:
    """The same digits from a key's (DIGITS, RADIX) histogram of n rows: a
    digit is live unless one bin holds every row."""
    return [d for d in range(DIGITS) if int(hist[d].max()) < n]


def plan_passes(live: list[list[int]]) -> list[tuple[int, int]]:
    """(key, digit) of every pass, keys from the last to the first, digits
    from the least significant: LSD order, so the stable passes leave the
    rows sorted by the first key, ties by the next, and so on."""
    return [(j, d) for j in reversed(range(len(live))) for d in live[j]]


def lex_argsort_cuda(*keys):
    """Launch K4 on contiguous (n,) int64 keys on one card, n < 2^31.

    One histogram launch counts every digit of every key; the histograms
    come back in one copy (the sort's one synchronisation), and each digit
    whose bins are not all in one gets one onesweep pass."""
    dev = keys[0].device
    n = keys[0].shape[0]
    for j, k in enumerate(keys):
        _lib.require(k, f"key {j}", torch.int64, dev, n)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the radix sort carries 32-bit row indices")
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    lib = _lib.library()
    stream = _lib.stream_ptr(dev)
    hist = torch.empty((len(keys), DIGITS, RADIX), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_uint64 * len(keys))(*(k.data_ptr() for k in keys))
    _lib.check(lib.sn_radix_hist(ctypes.addressof(ptrs), len(keys), n, hist.data_ptr(), stream),
               "sort")
    lex_argsort.launches += 1
    lex_argsort.bytes += launch_bytes(n, len(keys))
    passes = plan_passes([live_digits_from_hist(h, n) for h in hist.cpu()])
    if not passes:
        return torch.arange(n, dtype=torch.int64, device=dev)
    ntiles = -(-n // lib.sn_radix_tile_rows())
    # one status word per (tile, digit value), then one tile counter per pass
    scratch = torch.zeros(ntiles * RADIX + len(passes), dtype=torch.int64, device=dev)
    counters = scratch.data_ptr() + 8 * ntiles * RADIX
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    kv = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    idx = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    cur = 0
    for p, (j, d) in enumerate(passes):
        first = p == 0 or passes[p - 1][0] != j
        last = p + 1 == len(passes) or passes[p + 1][0] != j
        # the sort's first pass reads its key in row order, a later key's
        # first pass gathers it by the indices so far, other passes read
        # the staged 32-bit keys
        src = 1 if p == 0 else 2 if first else 0
        _lib.check(lib.sn_radix_onesweep(
            src, int(not last), int(p + 1 == len(passes)),
            kv[cur].data_ptr(), idx[cur].data_ptr(), keys[j].data_ptr(), n, 8 * d,
            hist[j, d].data_ptr(), counters + 8 * p, scratch.data_ptr(), ntiles * RADIX, p + 1,
            kv[1 - cur].data_ptr(), idx[1 - cur].data_ptr(), perm.data_ptr(), stream,
        ), "sort")
        cur = 1 - cur
    return perm


def lex_argsort(*keys):
    """Stable lexicographic argsort (int64 permutation) by 1..6 keys.  CPU
    tensors take the plain twin; CUDA tensors launch K4 (or raise)."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"lex_argsort takes 1..{MAX_KEYS} keys, got {len(keys)}")
    if keys[0].device.type == "cpu":
        return lex_argsort_plain(*keys)
    with torch.cuda.device(keys[0].device):  # the launch's card, where a process holds several
        return lex_argsort_cuda(*keys)


lex_argsort.launches = 0
lex_argsort.bytes = 0
