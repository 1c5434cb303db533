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

import torch

from . import _lib

MAX_KEYS = 6
TILE = 4096  # rows per tile of a radix pass (csrc/radix_sort.cu)
RADIX = 256
DIGITS = 4  # 8-bit digits of a 32-bit key


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
    order as it is."""
    vary = (and_bits ^ or_bits) & 0xFFFFFFFF
    return [d for d in range(DIGITS) if (vary >> (8 * d)) & 0xFF]


def lex_argsort_cuda(*keys):
    """Launch K4 on contiguous (n,) int64 keys on one card, n < 2^31.

    Reduces every key to the AND and the OR of its rows first and reads
    them back (one synchronisation per sort): a digit whose bits agree in
    both is the same in every row and needs no pass, and a key with no
    other digit is never staged."""
    dev = keys[0].device
    n = keys[0].shape[0]
    for j, k in enumerate(keys):
        _lib.require(k, f"key {j}", torch.int64, dev, n)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the radix sort carries 32-bit row indices")
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return perm
    lib = _lib.library()
    stream = _lib.stream_ptr(dev)
    and_or = torch.empty((len(keys), 2), dtype=torch.int32, device=dev)
    for j, k in enumerate(keys):
        _lib.check(lib.sn_radix_bits(k.data_ptr(), n, and_or[j].data_ptr(), stream), "sort")
    live = [live_digits(a, o) for a, o in and_or.cpu().tolist()]
    kv = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    idx = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    ntiles = -(-n // TILE)
    counts = torch.empty(RADIX * ntiles, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    totals = torch.empty(RADIX, dtype=torch.int32, device=dev)
    cur, staged = 0, False
    for j in reversed(range(len(keys))):
        if not live[j]:
            continue
        _lib.check(lib.sn_radix_gather(keys[j].data_ptr(), idx[cur].data_ptr(), n,
                                       int(not staged), kv[cur].data_ptr(), stream), "sort")
        staged = True
        for d in live[j]:
            _lib.check(lib.sn_radix_pass(
                kv[cur].data_ptr(), idx[cur].data_ptr(), n, 8 * d,
                counts.data_ptr(), offsets.data_ptr(), totals.data_ptr(),
                kv[1 - cur].data_ptr(), idx[1 - cur].data_ptr(), stream,
            ), "sort")
            cur = 1 - cur
    _lib.check(lib.sn_radix_perm(idx[cur].data_ptr() if staged else None, n,
                                 perm.data_ptr(), stream), "sort")
    lex_argsort.launches += 1
    return perm


def lex_argsort(*keys):
    """Stable lexicographic argsort (int64 permutation) by 1..6 keys.  CPU
    tensors take the plain twin; CUDA tensors launch K4 (or raise)."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"lex_argsort takes 1..{MAX_KEYS} keys, got {len(keys)}")
    if keys[0].device.type == "cpu":
        return lex_argsort_plain(*keys)
    return lex_argsort_cuda(*keys)


lex_argsort.launches = 0
