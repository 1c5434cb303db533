"""K1: sliding 48-mer word extraction (kernel in csrc/kmer_extract.cu).

Replaces supernova_tpu/ops/pallas/kmer_extract.py:sliding_words_pallas.
For each start p < n: the three words packing bases p..p+47, 16 bases per
word, 2 bits per base, MSB first, as int64 (zero-extended 32-bit words).
"""
from __future__ import annotations

import torch

from . import _lib

K = 48


def launch_bytes(m: int, n: int) -> int:
    """Bytes one launch moves: read m int32 codes, write three int64 words
    at each of n starts."""
    return m * 4 + n * 3 * 8


def sliding_words_plain(codes: torch.Tensor, n: int):
    """Plain PyTorch twin: 48 shifted slices, shift-or'd into three words."""
    c = codes.to(torch.int64)
    words = []
    for w in range(3):
        acc = torch.zeros(n, dtype=torch.int64, device=codes.device)
        for i in range(16):
            off = w * 16 + i
            acc = (acc << 2) | c[off : off + n]
        words.append(acc)
    return tuple(words)


def sliding_words_cuda(codes: torch.Tensor, n: int):
    """Launch K1.  codes: contiguous (M,) int32 on the card, M >= n + 47."""
    dev = codes.device
    _lib.require(codes, "codes", torch.int32, dev)
    m = codes.shape[0]
    if n < 0 or m < n + K - 1:
        raise ValueError(f"codes length {m} < n + {K - 1} (n={n})")
    out = tuple(torch.empty(n, dtype=torch.int64, device=dev) for _ in range(3))
    if n == 0:
        return out
    lib = _lib.library()
    _lib.check(
        lib.sn_kmer_extract(
            codes.data_ptr(), n, m, *(o.data_ptr() for o in out),
            _lib.stream_ptr(dev),
        ),
        "kmer_extract",
    )
    sliding_words.launches += 1
    sliding_words.bytes += launch_bytes(m, n)
    return out


def sliding_words(codes: torch.Tensor, n: int):
    """(w0, w1, w2) int64 words at every start 0..n-1.  A CPU tensor takes
    the plain twin; a CUDA tensor launches K1 (or raises)."""
    if codes.device.type == "cpu":
        if codes.shape[0] < n + K - 1:
            raise ValueError(f"codes length {codes.shape[0]} < n + {K - 1}")
        return sliding_words_plain(codes, n)
    with torch.cuda.device(codes.device):  # the launch's card, where a process holds several
        return sliding_words_cuda(codes, n)


sliding_words.launches = 0
sliding_words.bytes = 0
