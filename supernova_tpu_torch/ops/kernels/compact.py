"""K2: stable stream compaction (kernel in csrc/compact.cu).

Replaces supernova_tpu/ops/pallas/compact.py:compact_stream_pallas.
Moves the rows where `valid` holds to the front of every column, keeping
their order; returns (n_valid 0-d int64 tensor, compacted columns).  Rows
past n_valid are UNSPECIFIED on the card (the caller zeroes them).
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

MAX_COLS = 8
TILE = 4096  # rows per block of the count/scatter passes (csrc/compact.cu)
_ESIZE = {torch.int32: 4, torch.int64: 8}


def compact_plain(valid: torch.Tensor, *cols: torch.Tensor):
    """Plain PyTorch twin: boolean-mask selection (stable); rows past
    n_valid are zero."""
    n_valid = valid.sum(dtype=torch.int64)
    k = int(n_valid)
    out = []
    for c in cols:
        o = torch.zeros_like(c)
        o[:k] = c[valid]
        out.append(o)
    return n_valid, tuple(out)


def compact_cuda(valid: torch.Tensor, *cols: torch.Tensor):
    """Launch K2: valid (n,) bool and 1..8 int32/int64 columns of length n,
    all contiguous on one card."""
    dev = valid.device
    n = valid.shape[0]
    _lib.require(valid, "valid", torch.bool, dev)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"compact takes 1..{MAX_COLS} columns, got {len(cols)}")
    for j, c in enumerate(cols):
        if c.dtype not in _ESIZE:
            raise TypeError(f"column {j}: dtype {c.dtype} not int32/int64")
        _lib.require(c, f"column {j}", c.dtype, dev, n)
    outs = tuple(torch.empty_like(c) for c in cols)
    nblocks = -(-n // TILE)
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(nblocks, dtype=torch.int64, device=dev)
    n_valid = torch.empty((), dtype=torch.int64, device=dev)
    in_ptrs = (ctypes.c_uint64 * MAX_COLS)(*(c.data_ptr() for c in cols))
    out_ptrs = (ctypes.c_uint64 * MAX_COLS)(*(o.data_ptr() for o in outs))
    esizes = (ctypes.c_int * MAX_COLS)(*(_ESIZE[c.dtype] for c in cols))
    lib = _lib.library()
    _lib.check(
        lib.sn_compact(
            valid.data_ptr(), n, len(cols),
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
            ctypes.addressof(esizes),
            counts.data_ptr(), offsets.data_ptr(), n_valid.data_ptr(),
            _lib.stream_ptr(dev),
        ),
        "compact",
    )
    compact.launches += 1
    return n_valid, outs


def compact(valid: torch.Tensor, *cols: torch.Tensor):
    """Stable compaction.  A CPU tensor takes the plain twin; a CUDA tensor
    launches K2 (or raises)."""
    if valid.device.type == "cpu":
        return compact_plain(valid, *cols)
    return compact_cuda(valid, *cols)


compact.launches = 0
