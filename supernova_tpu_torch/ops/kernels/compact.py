"""K2: stable stream compaction (kernel in csrc/compact.cu).

Replaces supernova_tpu/ops/pallas/compact.py:compact_stream_pallas.
Moves the rows where `valid` holds to the front of every column, keeping
their order; returns (n_valid 0-d int64 tensor, compacted columns).  With
`fills` (one value per column), column k's rows past n_valid hold fills[k];
without, they are zero in the plain twin and UNSPECIFIED on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

MAX_COLS = 8
_ESIZE = {torch.int32: 4, torch.int64: 8}


def launch_bytes(rows: int, kept: int, row_bytes: int, fill: bool) -> int:
    """Bytes one launch moves: read the bool mask and the kept rows of every
    column (row_bytes a row), write the kept rows, or with a fill every
    row."""
    return rows + kept * row_bytes + (rows if fill else kept) * row_bytes


def _check_fills(cols, fills):
    """Raise unless `fills` is None or one value per column that fits the
    column's dtype."""
    if fills is None:
        return
    if len(fills) != len(cols):
        raise ValueError(f"{len(fills)} fill values for {len(cols)} columns")
    for j, (c, f) in enumerate(zip(cols, fills)):
        info = torch.iinfo(c.dtype)
        if not info.min <= int(f) <= info.max:
            raise ValueError(f"column {j}: fill {f} does not fit {c.dtype}")


def compact_plain(valid: torch.Tensor, *cols: torch.Tensor, fills=None):
    """Plain PyTorch twin: each column filled (zeros without `fills`), then
    the boolean-mask selection (stable) written over its first n_valid
    rows."""
    n_valid = valid.sum(dtype=torch.int64)
    k = int(n_valid)
    out = []
    for j, c in enumerate(cols):
        o = torch.zeros_like(c) if fills is None else torch.full_like(c, fills[j])
        o[:k] = c[valid]
        out.append(o)
    return n_valid, tuple(out)


def compact_cuda(valid: torch.Tensor, *cols: torch.Tensor, fills=None):
    """Launch K2: valid (n,) bool and 1..8 int32/int64 columns of length n,
    all contiguous on one card (the mask at any byte offset)."""
    dev = valid.device
    n = valid.shape[0]
    _lib.require(valid, "valid", torch.bool, dev)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"compact takes 1..{MAX_COLS} columns, got {len(cols)}")
    for j, c in enumerate(cols):
        if c.dtype not in _ESIZE:
            raise TypeError(f"column {j}: dtype {c.dtype} not int32/int64")
        _lib.require(c, f"column {j}", c.dtype, dev, n)
    _check_fills(cols, fills)
    outs = tuple(torch.empty_like(c) for c in cols)
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), outs
    lib = _lib.library()
    # one look-back status word per tile, then the tile counter
    scratch = torch.zeros(-(-n // lib.sn_compact_tile_rows()) + 1, dtype=torch.int64, device=dev)
    n_valid = torch.empty((), dtype=torch.int64, device=dev)
    in_ptrs = (ctypes.c_uint64 * MAX_COLS)(*(c.data_ptr() for c in cols))
    out_ptrs = (ctypes.c_uint64 * MAX_COLS)(*(o.data_ptr() for o in outs))
    esizes = (ctypes.c_int * MAX_COLS)(*(_ESIZE[c.dtype] for c in cols))
    fill_arr = None if fills is None else (ctypes.c_longlong * MAX_COLS)(*map(int, fills))
    _lib.check(
        lib.sn_compact(
            valid.data_ptr(), n, len(cols),
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(esizes),
            None if fill_arr is None else ctypes.addressof(fill_arr),
            scratch.data_ptr(), scratch.shape[0], n_valid.data_ptr(),
            _lib.stream_ptr(dev),
        ),
        "compact",
    )
    compact.launches += 1
    fill = fills is not None
    row_bytes = sum(_ESIZE[c.dtype] for c in cols)
    base = launch_bytes(n, 0, row_bytes, fill)
    compact.bytes += base
    # the kept rows' part, n_valid x bytes a kept row, stays on the card:
    # a new tensor each launch, so that a counter snapshot keeps its value
    per_kept = launch_bytes(n, 1, row_bytes, fill) - base
    prev = compact.kept_bytes.get(dev)
    compact.kept_bytes[dev] = (n_valid * per_kept if prev is None
                               else torch.add(prev, n_valid, alpha=per_kept))
    return n_valid, outs


def compact(valid: torch.Tensor, *cols: torch.Tensor, fills=None):
    """Stable compaction, with column k's rows past n_valid set to fills[k]
    when `fills` is given.  A CPU tensor takes the plain twin; a CUDA
    tensor launches K2 (or raises)."""
    if valid.device.type == "cpu":
        _check_fills(cols, fills)
        return compact_plain(valid, *cols, fills=fills)
    with torch.cuda.device(valid.device):  # the launch's card, where a process holds several
        return compact_cuda(valid, *cols, fills=fills)


compact.launches = 0
compact.bytes = 0
compact.kept_bytes = {}  # device -> 0-d int64 tensor
