"""K5: device-wide inclusive max-scan (kernel in csrc/scan_max.cu).

Replaces no Pallas kernel: the JAX package takes these running maxima with
jax.lax.cummax, which XLA lowers itself.  It was added because
torch.cummax on a 1-D CUDA tensor runs in one block (~3 ns an element) and
writes an index array nobody reads.

`scan_max(values, mask=None, fill=0)` is the running maximum along dim 0
of torch.where(mask, values, fill): `values` None means each element's own
index (int64), `mask` None that every element takes part.  Values are
int32 or int64, of any length; the result is a fresh contiguous tensor of
the values' dtype.
"""
from __future__ import annotations

import torch

from . import _lib

_ESIZE = {torch.int32: 4, torch.int64: 8}


def launch_bytes(n: int, esize: int, values: bool, mask: bool) -> int:
    """Bytes one launch moves: read the values (none without them) and the
    bool mask (none without it), write the n results."""
    return n * ((esize if values else 0) + (1 if mask else 0) + esize)


def _check(values, mask, fill) -> tuple[int, torch.dtype, torch.device]:
    """(length, result dtype, device), or raise on what the kernel does not
    take: a 2-D or non-contiguous tensor, another dtype, a mask of another
    length or device, a fill outside the dtype."""
    if values is None and mask is None:
        raise ValueError("scan_max needs values or a mask")
    ref = values if values is not None else mask
    dev = ref.device
    dtype = torch.int64 if values is None else values.dtype
    if dtype not in _ESIZE:
        raise TypeError(f"values: dtype {dtype} not int32/int64")
    if values is not None:
        _lib.require(values, "values", dtype, dev)
    if mask is not None:
        _lib.require(mask, "mask", torch.bool, dev, None if values is None else values.shape[0])
    info = torch.iinfo(dtype)
    if not info.min <= int(fill) <= info.max:
        raise ValueError(f"fill {fill} does not fit {dtype}")
    return ref.shape[0], dtype, dev


def scan_max_plain(values, mask=None, fill=0):
    """Plain PyTorch twin: torch.cummax of torch.where(mask, values, fill)."""
    if values is None:
        values = torch.arange(mask.shape[0], device=mask.device)
    x = values if mask is None else torch.where(mask, values, fill)
    return torch.cummax(x, 0).values


def scan_max_cuda(values, mask=None, fill=0):
    """Launch K5 on contiguous 1-D tensors on one card."""
    n, dtype, dev = _check(values, mask, fill)
    out = torch.empty(n, dtype=dtype, device=dev)
    if n == 0:
        return out
    lib = _lib.library()
    # a flag and a value word per tile, then the tile counter
    scratch = torch.zeros(2 * -(-n // lib.sn_scan_max_tile_elems()) + 1, dtype=torch.int64,
                          device=dev)
    esize = _ESIZE[dtype]
    _lib.check(
        lib.sn_scan_max(
            None if values is None else values.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), n, esize, int(fill), scratch.data_ptr(), scratch.shape[0],
            _lib.stream_ptr(dev),
        ),
        "scan_max",
    )
    scan_max.launches += 1
    scan_max.bytes += launch_bytes(n, esize, values is not None, mask is not None)
    return out


def scan_max(values, mask=None, fill=0):
    """Running maximum of torch.where(mask, values, fill) along dim 0.  A
    CPU tensor takes the plain twin; a CUDA tensor launches K5 (or
    raises)."""
    ref = values if values is not None else mask
    if ref is None or ref.device.type == "cpu":
        _check(values, mask, fill)
        return scan_max_plain(values, mask, fill)
    with torch.cuda.device(ref.device):  # the launch's card, where a process holds several
        return scan_max_cuda(values, mask, fill)


scan_max.launches = 0
scan_max.bytes = 0
