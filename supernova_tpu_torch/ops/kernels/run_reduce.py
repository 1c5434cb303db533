"""K3: fused per-run reduction over the sorted occurrence stream (kernel in
csrc/run_reduce.cu).

Replaces supernova_tpu/ops/pallas/run_reduce.py:run_reduce_pallas.  Over
the stream sorted by (w0, w1, w2, pk) it returns, per row:
  keep  (bool)  end & real & count >= min_freq & (ignored | nbc >= min_bc)
  count (int32) the run's valid-occurrence count
  stats (int32) min(nbc, 4095)<<9 | lm<<5 | rm<<1 | ignored
all zero off run-end rows.  A run ends where the next row's words differ;
past the last row the next words are the sentinel, so a trailing sentinel
run has no end.  keep uses the unclamped nbc.
"""
from __future__ import annotations

import torch

from . import _lib

SENTINEL = 0xFFFFFFFF
BC_FIELD_IGNORED = 0x3FFFFF


def run_stats_plain(w0, w1, w2, pk):
    """Per-run statistics without gathers: every stat is a cumsum (or a
    cummax of positions) read off relative to the run start.

    -> (ends, real, count, nbc, has_ign, lm, rm); count/nbc are the
    run-relative running values (totals at end rows), nbc unclamped."""
    n = w0.shape[0]
    dev = w0.device
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    neq = (w0[1:] != w0[:-1]) | (w1[1:] != w1[:-1]) | (w2[1:] != w2[:-1])
    starts[1:] = neq
    real = ~((w0 == SENTINEL) & (w1 == SENTINEL) & (w2 == SENTINEL))
    ends = torch.empty(n, dtype=torch.bool, device=dev)
    ends[:-1] = neq
    ends[-1:] = real[-1:]
    p = torch.arange(n, device=dev)
    run_start_pos = torch.cummax(torch.where(starts, p, 0), 0).values

    def run_total(ind):
        ind = ind.to(torch.int64)
        cs = torch.cumsum(ind, 0)
        base = torch.cummax(torch.where(starts, cs - ind, 0), 0).values
        return cs - base

    def run_any(ind):
        last = torch.cummax(torch.where(ind, p, -1), 0).values
        return last >= run_start_pos

    valid = ((pk >> 1) & 1) == 1
    bcf = pk >> 10
    prev_bcf = torch.cat([bcf[:1], bcf[:-1]])
    new_pair = starts | (bcf != prev_bcf)
    count = run_total(valid)
    nbc = run_total(valid & (bcf > 0) & (bcf != BC_FIELD_IGNORED) & new_pair)
    has_ign = run_any(valid & (bcf == BC_FIELD_IGNORED))
    lm = torch.zeros(n, dtype=torch.int64, device=dev)
    rm = torch.zeros(n, dtype=torch.int64, device=dev)
    for b in range(4):
        lm |= run_any(valid & (((pk >> (6 + b)) & 1) == 1)).to(torch.int64) << b
        rm |= run_any(valid & (((pk >> (2 + b)) & 1) == 1)).to(torch.int64) << b
    return ends, real, count, nbc, has_ign, lm, rm


def run_reduce_plain(w0, w1, w2, pk, min_freq: int, min_bc: int):
    """Plain PyTorch twin of K3."""
    ends, real, count, nbc, ign, lm, rm = run_stats_plain(w0, w1, w2, pk)
    keep = ends & real & (count >= min_freq) & (ign | (nbc >= min_bc))
    stats = (
        (nbc.clamp(max=4095) << 9) | (lm << 5) | (rm << 1) | ign.to(torch.int64)
    )
    return (
        keep,
        torch.where(ends, count, 0).to(torch.int32),
        torch.where(ends, stats, 0).to(torch.int32),
    )


def run_reduce_cuda(w0, w1, w2, pk, min_freq: int, min_bc: int):
    """Launch K3: four contiguous (n,) int64 columns on one card."""
    dev = w0.device
    n = w0.shape[0]
    for name, t in (("w0", w0), ("w1", w1), ("w2", w2), ("pk", pk)):
        _lib.require(t, name, torch.int64, dev, n)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    count = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return keep, count, stats
    lib = _lib.library()
    _lib.check(
        lib.sn_run_reduce(
            w0.data_ptr(), w1.data_ptr(), w2.data_ptr(), pk.data_ptr(), n,
            int(min_freq), int(min_bc),
            keep.data_ptr(), count.data_ptr(), stats.data_ptr(),
            _lib.stream_ptr(dev),
        ),
        "run_reduce",
    )
    run_reduce.launches += 1
    return keep, count, stats


def run_reduce(w0, w1, w2, pk, min_freq: int, min_bc: int):
    """(keep, count, stats) per row.  A CPU tensor takes the plain twin; a
    CUDA tensor launches K3 (or raises)."""
    if w0.device.type == "cpu":
        return run_reduce_plain(w0, w1, w2, pk, min_freq, min_bc)
    return run_reduce_cuda(w0, w1, w2, pk, min_freq, min_bc)


run_reduce.launches = 0
