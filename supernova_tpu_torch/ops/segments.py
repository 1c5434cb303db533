"""Sorted-segment helpers and stable compaction (port of
supernova_tpu/ops/segments.py).

After a sort, groups are contiguous runs; reductions become cumsums and
cummaxes read off relative to the run start.
"""
from __future__ import annotations

import torch

from .kernels import compact as kcompact
from .kernels.scan_max import scan_max


def run_starts(*key_arrays):
    """Bool mask of the first row of each run of equal keys.  Each key is
    (N,) or (N, W) (compared row-wise).  Row 0 is a start."""
    n = key_arrays[0].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=key_arrays[0].device)
    for k in key_arrays:
        if k.dim() == 1:
            k = k[:, None]
        out[1:] |= (k[1:] != k[:-1]).any(dim=-1)
    out[:1] = True
    return out


def segment_ids_from_starts(starts):
    """starts bool (N,) -> contiguous segment ids (N,) int32 (0-based)."""
    return torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1


def seg_sum(values, seg_ids, num_segments: int):
    """Per-segment sum; empty segments hold 0 (jax.ops.segment_sum)."""
    out = torch.zeros((num_segments,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids.long(), values)


def seg_max(values, seg_ids, num_segments: int):
    """Per-segment maximum; empty segments hold the dtype's minimum (the
    identity, as jax.ops.segment_max gives)."""
    low = -torch.inf if values.dtype.is_floating_point else torch.iinfo(values.dtype).min
    out = torch.full((num_segments,), low, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg_ids.long(), values, "amax", include_self=True)


def seg_min(values, seg_ids, num_segments: int):
    """Per-segment minimum; empty segments hold the dtype's maximum (the
    identity, as jax.ops.segment_min gives)."""
    out = torch.full(
        (num_segments,), torch.iinfo(values.dtype).max, dtype=values.dtype,
        device=values.device,
    )
    return out.scatter_reduce_(0, seg_ids, values, "amin", include_self=True)


def run_broadcast_from_start(values, starts, fill=0):
    """Per-row value of the row's run start, for NON-DECREASING `values`
    (cumsums): a running max of the start-masked values is exact (K5 on
    the card)."""
    return scan_max(values, starts, fill)


def run_end_mask(starts):
    """Row is the last of its run."""
    return torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])


def stable_compact(valid, *arrays):
    """Stable partition: rows with valid first, order kept; the tail past
    n_valid is zeroed.  Returns (n_valid 0-d int64 tensor, arrays).  A CUDA
    tensor goes through kernel K2 (csrc/compact.cu), which writes the zero
    tail itself; a CPU tensor through its plain twin."""
    return kcompact.compact(valid, *arrays, fills=(0,) * len(arrays))


def compact_sorted_words(valid, wa, wb, wc, *payloads, word_fill=0):
    """Stable compaction of the rows where `valid` holds, for rows sorted by
    (wa, wb, wc); rows past n_valid hold `word_fill` in the three words and
    0 in the payloads.

    A CUDA tensor goes through kernel K2 (csrc/compact.cu), which writes the
    tail itself; a CPU tensor through the plain boolean-mask compaction.
    The reference's sort-based fallback needs kept rows to have distinct
    words; a stable compaction gives the same rows in the same order
    without that condition."""
    fills = (word_fill,) * 3 + (0,) * len(payloads)
    return kcompact.compact(valid, wa, wb, wc, *payloads, fills=fills)
