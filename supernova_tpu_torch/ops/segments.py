"""Sorted-segment helpers and stable compaction (port of
supernova_tpu/ops/segments.py).

After a sort, groups are contiguous runs; reductions become cumsums and
cummaxes read off relative to the run start.
"""
from __future__ import annotations

import torch

from .kernels import compact as kcompact


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
    (cumsums): a cummax of the start-masked values is exact."""
    return torch.cummax(torch.where(starts, values, fill), 0).values


def run_end_mask(starts):
    """Row is the last of its run."""
    return torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])


def stable_compact(valid, *arrays):
    """Stable partition: rows with valid first, order kept; the tail past
    n_valid is zeroed.  Returns (n_valid 0-d int64 tensor, arrays)."""
    return kcompact.compact_plain(valid, *arrays)


def compact_sorted_words(valid, wa, wb, wc, *payloads):
    """Stable compaction of the rows where `valid` holds, for rows sorted by
    (wa, wb, wc); rows past n_valid are zeroed.

    A CUDA tensor goes through kernel K2 (csrc/compact.cu); a CPU tensor
    through the plain boolean-mask compaction.  The reference's sort-based
    fallback needs kept rows to have distinct words; a stable compaction
    gives the same rows in the same order without that condition."""
    n = valid.shape[0]
    n_valid, res = kcompact.compact(valid, wa, wb, wc, *payloads)
    live = torch.arange(n, device=valid.device) < n_valid
    return n_valid, tuple(torch.where(live, c, 0) for c in res)
