"""Bridges between the JAX package's outputs (as numpy arrays) and the
port's tensors, so each stage can be fed and checked in isolation.

numpy side: the reference's dtypes (uint32 words and masks, int32 counts,
edges and offsets).  Tensor side: the port's int64 words (see
core/kmer_codec.py).  BaseGraph round-trips through numpy by save/load.
"""
from __future__ import annotations

import numpy as np
import torch

from .align.pather import ReadPaths
from .core.kmer_codec import W3
from .kmer.count import KmerTable


def table_from_numpy(table, device) -> KmerTable:
    """Any KmerTable-shaped object whose fields np.asarray accepts (the
    reference's table, or table_to_numpy's output) -> the port's table."""
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)
    return KmerTable(
        W3(*(t(x, np.int64) for x in table.words)),
        t(table.count, np.int32),
        t(table.nbc, np.int32),
        t(table.left_mask, np.int32),
        t(table.right_mask, np.int32),
        torch.tensor(int(np.asarray(table.n_valid)), dtype=torch.int64, device=device),
    )


def table_to_numpy(table: KmerTable) -> KmerTable:
    """The port's table -> a KmerTable of numpy arrays in the reference's
    dtypes (n_valid an int)."""
    n = lambda x, dt: x.cpu().numpy().astype(dt)
    return KmerTable(
        W3(*(n(x, np.uint32) for x in table.words)),
        n(table.count, np.int32),
        n(table.nbc, np.int32),
        n(table.left_mask, np.uint32),
        n(table.right_mask, np.uint32),
        int(table.n_valid),
    )


def readpaths_to_numpy(rp: ReadPaths) -> ReadPaths:
    """The port's ReadPaths -> numpy arrays in the reference's dtypes."""
    i32 = lambda x: x.cpu().numpy().astype(np.int32)
    return ReadPaths(
        i32(rp.edges), i32(rp.path_len), i32(rp.offset), i32(rp.first_skip),
        rp.overflow.cpu().numpy().astype(bool),
    )
