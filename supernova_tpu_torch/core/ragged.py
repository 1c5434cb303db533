"""Ragged (CSR) array substrate.

The port's own copy of supernova_tpu/core/ragged.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The single ragged convention for the whole framework (SURVEY.md §7 "Ragged
everything"): values + offsets, where offsets has length n_rows+1 and row i is
values[offsets[i]:offsets[i+1]].  This is the TPU-native analogue of the
reference's feudal MasterVec vec-of-vecs (lib/assembly/src/feudal/) and of the
bci barcode index (10X/ParseBarcodedFastqs.cc:174-234: bci[b] = first read of
barcode b).

Device code always works on fixed-size padded arrays + scalar valid counts;
`pad_to` produces those.  Host containers stay exact-size numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Ragged:
    """Host-side CSR ragged array of int-like values."""

    values: np.ndarray  # flat values
    offsets: np.ndarray  # int64/int32, len n_rows+1, offsets[0] == 0

    def __post_init__(self):
        self.offsets = np.asarray(self.offsets)
        assert self.offsets.ndim == 1 and self.offsets[0] == 0
        assert self.offsets[-1] == len(self.values)

    @property
    def n_rows(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i] : self.offsets[i + 1]]

    def __len__(self) -> int:
        return self.n_rows

    def __iter__(self):
        for i in range(self.n_rows):
            yield self.row(i)

    @staticmethod
    def from_rows(rows: Sequence[np.ndarray], dtype=None) -> "Ragged":
        lens = np.array([len(r) for r in rows], dtype=np.int64)
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        if rows:
            values = np.concatenate([np.asarray(r) for r in rows])
            if dtype is not None:
                values = values.astype(dtype)
        else:
            values = np.zeros(0, dtype=dtype or np.int32)
        return Ragged(values, offsets)

    def to_rows(self) -> List[np.ndarray]:
        return [self.row(i) for i in range(self.n_rows)]


def pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad 1-D/2-D array along axis 0 to length n with `fill`."""
    arr = np.asarray(arr)
    if arr.shape[0] > n:
        raise ValueError(f"array of length {arr.shape[0]} exceeds pad target {n}")
    pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lengths_to_offsets(lengths: np.ndarray) -> np.ndarray:
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lengths), out=offsets[1:])
    return offsets
