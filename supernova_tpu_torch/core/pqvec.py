"""Packed qual codes — the feudal PQVec analogue (feudal/PQVec.h:33-71).

The port's own copy of supernova_tpu/core/pqvec.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

The reference compresses per-base quality vectors because at production
scale raw quals are the largest array in RAM (1.2B reads x 150 bases).
Illumina quals are effectively 4-valued (typically {2, 12, 23, 37}); this
packs them to 2 bits/base against a per-dataset codebook (the 4 most
frequent values; other values round to the nearest codebook entry).
Lossy only for off-codebook values, exactly like the reference's
position-coded binning in spirit — the pipeline consumes quals solely
through >= threshold tests (Q7 trim, Q30 mismatch counts), which the
codebook preserves when it straddles the thresholds.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_codebook(quals: np.ndarray) -> np.ndarray:
    """-> (4,) uint8 ascending codebook of the most frequent qual values."""
    if len(quals) == 0:
        return np.array([2, 12, 23, 37], np.uint8)
    counts = np.bincount(quals, minlength=64)
    top = np.argsort(counts)[::-1][:4]
    top = top[counts[top] > 0]
    book = np.sort(top).astype(np.uint8)
    if len(book) < 4:  # pad with defaults not already present
        pads = [q for q in (2, 12, 23, 37) if q not in book]
        book = np.sort(
            np.concatenate([book, np.asarray(pads[: 4 - len(book)], np.uint8)])
        )
    return book


def pack(quals: np.ndarray, book: np.ndarray) -> np.ndarray:
    """uint8 quals -> 2-bit codes packed 4-per-byte (len ceil(n/4))."""
    edges = (book[:-1].astype(np.int32) + book[1:].astype(np.int32) + 1) // 2
    codes = np.digitize(quals, edges).astype(np.uint8)
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    c = codes.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).astype(
        np.uint8
    )


def unpack(packed: np.ndarray, n: int, book: np.ndarray) -> np.ndarray:
    """packed bytes -> (n,) uint8 quals (codebook values)."""
    b = packed.astype(np.uint8)
    codes = np.empty((len(b), 4), np.uint8)
    codes[:, 0] = b & 3
    codes[:, 1] = (b >> 2) & 3
    codes[:, 2] = (b >> 4) & 3
    codes[:, 3] = (b >> 6) & 3
    return book[codes.reshape(-1)[:n]]


def roundtrip_exact_fraction(quals: np.ndarray, book: np.ndarray) -> float:
    """Fraction of quals exactly representable by the codebook."""
    if len(quals) == 0:
        return 1.0
    return float(np.isin(quals, book).mean())
