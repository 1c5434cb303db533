"""2-bit base packing of the feudal / BINWRITE formats: the part of
supernova_tpu/ingest/feudal.py the port uses (ReadSet.save/load and the
count's packed block inputs), copied so that the port imports nothing of
the JAX package; tests/test_torch_hostcopies.py keeps the two equal.

Base code j of a byte sits at bit (j%4)*2, 00=A 01=C 10=G 11=T: the
framework's own codes (0=A 1=C 2=G 3=T, core/dna.py).
"""
from __future__ import annotations

import numpy as np


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes -> packed bytes, code j at bit (j%4)*2."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes.astype(np.uint8), np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    return (
        c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    ).astype(np.uint8)


def unpack_codes(packed: np.ndarray, n_bases: int) -> np.ndarray:
    """packed bytes -> uint8 base codes (vectorized; trailing pad cut)."""
    b = np.asarray(packed, np.uint8)
    out = np.empty((len(b), 4), np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return out.reshape(-1)[:n_bases]
