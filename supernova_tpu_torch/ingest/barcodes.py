"""Barcode whitelist validation & posterior-probability correction.

The port's own copy of supernova_tpu/ingest/barcodes.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Re-implements the behavior of the reference's BarcodeValidator
(lib/tada/external/rust-fastq-10x/src/barcode.rs:22-84) as vectorized array
ops over all reads at once instead of a per-read hash-map walk:

  * exact whitelist hit -> accept;
  * else enumerate all 48 one-edit variants (16 positions x 3 alternatives),
    score each whitelist-hit variant with likelihood
       max(0.0005, P_err(qv_at_pos)) * max(prior_count, 0.5)
    and accept the argmax iff best/total > bc_confidence_threshold (0.975,
    mro/_fastq_prep_stages.mro);
  * reject outright when sum of per-base error probabilities exceeds
    max_expected_barcode_errors.

A 16bp barcode packs exactly into one uint32 (2 bits/base), so the whitelist
is a sorted uint32 array and membership is a vectorized searchsorted — the
TPU-friendly replacement for the reference's HashMap.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BC_LEN = 16
BC_CONFIDENCE_THRESHOLD = 0.975  # mro/_fastq_prep_stages.mro
MAX_EXPECTED_BARCODE_ERRORS = 1.0


def pack_bc(bc_codes: np.ndarray) -> np.ndarray:
    """(N,16) base codes -> (N,) uint32 packed, base-big-endian."""
    bc_codes = np.asarray(bc_codes, dtype=np.uint32)
    out = np.zeros(bc_codes.shape[0], dtype=np.uint32)
    for i in range(BC_LEN):
        out = (out << np.uint32(2)) | bc_codes[:, i]
    return out


@dataclass
class Whitelist:
    packed: np.ndarray  # sorted uint32 (n_wl,)

    @staticmethod
    def from_codes(bc_codes: np.ndarray) -> "Whitelist":
        packed = np.sort(pack_bc(bc_codes))
        assert len(np.unique(packed)) == len(packed), "duplicate whitelist entries"
        return Whitelist(packed)

    def __len__(self) -> int:
        return len(self.packed)

    def lookup(self, packed_queries: np.ndarray) -> np.ndarray:
        """-> int32 whitelist index, -1 if absent."""
        idx = np.searchsorted(self.packed, packed_queries)
        idx_c = np.minimum(idx, len(self.packed) - 1)
        hit = self.packed[idx_c] == packed_queries
        return np.where(hit, idx_c, -1).astype(np.int32)


def qual_to_perr(q: np.ndarray) -> np.ndarray:
    """Phred score (NOT ascii) -> error probability."""
    return np.power(10.0, -np.asarray(q, dtype=np.float64) / 10.0)


def correct_barcodes(
    wl: Whitelist,
    bc_codes: np.ndarray,  # (N,16) uint8
    bc_quals: np.ndarray,  # (N,16) phred
    prior_counts: np.ndarray | None = None,  # (n_wl,) counts from exact pass
    confidence: float = BC_CONFIDENCE_THRESHOLD,
    max_expected_errors: float = MAX_EXPECTED_BARCODE_ERRORS,
) -> np.ndarray:
    """-> (N,) int32 whitelist index per read pair, -1 = uncorrectable.

    Two-pass like the reference pipeline: callers first run with
    prior_counts=None on a sample to get exact-hit counts, then correct with
    those as priors (barcode.rs bc_counts).
    """
    bc_codes = np.asarray(bc_codes, dtype=np.uint8)
    bc_quals = np.asarray(bc_quals)
    n = bc_codes.shape[0]
    packed = pack_bc(bc_codes)
    exact = wl.lookup(packed)

    if prior_counts is None:
        prior_counts = np.zeros(len(wl), dtype=np.int64)

    miss = exact < 0
    result = exact.copy()
    if miss.any():
        mi = np.nonzero(miss)[0]
        mp = packed[mi]  # (M,)
        mq = bc_quals[mi]  # (M,16)
        # all 48 one-edit variants, vectorized: variant[m, pos*3+a]
        shifts = np.uint32(2) * (BC_LEN - 1 - np.arange(BC_LEN, dtype=np.uint32))
        cur = (mp[:, None] >> shifts[None, :]) & np.uint32(3)  # (M,16) current code
        alts = np.arange(1, 4, dtype=np.uint32)  # +1..+3 mod 4 => the 3 others
        alt_code = (cur[:, :, None] + alts[None, None, :]) % np.uint32(4)  # (M,16,3)
        cleared = mp[:, None] & ~(np.uint32(3) << shifts)  # (M,16)
        variants = cleared[:, :, None] | (alt_code << shifts[:, None])  # (M,16,3)
        vflat = variants.reshape(len(mi), -1)  # (M,48)
        vidx = wl.lookup(vflat)  # (M,48) wl index or -1
        hit = vidx >= 0
        perr = np.maximum(0.0005, qual_to_perr(mq))  # (M,16)
        perr48 = np.repeat(perr, 3, axis=1)  # (M,48)
        prior = np.maximum(prior_counts[np.maximum(vidx, 0)], 0.5)  # (M,48)
        like = np.where(hit, perr48 * prior, 0.0)
        total = like.sum(axis=1)
        best = like.argmax(axis=1)
        best_like = like[np.arange(len(mi)), best]
        ok = (total > 0) & (best_like / np.maximum(total, 1e-300) > confidence)
        corrected = np.where(ok, vidx[np.arange(len(mi)), best], -1)
        result[mi] = corrected

    # reject low-confidence barcodes regardless of match
    expected_errors = qual_to_perr(bc_quals).sum(axis=1)
    result = np.where(expected_errors < max_expected_errors, result, -1)
    return result.astype(np.int32)
