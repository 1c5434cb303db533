"""Ingestion pipeline: raw barcoded read pairs -> barcode-sorted ReadSet.

The port's own copy of supernova_tpu/ingest/ingest.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Replaces the reference's BUCKET_FASTQS / SORT_FASTQS / ParseBarcodedFastqs
chain (SURVEY.md §3.1): two-pass barcode correction (exact-hit counts as
priors, then posterior correction), then a single stable sort by corrected
barcode id in place of the disk-sharded bucket sort — on-device radix sort
at scale, numpy here at ingest granularity.

Barcode id convention: 0 = unbarcoded/invalid, whitelist index i -> id i+1
(the reference's BC==0 "no barcode" block, DF.cc:858, areEnoughBarcodes).
"""
from __future__ import annotations


import numpy as np

from ..sim.genome import SimReads
from .barcodes import Whitelist, correct_barcodes, pack_bc
from .reads import ReadSet, build_readset


def correct_two_pass(
    wl: Whitelist, bc_codes: np.ndarray, bc_quals: np.ndarray
) -> np.ndarray:
    """Two-pass correction -> per-pair whitelist ids (-1 invalid)."""
    exact = wl.lookup(pack_bc(bc_codes))
    prior = np.bincount(exact[exact >= 0], minlength=len(wl))
    return correct_barcodes(wl, bc_codes, bc_quals, prior_counts=prior)


def ingest_pairs(
    r1: list[np.ndarray],
    q1: list[np.ndarray],
    r2: list[np.ndarray],
    q2: list[np.ndarray],
    bc_codes: np.ndarray,
    bc_quals: np.ndarray,
    wl: Whitelist,
) -> ReadSet:
    n_pairs = len(r1)
    assert bc_codes.shape == (n_pairs, 16)
    wl_idx = correct_two_pass(wl, bc_codes, bc_quals)
    bc_ids = (wl_idx + 1).astype(np.int32)  # -1 -> 0 (invalid)

    reads: list[np.ndarray] = []
    quals: list[np.ndarray] = []
    for a, qa, b, qb in zip(r1, q1, r2, q2):
        reads.extend((a, b))
        quals.extend((qa, qb))
    return build_readset(reads, quals, bc_ids, n_barcodes=len(wl), barcoded=True)


def ingest_sim(sim: SimReads, wl) -> ReadSet:
    if isinstance(wl, np.ndarray):  # raw (n,16) whitelist codes
        wl = Whitelist.from_codes(wl)
    return ingest_pairs(
        sim.r1,
        sim.q1,
        sim.r2,
        sim.q2,
        np.stack(sim.barcode),
        np.stack(sim.bc_qual),
        wl,
    )


def valid_barcode_fraction(rs: ReadSet) -> float:
    """The valid_bc_perc stat (alarms-supernova.json:66-71: exit below 25%)."""
    if rs.n_reads == 0:
        return 0.0
    return float((rs.bc > 0).sum()) / rs.n_reads


def subsample_pairs(rs: ReadSet, fraction: float, seed: int = 0) -> ReadSet:
    """Deterministic read-pair downsampling (the reference's subsample /
    downsample knobs, mro/_assembler.mro sample_def + DF downsampling via
    FastFastbCount).  Keeps mates together and re-sorts by barcode."""
    if fraction >= 1.0:
        return rs
    rng = np.random.default_rng(seed)
    keep_pairs = np.nonzero(rng.random(rs.n_pairs) < fraction)[0]
    reads, quals, bcs = [], [], []
    for pair in keep_pairs:
        r1, r2 = 2 * pair, 2 * pair + 1
        reads.extend((rs.read(r1), rs.read(r2)))
        quals.extend((rs.qual(r1), rs.qual(r2)))
        bcs.append(rs.bc[r1])
    return build_readset(
        reads, quals, np.asarray(bcs, np.int32),
        n_barcodes=rs.n_barcodes, barcoded=rs.barcoded,
    )
