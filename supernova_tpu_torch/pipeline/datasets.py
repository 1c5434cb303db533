"""The simulated readsets the port is run on, from one count block up to a
genome that spans several.

GENOME is the blocked slice: a 10 Mb diploid genome (het 0.001), 3,000
barcodes x 10 molecules x 50 kb at coverage 0.3 per molecule, giving
~3.0M reads of 150 bp, ~450M bases, ~45x (the reference's ideal is
38-56x): five count blocks of at most BLOCK_POSITIONS bases, the block
count of the repo's own 10 Mb validation (scripts/val10mb.sh).  FULL is one
count block of the same shape: a 2 Mb genome, 600 barcodes, ~600k reads,
~90M bases, just under BLOCK_POSITIONS.  SMALL is the 8 kb genome of the
repo's verify notes.  All go through the port's copies of the simulator
and ingest.
"""
from __future__ import annotations

import numpy as np

from ..ingest.ingest import ingest_sim
from ..sim import genome as sim

GENOME_SEED = 20261017
FULL_SEED = 20261016
SMALL_SEED = 7
GENOME = dict(genome_len=10_000_000, het=0.001, whitelist=16_384, n_barcodes=3_000,
              molecules_per_barcode=10, molecule_len=50_000,
              coverage_per_molecule=0.3, error_rate=0.002, bc_error_rate=0.02)
FULL = dict(GENOME, genome_len=2_000_000, n_barcodes=600)
SMALL = dict(genome_len=8_000, het=0.002, whitelist=256, n_barcodes=80,
             molecules_per_barcode=2, molecule_len=4_000,
             coverage_per_molecule=2.0, error_rate=0.002, bc_error_rate=0.02)
DATASETS = {"GENOME": (GENOME, GENOME_SEED), "FULL": (FULL, FULL_SEED),
            "SMALL": (SMALL, SMALL_SEED)}


def simulate(cfg: dict, seed: int):
    """Linked reads of a random diploid genome shaped by `cfg` -> ReadSet."""
    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, cfg["genome_len"])
    _, hb = sim.diploidize(rng, g, cfg["het"])
    wl = sim.make_whitelist(rng, cfg["whitelist"])
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=cfg["n_barcodes"],
        molecules_per_barcode=cfg["molecules_per_barcode"],
        molecule_len=cfg["molecule_len"],
        coverage_per_molecule=cfg["coverage_per_molecule"],
        error_rate=cfg["error_rate"], bc_error_rate=cfg["bc_error_rate"],
    )
    return ingest_sim(reads, wl)
