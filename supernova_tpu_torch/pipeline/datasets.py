"""The simulated readsets the port is run on, from one count block up to a
genome that spans several.

GENOME is the blocked slice: a 10 Mb diploid genome (het 0.001), 3,000
barcodes x 10 molecules x 50 kb at coverage 0.3 per molecule, giving
~3.0M reads of 150 bp, ~450M bases, ~45x (the reference's ideal is
38-56x): five count blocks at the reference's BLOCK_POSITIONS, the block
count of the repo's own 10 Mb validation (scripts/val10mb.sh); one at an
H100 80GB's own budget (kmer/count.py count_block_positions).  FULL is one
count block of the same shape: a 2 Mb genome, 600 barcodes, ~600k reads,
~90M bases, just under BLOCK_POSITIONS.  SMALL is the 8 kb genome of the
repo's verify notes.  All go through the port's copies of the simulator
and ingest.

A real 10x readset has R1 shorter than R2: R1 starts with the 16-base
barcode and 7 trimmed bases, which ingest drops.  `r1_trimmed` cuts any of
these readsets that way (R1 127 bases, R2 150): GENOME so cut has 3,000,000
reads and 415,500,000 bases, five count blocks of mixed-length reads.

Two small readsets take run_full's two scaffold routes, as the repo's
end-to-end tests make them: `e2e_reads` (a 5 kb diploid genome, 40
barcodes; tests/test_pipeline_e2e.py's raw-assembly test) and
`star_gap_reads` (a 30 kb haploid genome of 8 kb molecules with a
sequencing void that only barcodes bridge; tests/test_star_gap_pipeline.py),
which takes the star-gap phases.  SMALL_RUNS names them with the Pipeline
options their tests use.
"""
from __future__ import annotations

import numpy as np

from ..ingest.ingest import ingest_sim
from ..ingest.reads import ReadSet
from ..sim import genome as sim

GENOME_SEED = 20261017
FULL_SEED = 20261016
SMALL_SEED = 7
# bases ingest drops from the 5' end of every 10x R1: the barcode (16) and
# trim_length (7) (supernova_tpu/ingest/tenx.py:4, skip at :193)
R1_SKIP = 23
GENOME = dict(genome_len=10_000_000, het=0.001, whitelist=16_384, n_barcodes=3_000,
              molecules_per_barcode=10, molecule_len=50_000,
              coverage_per_molecule=0.3, error_rate=0.002, bc_error_rate=0.02)
FULL = dict(GENOME, genome_len=2_000_000, n_barcodes=600)
SMALL = dict(genome_len=8_000, het=0.002, whitelist=256, n_barcodes=80,
             molecules_per_barcode=2, molecule_len=4_000,
             coverage_per_molecule=2.0, error_rate=0.002, bc_error_rate=0.02)
DATASETS = {"GENOME": (GENOME, GENOME_SEED), "FULL": (FULL, FULL_SEED),
            "SMALL": (SMALL, SMALL_SEED)}


def simulate_reads(cfg: dict, seed: int):
    """Linked reads of a random diploid genome shaped by `cfg`, as the
    sequencer gives them -> (SimReads, whitelist codes)."""
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
    return reads, wl


def simulate_haplotypes(cfg: dict, seed: int):
    """The two haplotypes simulate_reads(cfg, seed) samples -> (g, hb)
    base codes."""
    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, cfg["genome_len"])
    _, hb = sim.diploidize(rng, g, cfg["het"])
    return g, hb


def simulate(cfg: dict, seed: int):
    """Linked reads of a random diploid genome shaped by `cfg` -> ReadSet
    (ingested in memory)."""
    return ingest_sim(*simulate_reads(cfg, seed))


def r1_trimmed(rs: ReadSet, skip: int = R1_SKIP) -> ReadSet:
    """rs with the first `skip` bases (codes and quals) of every R1 (the
    even reads of each pair) dropped; the same barcodes and bci."""
    lens = rs.lengths()
    cut = np.zeros(rs.n_reads, np.int64)
    cut[0::2] = np.minimum(skip, lens[0::2])
    keep = np.ones(len(rs.codes), bool)
    first = np.repeat(rs.offsets[:-1], cut)
    keep[first + np.arange(len(first)) - np.repeat(np.cumsum(cut) - cut, cut)] = False
    return ReadSet(
        codes=rs.codes[keep], offsets=np.concatenate([[0], np.cumsum(lens - cut)]),
        quals=rs.quals[keep], bc=rs.bc, bci=rs.bci, barcoded=rs.barcoded,
    )


def e2e_reads(rng):
    """The 5 kb diploid genome of the repo's raw-assembly e2e test, 40
    barcodes -> (SimReads, whitelist codes)."""
    g = sim.random_genome(rng, 5000, n_repeat_chunks=1, repeat_len=200)
    _, hb = sim.diploidize(rng, g, het_rate=0.0005)
    wl = sim.make_whitelist(rng, 128)
    return sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=40, molecules_per_barcode=3, molecule_len=2500,
        coverage_per_molecule=2.0, error_rate=0.002, bc_error_rate=0.01,
    ), wl


def mask_window(reads, w0: int, w1: int, insert: int = 360):
    """The read pairs whose fragment misses [w0, w1): a sequencing void that
    only barcode evidence can bridge."""
    keep = [i for i, p in enumerate(reads.truth_pos) if p + insert <= w0 or p >= w1]
    out = sim.SimReads()
    for f in ("r1", "q1", "r2", "q2", "barcode", "bc_qual", "truth_pos", "truth_hap"):
        getattr(out, f).extend(getattr(reads, f)[i] for i in keep)
    return out


def star_gap_reads(rng):
    """The star-gap fixture: 8 kb molecules on a 30 kb haploid genome, with
    reads of [14,500, 15,000) dropped -> (SimReads, whitelist codes)."""
    g = sim.random_genome(rng, 30_000)
    wl = sim.make_whitelist(rng, 256)
    reads = sim.simulate_linked_reads(
        rng, (g, g), wl, n_barcodes=80, molecules_per_barcode=2, molecule_len=8_000,
        coverage_per_molecule=1.0, error_rate=0.0,
    )
    return mask_window(reads, 14_500, 15_000), wl


# name -> (recipe, Pipeline options); each recipe is called with
# np.random.default_rng(0), as the tests' rng fixture
SMALL_RUNS = {"e2e": (e2e_reads, {}),
              "star-gap": (star_gap_reads, {"auto_downsample": False})}
