"""Where the supergraph stage's, or the scaffold stage's, host time goes.

    python3 -m supernova_tpu_torch.stats.profile_supergraph GENOME_LEN [DEVICE] [TOP] [STAGE] [SEED]

Simulates a genome of pipeline/datasets.py GENOME's shape cut to
GENOME_LEN bases (barcodes in proportion, seed SEED, 5 by default), runs Pipeline.run_slice
and stage_patch on DEVICE ("cuda" by default; "cpu" runs the plain twins),
then STAGE ("supergraph" by default, or "scaffold": stage_supergraph
unprofiled, then stage_scaffold_phase) under cProfile, and prints the
stage's wall, its record (the closure glue's route, overflow and
positions; the scaffold phases' walls and the het DP's pairs, shape and
seconds) and its TOP (30) functions by cumulative time.  cProfile adds a
cost to every Python call, so read the shares, not the seconds.
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import tempfile
import time

from ..pipeline import datasets
from ..pipeline.run import Pipeline


def main(genome_len: str, device: str = "cuda", top: str = "30",
         stage: str = "supergraph", seed: str = "5") -> int:
    n = int(genome_len)
    cfg = dict(datasets.GENOME, genome_len=n,
               n_barcodes=max(datasets.GENOME["n_barcodes"] * n // datasets.GENOME["genome_len"],
                              20))
    rs = datasets.simulate(cfg, int(seed))
    with tempfile.TemporaryDirectory() as d:
        pl = Pipeline(d, device=device)
        _, bg, rp = pl.run_slice(rs)
        bg, rp = pl.stage_patch(bg, rp, rs)
        args = (bg, rp, rs)
        if stage == "scaffold":
            D, lines, _ = pl._timed("supergraph", pl.stage_supergraph, bg, rp, rs)
            args = (D, lines, rp, rs)
        fn = {"supergraph": pl.stage_supergraph, "scaffold": pl.stage_scaffold_phase}[stage]
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        pl._timed(stage, fn, *args)
        prof.disable()
        wall = time.perf_counter() - t0
    print(f"{rs.n_reads} reads of a {n}-base genome on {device}: stage_{stage} {wall:.3f} s "
          f"(profiled); record {pl.stage_records[stage]}")
    pstats.Stats(prof).sort_stats("cumulative").print_stats(int(top))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:6]))
