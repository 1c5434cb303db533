"""Where the supergraph stage's host time goes.

    python3 -m supernova_tpu_torch.stats.profile_supergraph GENOME_LEN [DEVICE] [TOP]

Simulates a genome of pipeline/datasets.py GENOME's shape cut to
GENOME_LEN bases (barcodes in proportion, seed 5), runs Pipeline.run_slice
and stage_patch on DEVICE ("cuda" by default; "cpu" runs the plain twins),
then stage_supergraph under cProfile, and prints the stage's wall, its
record (the closure glue's route, overflow and positions) and its TOP (30)
functions by cumulative time.  cProfile adds a cost to every Python call,
so read the shares, not the seconds.
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import tempfile
import time

from ..pipeline import datasets
from ..pipeline.run import Pipeline


def main(genome_len: str, device: str = "cuda", top: str = "30") -> int:
    n = int(genome_len)
    cfg = dict(datasets.GENOME, genome_len=n,
               n_barcodes=max(datasets.GENOME["n_barcodes"] * n // datasets.GENOME["genome_len"],
                              20))
    rs = datasets.simulate(cfg, 5)
    with tempfile.TemporaryDirectory() as d:
        pl = Pipeline(d, device=device)
        _, bg, rp = pl.run_slice(rs)
        bg, rp = pl.stage_patch(bg, rp, rs)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        pl._timed("supergraph", pl.stage_supergraph, bg, rp, rs)
        prof.disable()
        wall = time.perf_counter() - t0
    print(f"{rs.n_reads} reads of a {n}-base genome on {device}: stage_supergraph {wall:.3f} s "
          f"(profiled); record {pl.stage_records['supergraph']}")
    pstats.Stats(prof).sort_stats("cumulative").print_stats(int(top))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
