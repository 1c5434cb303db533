"""Per-stage device profile of the slice on one GPU.

    python3 -m supernova_tpu_torch.stats.profile_slice OUT.txt [DATASET]

DATASET is a name in pipeline/datasets.py DATASETS (FULL, one count block,
by default; GENOME for the blocked count and pather).  Builds the kernels,
runs the 8 kb slice once on CUDA as a warm-up, times the host preparation
steps alone, then runs each stage of Pipeline(device="cuda") on the
dataset inside its own torch.profiler.profile(CPU, CUDA).  Per stage it writes the wall
time, the device busy time (the union of the device events' intervals),
idle share = 1 - busy / wall, peak device memory, and the
profile's top operators by self device time.  Everything printed is also
written to OUT.txt.
"""
from __future__ import annotations

import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kmer import count as kcount
from ..ops.kernels import _lib
from ..pipeline import datasets
from ..pipeline.run import Pipeline


def device_busy_s(prof) -> float:
    """Seconds in which the device ran anything: the union of the device
    events' intervals (kernels, copies, memsets), so overlapping work and
    the operators that launched it are counted once."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def main(out_path: str, dataset: str = "FULL") -> int:
    if not torch.cuda.is_available():
        print("profile_slice: torch.cuda.is_available() is False")
        return 2
    out = open(out_path, "w")

    def emit(s):
        print(s)
        out.write(s + "\n")
        out.flush()

    dev = torch.device("cuda", 0)
    emit(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, dataset {dataset}")
    _lib.library()
    rs = datasets.simulate(*datasets.DATASETS[dataset])
    with tempfile.TemporaryDirectory() as d:
        Pipeline(d, device=dev).run(datasets.simulate(datasets.SMALL, datasets.SMALL_SEED))

    if int(rs.offsets[-1]) <= kcount.BLOCK_POSITIONS:  # the blocked count packs every block
        t = time.perf_counter()
        kcount.prepare_reads(rs, dev)
        torch.cuda.synchronize()
        emit(f"host prepare_reads (+H2D): {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    kcount.prepare_reads_packed(rs)
    emit(f"host prepare_reads_packed: {time.perf_counter() - t:.3f} s")

    with tempfile.TemporaryDirectory() as d:
        pl = Pipeline(d, device=dev)

        def run_stage(name, fn, *a):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                res = pl._timed(name, fn, *a)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            busy = device_busy_s(prof)
            emit(f"=== stage {name}: wall {wall:.3f} s, device busy {busy:.3f} s, "
                 f"idle share {1 - busy / wall:.3f}, "
                 f"peak {pl.stage_records[name]['peak_gb']:.3f} GiB")
            emit(prof.key_averages().table(sort_by="self_device_time_total", row_limit=14,
                          max_name_column_width=60))
            return res

        rs2 = run_stage("ingest", pl.stage_ingest, rs)
        table = run_stage("count", pl.stage_count, rs2)
        bg = run_stage("graph", pl.stage_graph, table)
        t = time.perf_counter()
        bg.checksum()
        emit(f"host BaseGraph.checksum: {time.perf_counter() - t:.3f} s")
        run_stage("paths", pl.stage_paths, bg, rs2)
        emit(str({k: pl.stats.get(k)
                  for k in ("kmers_distinct", "n_edges", "edge_N50", "placed_perc")}))
        emit(f"count: {pl.stage_records['count']}")
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
