"""Per-stage device profile of the slice on one GPU.

    python3 -m supernova_tpu_torch.stats.profile_slice OUT.txt [DATASET]

DATASET is a name in pipeline/datasets.py DATASETS (FULL, one count block,
by default; GENOME for the blocked count and pather), with the suffix
_MIXED for the readset cut by datasets.r1_trimmed (mixed read lengths: the
general pather).  Builds the kernels,
runs the 8 kb slice once on CUDA as a warm-up, times the host preparation
steps alone, then runs each stage of Pipeline(device="cuda") on the
dataset inside its own torch.profiler.profile(CPU, CUDA).  Per stage it writes the wall
time, the device busy time (the union of the device events' intervals),
idle share = 1 - busy / wall, peak device memory, the device time and
launches of each of the port's kernels K1-K5, the device time and calls
of the elementwise operators the count's tail passes ran (WATCHED_OPS),
the device time of each program step (the `call.` spans of
stats/trace.py) by kernel, and the profile's top operators by self
device time.  Everything printed is also
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
from .kernel_phases import short_name

# the device functions of each of the port's kernels (csrc/*.cu)
PORT_KERNELS = {
    "K1 kmer_extract": ("kmer_extract_kernel",),
    "K2 compact": ("compact_kernel",),
    "K3 run_reduce": ("tail_kernel", "run_reduce_kernel"),
    "K4 sort": ("hist_kernel", "onesweep_kernel"),
    "K5 scan_max": ("scan_max_kernel",),
}
# the operators of the tail passes that followed each K2 call on the count
# path until K2 wrote the tail itself (arange < n_valid, then torch.where)
WATCHED_OPS = ("aten::arange", "aten::lt", "aten::where")


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


def port_kernels(prof) -> str:
    """Device time and launches of each of the port's kernels."""
    sums = {k: [0.0, 0] for k in PORT_KERNELS}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = short_name(e.name)
        for k, fns in PORT_KERNELS.items():
            if name in fns:
                sums[k][0] += (e.time_range.end - e.time_range.start) / 1e3
                sums[k][1] += 1
    return ", ".join(f"{k} {ms:.3f} ms ({n} device launches)" for k, (ms, n) in sums.items())


def span_kernels(prof) -> dict:
    """{step: {kernel: device seconds}} over the program's steps: each
    `call.` span leaves an annotation on the device's timeline, and a
    kernel counts in the shortest annotation that holds its start."""
    ann, kern = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
            (ann if e.name.startswith("call.") else kern).append((s, t, e.name))
    out: dict = {}
    for s, t, name in kern:
        holding = [(a1 - a0, step) for a0, a1, step in ann if a0 <= s <= a1]
        step = min(holding)[1] if holding else "none"
        per = out.setdefault(step, {})
        per[short_name(name)] = per.get(short_name(name), 0.0) + (t - s)
    return out


def span_lines(prof, top: int = 3) -> list[str]:
    """One line a step: its device seconds and its top kernels."""
    return [f"{step}: {sum(per.values()):.3f} s; " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:top])
        for step, per in sorted(span_kernels(prof).items())]


def watched_ops(prof) -> str:
    """Self device time and calls of each operator in WATCHED_OPS."""
    avg = {e.key: e for e in prof.key_averages()}
    return ", ".join(
        f"{k} {avg[k].self_device_time_total / 1e3:.3f} ms ({avg[k].count} calls)" if k in avg
        else f"{k} none" for k in WATCHED_OPS)


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
    rs = datasets.simulate(*datasets.DATASETS[dataset.removesuffix("_MIXED")])
    if dataset.endswith("_MIXED"):
        rs = datasets.r1_trimmed(rs)
    with tempfile.TemporaryDirectory() as d:
        Pipeline(d, device=dev).run(datasets.simulate(datasets.SMALL, datasets.SMALL_SEED))

    block = kcount.split_readset_blocks(rs, kcount.count_block_positions(dev))[0]
    t = time.perf_counter()
    kcount.prepare_reads(block, dev)
    torch.cuda.synchronize()
    emit(f"host prepare_reads (+H2D and device expansion) of the first block "
         f"({int(block.offsets[-1])} bases): {time.perf_counter() - t:.3f} s")
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
            emit(f"port kernels: {port_kernels(prof)}")
            emit(f"tail-pass operators: {watched_ops(prof)}")
            for line in span_lines(prof):
                emit(f"step {line}")
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
        emit(str({k: pl.stats.get(k) for k in ("kmers_distinct", "n_edges", "edge_N50",
                                                "paths_rescued", "paths_extended",
                                                "placed_perc")}))
        emit(f"count: {pl.stage_records['count']}")
        emit(f"paths: {pl.stage_records['paths']}")
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
