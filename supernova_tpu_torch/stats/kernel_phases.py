"""Device time of each launch inside one call of a kernel wrapper, on one GPU.

    python3 -m supernova_tpu_torch.stats.kernel_phases [OUT.txt]

Builds the kernels, simulates the one-block dataset (pipeline/datasets.py
FULL), makes the occurrence sort's input and the sorted occurrence stream
as the count does, and prints, for K4 (`lex_argsort_cuda`, 4 keys), K3
(`run_reduce_cuda`) and K2 (`compact_cuda` of the kept run ends' five
columns, without and with the count's tail fill), every device launch of
one call in launch order with its median device time over a few calls,
then the sums by kernel name.
Times are the profiler's device intervals (CUPTI), so each launch is timed
alone, without the host's launch gaps.  It uses only wrapper entry points,
so it times whatever design the checkout holds (a case whose call the
checkout's wrapper does not take is reported and skipped).
"""
from __future__ import annotations

import re
import statistics
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..core import kmer_codec as kc
from ..kmer import count as kcount
from ..ops.kernels import _lib
from ..ops.kernels import compact as k2
from ..ops.kernels import run_reduce as k3
from ..ops.kernels import sort as k4
from ..pipeline import datasets


def short_name(name: str) -> str:
    """A device event's name without `void`, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.sub(r"\(.*", "", name).strip()


def launch_times(fn, reps: int = 5) -> list[tuple[str, float]]:
    """[(name, median ms)] of the device launches of one call of fn(), in
    launch order, from one profile of `reps` calls.  A marker kernel
    (torch.cuda._sleep's spin kernel) before each call splits the trace; a
    call whose event count differs from the most common one (an event the
    profiler dropped) is left out of the medians.  [] when no call was
    captured whole."""
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    calls, cur = [], None
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if "spin_kernel" in e.name:
            if cur:
                calls.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    if not calls:
        return []
    per = statistics.mode(len(c) for c in calls)
    calls = [c for c in calls if len(c) == per]
    return [
        (short_name(calls[0][i].name),
         statistics.median((c[i].time_range.end - c[i].time_range.start) / 1e3 for c in calls))
        for i in range(per)
    ]


def by_name(times):
    """{name: (launches, total ms)} from launch_times' list."""
    out: dict[str, list] = {}
    for name, ms in times:
        rec = out.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += ms
    return {k: tuple(v) for k, v in out.items()}


def occurrence_stream(rs, dev):
    """The count's occurrence sort input for one block: (canonical words W3
    with invalid rows on the sentinel, packed attributes pk), after the
    uniform tail cut — count_kmers' input to the sort."""
    inp = kcount.prepare_reads(rs, dev)
    canon, bc, lm, rm, valid = kcount.extract_occurrences(
        inp["codes_ext"], inp["pos_read"], inp["glen_pos"], inp["bc_pos"]
    )
    pk = kcount.pack_occurrence_attrs(bc, lm, rm, valid)
    a, b, c, pk = kcount.uniform_tail_cut(inp["uniform_rl"], canon.a, canon.b, canon.c, pk)
    return kc.W3(a, b, c).where(((pk >> 1) & 1) == 1, kc.SENTINEL), pk


def main(out_path: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: torch.cuda.is_available() is False")
        return 2
    out = open(out_path, "w") if out_path else None

    def emit(s):
        print(s)
        if out:
            out.write(s + "\n")

    dev = torch.device("cuda", 0)
    emit(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    _lib.library()
    canon, pk = occurrence_stream(datasets.simulate(datasets.FULL, datasets.FULL_SEED), dev)
    keys = (*canon, pk)
    rows = pk.shape[0]
    cases = [("K4 lex_argsort_cuda", f"{rows} rows x 4 keys", lambda: k4.lex_argsort_cuda(*keys))]
    perm = k4.lex_argsort_cuda(*keys)
    ws, spk = canon.gather(perm), pk[perm]
    mf, mb = kcount.MIN_FREQ, kcount.MIN_BC
    cases.append(("K3 run_reduce_cuda", f"{rows} rows",
                  lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, spk, mf, mb)))
    keep, count, stats = k3.run_reduce_cuda(ws.a, ws.b, ws.c, spk, mf, mb)
    fills = (kc.SENTINEL,) * 3 + (0, 0)
    shape = f"{rows} rows x 5 columns, {int(keep.sum())} kept"
    cases.append(("K2 compact_cuda", shape,
                  lambda: k2.compact_cuda(keep, ws.a, ws.b, ws.c, count, stats)))
    cases.append(("K2 compact_cuda with fill", shape,
                  lambda: k2.compact_cuda(keep, ws.a, ws.b, ws.c, count, stats, fills=fills)))
    for label, shape, fn in cases:
        try:
            times = launch_times(fn)
        except TypeError as e:
            emit(f"=== {label} at {shape}: not taken by this checkout ({e})")
            continue
        emit(f"=== {label} at {shape}: {len(times)} launches, "
             f"{sum(ms for _, ms in times):.3f} ms of device time")
        for i, (name, ms) in enumerate(times):
            emit(f"  {i:3d} {name}: {ms:.3f} ms")
        for name, (nl, ms) in by_name(times).items():
            emit(f"  sum {name}: {nl} launches, {ms:.3f} ms")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
