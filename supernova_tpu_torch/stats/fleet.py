"""The Pipeline's stages through the supergraph over a fleet of processes
joined over NCCL, beside the same stages on one card, one JSON line a
stage and process.

    python -m supernova_tpu_torch.stats.fleet --out DIR [--dataset FULL|GENOME]
        [--locals 1,2]

Steps:
  1. simulate the dataset (pipeline/datasets.py) once and save its reads
     (DIR/reads.npz, qualities unpacked);
  2. one card: a process runs Pipeline(multi_device=False) through ingest,
     count, graph, paths, patch and supergraph in DIR/single;
  3. for each entry of --locals, a fleet of 2 processes x that many cards
     (parallel/dist.py's spawn_fleet): each process's Pipeline takes the
     fleet's topology by itself, so the count crosses the processes
     (hierarchical exchange), the build runs over the fleet's shard tables,
     and the pather (paths and the patch's re-path) and the closure glue
     over its flat mesh, as the reference's mesh spans the fleet.  A fleet
     that needs more cards than the host has is reported as not run;
  4. every process's checkpoints (FILES) held to the one card's, byte for
     byte in each array.
A stage's line: its wall (host clock, every card of the process
synchronised), each card's peak allocated bytes (reset at the stage's
start), the rows and bytes the process sent to other processes
(mesh.TRAFFIC) and the exchanges that crossed, the kernel launches, and
the count's and the glue's routes.  The first line names the cards and
their power limit (nvidia-smi); the last says whether every output was
equal, and the exit code is nonzero when one was not or a process failed.
Imports no jax and nothing of supernova_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

STAGES = ("ingest", "count", "graph", "paths", "patch", "supergraph")
# the stages' checkpoints; graph.patched.npz only where the patch closed a gap
FILES = ("kmers.npz", "graph.npz", "paths.npz", "ebcx.npz", "graph.patched.npz",
         "cpaths.npz", "supergraph.npz", "dpaths.npz")
N_PROC = 2
TIMEOUT_S = 900  # a fleet's processes, or the one card's, are ended past this


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _cards(device) -> list:
    """This process's cards: its shards' devices (the current card alone
    outside a fleet)."""
    import torch

    from ..parallel.dist import local_shards
    from ..parallel.mesh import _shard_devices

    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        return [torch.device("cuda", torch.cuda.current_device())]
    n = local_shards(device)
    return sorted(set(_shard_devices(n, device, first=torch.distributed.get_rank() * n)),
                  key=str)


def run_stages(out: Path, reads: Path, role: str, multi_device) -> None:
    """One process's Pipeline through STAGES, a line a stage."""
    import torch

    from ..core.device import resolve_device
    from ..ingest.reads import ReadSet
    from ..ops import kernels
    from ..parallel import mesh as pmesh
    from ..pipeline.run import Pipeline

    dev = resolve_device("cuda")
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    cards = _cards(dev)
    pl = Pipeline(out, device=dev, multi_device=multi_device)
    state = {"rs": ReadSet.load(reads)}

    def count():
        state["table"], state["rs"] = pl._count_with_cov_guard(state["rs"])

    def patch():
        state["bg"], state["rp"] = pl.stage_patch(state["bg"], state["rp"], state["rs"])

    steps = {"ingest": lambda: state.update(rs=pl.stage_ingest(state["rs"])),
             "count": count,
             "graph": lambda: state.update(bg=pl.stage_graph(state.pop("table"))),
             "paths": lambda: state.update(rp=pl.stage_paths(state["bg"], state["rs"])),
             "patch": patch,
             "supergraph": lambda: pl.stage_supergraph(state["bg"], state["rp"], state["rs"])}
    for name in STAGES:
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        traffic = dict(pmesh.TRAFFIC)
        launches = kernels.launch_counts()
        t0 = time.perf_counter()
        pl._stage(name, steps[name])
        for c in cards:
            torch.cuda.synchronize(c)
        wall = time.perf_counter() - t0
        emit(dict(role=role, rank=rank, stage=name, wall_s=round(wall, 3),
                  card_peak_gib={str(c): round(torch.cuda.max_memory_allocated(c) / 2**30, 3)
                                 for c in cards},
                  **{k: pmesh.TRAFFIC[k] - traffic[k] for k in pmesh.TRAFFIC},
                  launches=kernels.launches_since(launches),
                  n_shards=pl.stats.get("n_shards"), n_shards_path=pl.stats.get("n_shards_path"),
                  count_route=pl.stage_records.get("count", {}).get("count_route"),
                  glue_route=pl.stage_records.get("supergraph", {}).get("glue_route")))
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def _child(role: str, out: Path) -> list:
    return [sys.executable, "-m", "supernova_tpu_torch.stats.fleet", "--out", str(out),
            "--role", role]


def _finish(procs, outs) -> bool:
    """Print the processes' lines (stderr's tail where one failed) -> True
    when all exited 0 (a process killed at TIMEOUT_S did not)."""
    ok = True
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        sys.stdout.write(out)
        if p.returncode != 0:
            ok = False
            sys.stdout.write(json.dumps({"failed": p.args[-1], "rank": rank, "rc": p.returncode,
                                         "stderr_tail": err[-3000:]}) + "\n")
    sys.stdout.flush()
    return ok


def same_npz(a: Path, b: Path) -> bool:
    import numpy as np

    if not b.exists():
        return False
    za, zb = np.load(a), np.load(b)
    return sorted(za.files) == sorted(zb.files) and all(
        za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]) for k in za.files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m supernova_tpu_torch.stats.fleet")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="FULL", choices=("FULL", "GENOME"),
                    help="pipeline/datasets.py's")
    ap.add_argument("--locals", default="1,2", help="cards a process, one fleet each")
    ap.add_argument("--role", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out)
    reads = out / "reads.npz"
    if args.role is not None:  # one process of step 2 or 3
        if args.role == "single":
            run_stages(out / "single", reads, "single", False)
        else:  # a fleet's process: its role gets its rank
            from ..parallel.dist import init_from_env

            init_from_env("cuda")
            role = f"{args.role}_rank{os.environ['SUPERNOVA_PROCESS_ID']}"
            run_stages(out / role, reads, role, None)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ERROR: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from ..parallel.dist import spawn_fleet, wait_fleet

    out.mkdir(parents=True, exist_ok=True)
    cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    emit(dict(step="cards", count=cards, nvidia_smi=smi.stdout.strip().splitlines()))
    from ..pipeline import datasets

    t0 = time.perf_counter()
    rs = datasets.simulate(*datasets.DATASETS[args.dataset])
    rs.save(reads, pack_quals=False)
    emit(dict(step="simulate", dataset=args.dataset, reads=rs.n_reads,
              bases=int(rs.offsets[-1]), wall_s=round(time.perf_counter() - t0, 3)))
    del rs
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = [subprocess.Popen(_child("single", out), text=True, **pipes)]
    ok = _finish(procs, wait_fleet(procs, TIMEOUT_S))
    expect = [f for f in FILES if (out / "single" / f).exists()]
    equal = {}
    for local in (int(x) for x in args.locals.split(",")):
        tag = f"fleet{N_PROC}x{local}"
        if cards < N_PROC * local:
            emit(dict(step=tag, run=False,
                      why=f"{N_PROC} processes x {local} cards need {N_PROC * local} cards; "
                          f"the host has {cards}"))
            continue
        t0 = time.perf_counter()
        procs = spawn_fleet(_child(tag, out), N_PROC, local, **pipes)
        ran = _finish(procs, wait_fleet(procs, TIMEOUT_S))
        emit(dict(step=tag, run=True, ok=ran, wall_s=round(time.perf_counter() - t0, 3)))
        ok &= ran
        if ran:
            for pid in range(N_PROC):
                for f in expect:
                    equal[f"{tag}_rank{pid}/{f}"] = same_npz(out / "single" / f,
                                                             out / f"{tag}_rank{pid}" / f)
    ok &= all(equal.values())
    emit(dict(step="compare", against="single", files=expect, equal=equal, ok=ok))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
