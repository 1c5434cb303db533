"""Benchmark of the port: 48-mer counting throughput and reads aligned per
second on the card (the counterpart of the repo's bench.py, which measures
the JAX package).

    python -m supernova_tpu_torch bench [--device cuda]
    python -m supernova_tpu_torch.bench [--device cuda]

Prints two JSON lines {"metric", "value", "unit", "vs_baseline", "extra"}:
first the count line with {"pather": "pending"}, then the same line with
the pather's numbers in "extra", so that a cut run still leaves a full
record.  The inputs and reference figures are the reference's:
  * kmer_count_throughput: count_kmers on 320,000 reads of 150 bases tiling
    a 1 Mb genome (seed 0, uniform_rl=150), three warm iterations, each
    ending in torch.cuda.synchronize(); against 20e6 kmers/s (a CPU MSP
    counter node);
  * reads_aligned_per_s and placed_frac: path_readset over 100,000 reads of
    150 bases of a 1 Mb genome (seed 12345), three warm iterations, run in
    a killable child process; against 40e3 reads/s.
BENCH_SMOKE=1 cuts both to a 12 kb genome (4,000 / 2,000 reads).  With
--device cuda and no card the benchmark exits 1: there is no CPU fallback.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REFERENCE_KMERS_PER_SEC = 20e6
REFERENCE_READS_PER_SEC = 40e3
SMOKE = bool(int(os.environ.get("BENCH_SMOKE", "0")))
READ_LEN = 150


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_count(device):
    """kmers/s of count_kmers on the reference's count inputs."""
    import torch

    from .core.kmer_codec import K
    from .kmer.count import count_kmers

    rng = np.random.default_rng(0)
    n_reads = 320_000 if not SMOKE else 4_000
    nb = n_reads * READ_LEN
    genome = rng.integers(0, 4, 1_000_000 if not SMOKE else 12_000)
    starts = rng.integers(0, len(genome) - READ_LEN, n_reads)
    flat = genome[np.add.outer(starts, np.arange(READ_LEN))].reshape(-1)
    codes_ext = np.zeros(nb + 128, dtype=np.int32)
    codes_ext[:nb] = flat
    pos_read = np.repeat(np.arange(n_reads, dtype=np.int32), READ_LEN)
    glen_pos = np.full(nb, READ_LEN, dtype=np.int32)
    bc_pos = np.repeat(rng.integers(1, 1_000_000, n_reads).astype(np.int32), READ_LEN)
    args = [torch.from_numpy(a).to(device) for a in (codes_ext, pos_read, glen_pos, bc_pos)]

    def step():
        n = int(count_kmers(*args, uniform_rl=READ_LEN).n_valid)
        _sync(torch, device)
        return n

    n_valid = step()  # warm-up
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    dt = (time.perf_counter() - t0) / iters
    return (nb - n_reads * (K - 1)) / dt, n_valid


def bench_pather(device):
    """Reads aligned/s: build the 1 Mb graph once, then time warm
    path_readset iterations over ~100k 150-mers."""
    import torch

    from .align import pather
    from .dbg import build as dbuild
    from .dbg import graph as dgraph
    from .ingest.reads import build_readset_flat
    from .kmer import count as kcount

    rng = np.random.default_rng(12345)
    genome = rng.integers(0, 4, 1_000_000 if not SMOKE else 12_000)
    n_reads = 100_000 if not SMOKE else 2_000
    starts = rng.integers(0, len(genome) - READ_LEN, n_reads)
    flat = genome[np.add.outer(starts, np.arange(READ_LEN))].reshape(-1)
    offsets = np.arange(n_reads + 1, dtype=np.int64) * READ_LEN
    rs = build_readset_flat(flat.astype(np.uint8), offsets, np.full(flat.shape, 37, np.uint8),
                            np.zeros(n_reads // 2, dtype=np.int32), n_barcodes=0,
                            barcoded=False)
    table = dbuild.trim_table(kcount.count_readset(rs, device, min_freq=2), pad_multiple=256)
    bg = dgraph.from_device(dbuild.build_graph(table), table)

    def step():
        rp = pather.path_readset(bg, rs, device)
        _sync(torch, device)
        return rp

    step()  # warm-up
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        rp = step()
    rps = n_reads / ((time.perf_counter() - t0) / iters)
    placed = float((rp.path_len[:n_reads] > 0).double().mean())
    return {
        "reads_aligned_per_s": round(rps, 1),
        "pather_vs_baseline": round(rps / REFERENCE_READS_PER_SEC, 3),
        "placed_frac": round(placed, 4),
    }


def main(device="cuda") -> int:
    """Both benchmarks on `device`; prints the two JSON lines."""
    from .core.device import resolve_device

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    kps, n_valid = bench_count(dev)

    def count_line(extra):
        return json.dumps({
            "metric": "kmer_count_throughput",
            "value": round(kps, 1),
            "unit": "kmers/s/chip",
            "vs_baseline": round(kps / REFERENCE_KMERS_PER_SEC, 3),
            "extra": dict(extra, n_valid=n_valid, device=str(dev)),
        })

    print(count_line({"pather": "pending"}), flush=True)
    # the pather in a killable child: a wedged launch cannot hold the count line
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    try:
        r = subprocess.run([sys.executable, "-m", "supernova_tpu_torch.bench", "--pather-child",
                            "--device", str(dev)], capture_output=True, env=env,
                           timeout=60 if SMOKE else 900)
        if r.returncode == 0 and r.stdout.strip():
            extra = json.loads(r.stdout.strip().splitlines()[-1])
        else:
            extra = {"pather_error": r.stderr.decode(errors="replace")[-200:]
                     or f"rc={r.returncode}"}
    except subprocess.TimeoutExpired:
        extra = {"pather_error": "pather bench budget exceeded (killed)"}
    print(count_line(extra), flush=True)
    return 0


def _cli(argv) -> int:
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    if "--pather-child" in argv:
        from .core.device import resolve_device

        print(json.dumps(bench_pather(resolve_device(device))), flush=True)
        return 0
    return main(device)


if __name__ == "__main__":
    raise SystemExit(_cli(sys.argv[1:]))
