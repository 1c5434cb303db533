#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (supernova_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero and prints no
"ok" line):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from supernova_tpu_torch/csrc (timed);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     one count block gives it: K1 on the ~90M-code read block, K4 on the
     ~62M-row x 4-key occurrence sort, K3 and K2 on the sorted occurrence
     stream (K2 with 5 columns).  All outputs are integers and must be
     EXACTLY equal; median times by CUDA events after a warm-up, beside
     the bound (bytes the function must move over 3.35 TB/s);
  4. the slice on an 8 kb genome on CUDA and on the CPU plain path: the
     KmerTable, every BaseGraph array and ReadPaths[:n_reads] identical;
  5. the slice at one block — a 2 Mb diploid genome (het 0.001), 600
     barcodes x 10 molecules x 50 kb, ~600k 150 bp reads, ~45x — through
     Pipeline(device="cuda"): per-stage wall time and peak memory,
     kmers_distinct, n_edges, placed_perc >= 95, BaseGraph.validate(), a
     strictly ascending unique table, and every kernel launched (launch
     counters reset just before the run);
  6. the same at genome scale (pipeline/datasets.py GENOME: 10 Mb, 3,000
     barcodes, ~3M reads, ~450M bases, ~45x), which takes the blocked
     count (>= 2 blocks, one device merge) and the blocked pather;
  7. K4 against its twin at the genome's merge shape (its raw row count,
     3 keys), and the merge's peak device bytes per raw row;
  8. no module of the JAX package (or jax) was imported.
Then one JSON line with the kernels (launches from the genome phase), the
nvidia-smi line, and the last line {"ok": true, "device": {...}}.  Exits
nonzero without a GPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

KERNELS = {
    "kmer_extract": ("supernova_tpu_torch/csrc/kmer_extract.cu",
                     "supernova_tpu/ops/pallas/kmer_extract.py:54"),
    "sort": ("supernova_tpu_torch/csrc/radix_sort.cu",
             "supernova_tpu/ops/pallas/sort.py:172"),
    "run_reduce": ("supernova_tpu_torch/csrc/run_reduce.cu",
                   "supernova_tpu/ops/pallas/run_reduce.py:206"),
    "compact": ("supernova_tpu_torch/csrc/compact.cu",
                "supernova_tpu/ops/pallas/compact.py:115"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory rate


def bound_ms(nbytes):
    """Least time to move `nbytes` through device memory (every kernel here
    is bound by bytes: integer work far below the card's operation rate)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(torch, fn, reps=5):
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def max_abs_err(torch, pairs):
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return float(err)


def check_sort(torch, keys, shape):
    """K4 against its twin on `keys`: exactly equal permutations."""
    from supernova_tpu_torch.ops.kernels import sort as k4

    got = k4.lex_argsort_cuda(*keys)
    ref = k4.lex_argsort_plain(*keys)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(got, ref)])
    check(torch.equal(got, ref), f"K4 differs from plain at {shape}")
    rows = keys[0].shape[0]
    return dict(
        shape=shape, max_abs_err=err,
        ms=median_ms(torch, lambda: k4.lex_argsort_cuda(*keys)),
        plain_ms=median_ms(torch, lambda: k4.lex_argsort_plain(*keys)),
        # read every key once, write the int64 permutation
        bound_ms=bound_ms(rows * 8 * (len(keys) + 1)),
    ), got


def phase_kernels(torch, rs, dev):
    """K1/K4/K3/K2 against their plain twins at one count block's shapes."""
    from supernova_tpu_torch.core import kmer_codec as kc
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import compact as k2
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3

    inp = kcount.prepare_reads(rs, dev)
    codes, n = inp["codes_ext"], inp["pos_read"].shape[0]
    res = {}

    got = k1.sliding_words_cuda(codes, n)
    ref = k1.sliding_words_plain(codes, n)
    torch.cuda.synchronize()
    err = max_abs_err(torch, zip(got, ref))
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K1 differs from plain")
    res["kmer_extract"] = dict(
        shape=f"{n} positions", max_abs_err=err,
        ms=median_ms(torch, lambda: k1.sliding_words_cuda(codes, n)),
        plain_ms=median_ms(torch, lambda: k1.sliding_words_plain(codes, n)),
        # read the codes, write three int64 words per position
        bound_ms=bound_ms(codes.numel() * 4 + n * 3 * 8),
    )
    del got, ref

    # the sorted occurrence stream after the tail cut (count_kmers' input
    # to the reduction)
    canon, bc, lm, rm, valid = kcount.extract_occurrences(
        codes, inp["pos_read"], inp["glen_pos"], inp["bc_pos"]
    )
    pk = kcount.pack_occurrence_attrs(bc, lm, rm, valid)
    rl = inp["uniform_rl"]
    a_, b_, c_, pk = kcount.uniform_tail_cut(rl, canon.a, canon.b, canon.c, pk)
    canon = kc.W3(a_, b_, c_).where(((pk >> 1) & 1) == 1, kc.SENTINEL)
    del inp, bc, lm, rm, valid, a_, b_, c_
    rows = canon.a.shape[0]
    res["sort"], perm = check_sort(torch, (*canon, pk), f"{rows} rows x 4 keys")
    ws, pk = canon.gather(perm), pk[perm]
    del canon, perm
    mf, mb = kcount.MIN_FREQ, kcount.MIN_BC

    got = k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)
    ref = k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb)
    torch.cuda.synchronize()
    err = max_abs_err(torch, zip(got, ref))
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K3 differs from plain")
    res["run_reduce"] = dict(
        shape=f"{rows} rows", max_abs_err=err,
        ms=median_ms(torch, lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)),
        plain_ms=median_ms(torch, lambda: k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb)),
        # read three words and the attributes, write keep, count and stats
        bound_ms=bound_ms(rows * (4 * 8 + 1 + 4 + 4)),
    )
    keep, count, stats = got
    del ref

    cols = (ws.a, ws.b, ws.c, count, stats)
    nv_k, out_k = k2.compact_cuda(keep, *cols)
    nv_p, out_p = k2.compact_plain(keep, *cols)
    torch.cuda.synchronize()
    nv = int(nv_p)
    check(int(nv_k) == nv, f"K2 n_valid {int(nv_k)} != plain {nv}")
    err = max_abs_err(torch, [(x[:nv], y[:nv]) for x, y in zip(out_k, out_p)])
    check(all(torch.equal(x[:nv], y[:nv]) for x, y in zip(out_k, out_p)),
          "K2 differs from plain")
    res["compact"] = dict(
        shape=f"{rows} rows x {len(cols)} columns, {nv} kept", max_abs_err=err,
        ms=median_ms(torch, lambda: k2.compact_cuda(keep, *cols)),
        plain_ms=median_ms(torch, lambda: k2.compact_plain(keep, *cols)),
        # read the mask, read and write the kept rows of every column
        bound_ms=bound_ms(rows + 2 * nv * sum(c.element_size() for c in cols)),
    )
    for name, r in res.items():
        print_kernel(name, r)
    return res


def print_kernel(name, r):
    print(f"[kernels] {name}: {r['shape']}: exact (max_abs_err {r['max_abs_err']}); "
          f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms")


def phase_small_slice(torch, rs):
    """The slice on CUDA vs the CPU plain path: identical outputs."""
    import numpy as np
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.pipeline.run import Pipeline

    outs = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as d:
            table, bg, rp = Pipeline(d, device=dev).run(rs)
        outs[dev] = (convert.table_to_numpy(table), bg, convert.readpaths_to_numpy(rp))
    (tg, bgg, rg), (tc, bgc, rc) = outs["cuda"], outs["cpu"]
    check(tg.n_valid == tc.n_valid, "small slice: n_valid differs")
    for f in ("count", "nbc", "left_mask", "right_mask"):
        check(np.array_equal(getattr(tg, f), getattr(tc, f)), f"small slice: table {f}")
    for i in range(3):
        check(np.array_equal(tg.words[i], tc.words[i]), f"small slice: table word {i}")
    for f in ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos"):
        check(np.array_equal(getattr(bgg, f), getattr(bgc, f)), f"small slice: graph {f}")
    check(np.array_equal(bgg.edges.values, bgc.edges.values), "small slice: edge codes")
    check(np.array_equal(bgg.edges.offsets, bgc.edges.offsets), "small slice: edge offsets")
    check(bgg.n_vertices == bgc.n_vertices, "small slice: n_vertices")
    n = rs.n_reads
    for f in rg._fields:
        check(np.array_equal(getattr(rg, f)[:n], getattr(rc, f)[:n]), f"small slice: paths {f}")
    print(f"[small] {n} reads: kmers {tg.n_valid}, edges {bgg.n_edges}: "
          "CUDA == CPU (table, graph, paths)")


def phase_slice(torch, rs, tag, min_blocks=None):
    """The slice through Pipeline(device="cuda") with the launch counters
    reset just before and read just after; returns (launches, count
    stage record)."""
    from supernova_tpu_torch.core import kmer_codec as kc
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline.run import Pipeline

    with tempfile.TemporaryDirectory() as outdir:
        kernels.reset_launch_counts()
        pl = Pipeline(outdir, device="cuda")
        table, bg, rp = pl.run(rs)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    for name, rec in pl.stage_records.items():
        print(f"[{tag}] stage {name}: wall {rec['wall_s']:.3f} s, "
              f"peak device memory {rec['peak_gb']:.3f} GiB")
    crec = pl.stage_records["count"]
    if min_blocks is not None:
        print(f"[{tag}] count: {crec.get('blocks')} blocks of {crec.get('block_rows')} raw "
              f"rows; merged {crec.get('raw_rows')} raw rows in one device merge")
        check(crec.get("blocks", 1) >= min_blocks,
              f"{crec.get('blocks', 1)} count blocks < {min_blocks}")
    kd, ne, placed = (pl.stats.get(k) for k in ("kmers_distinct", "n_edges", "placed_perc"))
    print(f"[{tag}] reads {rs.n_reads}, bases {int(rs.offsets[-1])}: kmers_distinct {kd}, "
          f"n_edges {ne}, placed_perc {placed:.3f}")
    print(f"[{tag}] launches {launches}")
    check(placed >= 95.0, f"placed_perc {placed} < 95")
    n = int(table.n_valid)
    w = table.words
    head, tail = kc.W3(w.a[: n - 1], w.b[: n - 1], w.c[: n - 1]), kc.W3(w.a[1:n], w.b[1:n], w.c[1:n])
    check(bool(kc.lex_lt(head, tail).all()), "table not strictly ascending over n_valid")
    bg.validate()
    print(f"[{tag}] BaseGraph.validate() passed; table strictly ascending over {n} rows")
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the main path")
    return launches, crec


def merge_shaped_input(torch, rows, distinct, seed):
    """Raw merge rows on the card: `rows` rows over `distinct` kmers (ids
    drawn uniformly), words an injective odd-multiplier hash of the id,
    count in 1..9, stats with small nbc and random mask bits."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, distinct, (rows,), device="cuda", generator=g)
    mask = 0xFFFFFFFF
    words = [(ids * m + a) & mask for m, a in ((2654435761, 0), (40503, 17), (2246822519, 5))]
    count = torch.randint(1, 10, (rows,), device="cuda", generator=g, dtype=torch.int32)
    stats = (torch.randint(1, 4, (rows,), device="cuda", generator=g, dtype=torch.int32) << 9) \
        | torch.randint(0, 512, (rows,), device="cuda", generator=g, dtype=torch.int32)
    return words, count, stats


def phase_merge(torch, raw_rows):
    """K4 at the genome merge's shape (printed; the JSON line carries the
    occurrence sort), and the merge's peak bytes per row."""
    from supernova_tpu_torch.kmer import count as kcount

    torch.cuda.empty_cache()
    words, count, stats = merge_shaped_input(torch, raw_rows, raw_rows // 2, 1)
    res, _ = check_sort(torch, words, f"{raw_rows} rows x 3 keys (merge)")
    print_kernel("sort", res)
    del words, count, stats
    # peak bytes per row of merge_raw_blocks, its inputs included, also at
    # the worst case for its memory: (nearly) every row a distinct kmer
    rows = 20_000_000
    for distinct, label in ((rows // 2, "ids from rows / 2"), (1 << 32, "ids from 2^32")):
        torch.cuda.empty_cache()
        words, count, stats = merge_shaped_input(torch, rows, distinct, 2)
        inputs = sum(t.numel() * t.element_size() for t in (*words, count, stats))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        table = kcount.merge_raw_blocks(*words, count, stats, kcount.MIN_FREQ, kcount.MIN_BC)
        torch.cuda.synchronize()
        per_row = (torch.cuda.max_memory_allocated() - base + inputs) / rows
        print(f"[merge] {rows} raw rows, {label}: peak {per_row:.1f} device bytes per raw row "
              f"(inputs included); MERGE_BYTES_PER_ROW = {kcount.MERGE_BYTES_PER_ROW}")
        check(per_row <= kcount.MERGE_BYTES_PER_ROW,
              f"merge took {per_row:.1f} B/row > MERGE_BYTES_PER_ROW")
        del words, count, stats, table


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    from supernova_tpu_torch.ops.kernels import _lib

    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.library()
    print(f"[build] {lib_path.relative_to(_lib.PKG_DIR.parent)} in "
          f"{time.perf_counter() - t0:.2f} s")

    from supernova_tpu_torch.pipeline import datasets

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rs_full = datasets.simulate(datasets.FULL, datasets.FULL_SEED)
    print(f"[data] full slice: {rs_full.n_reads} reads, {int(rs_full.offsets[-1])} bases "
          f"simulated in {time.perf_counter() - t0:.1f} s")
    kres = phase_kernels(torch, rs_full, dev)
    torch.cuda.empty_cache()
    phase_small_slice(torch, datasets.simulate(datasets.SMALL, datasets.SMALL_SEED))
    phase_slice(torch, rs_full, "full")
    del rs_full
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rs_genome = datasets.simulate(datasets.GENOME, datasets.GENOME_SEED)
    print(f"[data] genome: {rs_genome.n_reads} reads, {int(rs_genome.offsets[-1])} bases "
          f"simulated in {time.perf_counter() - t0:.1f} s")
    launches, crec = phase_slice(torch, rs_genome, "genome", min_blocks=2)
    del rs_genome
    phase_merge(torch, crec["raw_rows"])

    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "supernova_tpu"))
    check(not jax_mods, f"the port imported {jax_mods[:5]}")
    print("[imports] no jax and no supernova_tpu module in sys.modules")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
             library_ms=None, shape=r["shape"])
        for name, r in kres.items()
    ]}))
    print(f"[time] chip_smoke {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}")
        sys.exit(1)
