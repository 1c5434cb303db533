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
     stream (K2 with 5 columns, without and with the count's tail fill,
     the latter beside the K2 + zero + sentinel passes it replaced; then
     again on a raw block's kept rows, K3 with (1, 0)), and K3 again on
     that stream with ~10% of its rows folded into runs of 100k-1M rows;
     then K5 at the main path's scan shapes (SCAN_SHAPES: the count's
     extraction, a recompute join, a pather block's join and its hits)
     beside its twin and torch.cummax.
     All outputs are integers and must be EXACTLY equal; median times by
     CUDA events after a warm-up, beside the bound (bytes the function
     must move over 3.35 TB/s) and, for K4 and K2, one PyTorch call
     computing the same function (a yardstick the port never calls); K4's,
     K3's and K2's launches are listed one by one with their device times
     (stats/kernel_phases.py);
  4. the slice on an 8 kb genome on CUDA and on the CPU plain path: the
     KmerTable, every BaseGraph array, ReadPaths[:n_reads], the arrays of
     paths.npz and ebcx.npz and the paths stats identical; then the same
     on the genome cut to mixed lengths (every R1 23 bases shorter, as
     ingest leaves a real 10x R1) with 300k-position blocks, so both take
     the blocked mixed count and the blocked general pather; then
     [small run_full]: Pipeline.run_full on CUDA and on the CPU for the
     e2e genome (5 kb diploid; the legacy scaffolder) and the star-gap
     fixture (30 kb with a void; the fifteen scaffold phases): the four
     FASTA files and summary.json (timing keys aside) identical, and every
     kernel launched by each CUDA run; then the star-gap CUDA outdir
     resumed with the early phases poisoned: it re-enters after the last
     phase, runs none, launches nothing and writes the same FASTA bytes;
     then [cli]: the command line on tests/test_cli.py's 6 kb simulation
     (phase_cli: `run` on the card launching every kernel and equal to
     `--device cpu`, a stage retried, an injected OOM's exit 185, the
     no-card refusal, and every tool in a fresh `python -m
     supernova_tpu_torch` process, each exiting 0 with its JSON);
  5. the slice at one block — a 2 Mb diploid genome (het 0.001), 600
     barcodes x 10 molecules x 50 kb, ~600k 150 bp reads, ~45x — through
     Pipeline(device="cuda").run(): per-stage wall time and peak memory,
     kmers_distinct, n_edges, placed_perc >= 95 (rescued reads counted),
     the rescue's and extend's host seconds, paths.npz, ebcx.npz,
     summary.json and assembly.raw.fasta.gz written (its records nonempty
     and A/C/G/T only; records, bases, N50), BaseGraph.validate(), a
     strictly ascending unique table (kmers.npz reloaded by a resumed
     Pipeline), and every kernel launched (launch counters reset just
     before the run);
  6. [fastq run], the main path: the genome (pipeline/datasets.py GENOME:
     10 Mb, 3,000 barcodes, ~3M reads, ~450M bases, ~45x) simulated and
     written as 10x FASTQs in LANES bcl2fastq-named lanes by the port's
     write_sim_fastqs (one process a lane) in a process started before
     phase 2, beside phases 2-5 and 10, then found by discover_input_fastqs, checked by
     preflight and read by ingest_10x_fastqs (walls); then the checks of 5
     through run(), whose count and pather plan their blocks from the
     card's free memory (count_block_positions, path_block_positions:
     printed, neither the reference's 96M, no OOM retry; an H100 80GB
     counts the genome in one block and paths it in several); then
     [derived kernels]: K1-K4 against their twins at the shapes the card's
     count block gives them on the genome; then stage_patch on the
     pather's paths (paths.npz reused by a resumed Pipeline, no launch):
     gap pairs and closures, the patched graph's edges, the re-path's
     placed_perc, the rebuild's launches (each kernel > 0 when anything
     closed); then [supergraph]: stage_supergraph on the patched graph
     and its paths (wall, peak, the closure glue's route, which must be
     "device", its closure positions P and its budget overflows, which
     must be 0; closures, super edges, lines before and after the break,
     pull-aparts; K4 and K2 launched by the stage), then the stage's
     closures glued again: D through the device glue equal to D through
     the host core, the glue's labels on the card equal to its plain
     twin's on CPU tensors, and K4 (steps 1, 3, 4 and the zipper's sort)
     and K2 (the seed compaction) against their twins at the inputs the
     glue gave them, timed beside their bounds and, for the 2-key sorts, a
     stable torch.sort of the packed pair; K4 also at step 6's one-key
     sort of the candidates' overlaps, beside a stable torch.sort of the
     key.  [resume]: run() again on the
     same outdir with resume=True: no launch in the count and graph
     stages, no K3 or K2 in the paths stage, the same FASTA bytes; then
     stage_supergraph resumed: no launch, the same D and lines.
     [scaffold]: `python -m supernova_tpu_torch run --resume` on that
     outdir, through cli.main in this process (run_full with resume=True
     on reads.npz; the patched graph's paths.npz put back after
     [resume]'s run() re-pathed the base graph): the CLI exits 0, prints
     summary.json, marks its stages complete in pipestance.json and
     writes the .mri.tgz bundle; the count and graph stages reload and
     launch nothing, the
     paths stage is skipped, the patch and supergraph stages re-enter with
     no launch, and the scaffold stage runs on the genome: its phases'
     walls and snapshots, scaffolds, line_line_N50, Flipper phasing, the
     het DP on the card (equal to the same DP on CPU tensors, on the
     genome's own bubble pairs; pairs, shape, seconds), the four FASTA
     flavors (A/C/G/T/N only), the GFA files, the super files, the
     histograms and summary.json written, hetdist_aligned logged, and the
     share of pseudohap contigs (split at N, > 400 bp) that are exact
     substrings of a simulated haplotype strand; `evaluate` of the
     pseudohap against the genome's haplotypes starts in a background
     process, read before 12 ([evaluate]: anchored_frac > 0.9).  Then,
     on that run's scaffold stage (MESH_SHARDS virtual shards on cuda:0):
     [mesh links]: the legacy scaffolder's incidence rows (canonical lines
     with barcodes and their barcode sets, as the stage built them and
     passed them to link_triples_np): bc_link_triples on the card and
     sharded_bc_links over the shards at cap 16 and at the longest barcode
     run, each equal to link_triples_np(max_per_bc=cap), the latter to the
     stage's own call; the dry run's scaffold-join round on the shards; K4
     and K2 launched (counters reset just before); K4 at the (bc, item)
     and pair sorts and K2 at the run-total compaction against their twins.
     [mesh phase]: every bubble of every scaffolded line, one vote row per
     (read, D-edge) placement on an arm edge, sharded_vote_matrix over the
     shards: each line's _support_matrix in its rows and columns, and
     phase_line from the mesh's counts equal to the host's on every line;
     the dry run's phasing round.  [fmindex]: FMIndex.from_edges of the
     patched base graph on the card, its suffix array equal to the same
     doubling on K4's twin, bwt/less/occ_ck equal to those derived on the
     host; count_batch_device on FM_QUERIES patterns of 16-100 bases cut
     from the reads, equal to CPU tensors, FMIndex.count and (locate) a
     brute-force search on subsamples; queries/s; K4 at the last doubling
     round's sort against its twin.  [patch
     kernels]: K1-K4 against their twins at the rebuild count's shapes
     (one strand of every edge plus the closures, unbarcoded, min_freq 1,
     min_read_len K).  The genome's later phases use this FASTQ-ingested
     readset;
  7. the genome's count four more ways (count stage only), each at the
     reference's 96M-position blocks: (0) blocked, >= 2 blocks spilled and
     one device merge; (a) its merge cut into >= 4 kmer-range partitions
     on the card, blocks spilled to a directory; (b) the same call again
     with no block size given, every block resumed from the spills in
     their own 96M blocks (not the card's budget) and none recounted; (c)
     count_readset from 96M beside a ballast tensor that leaves the card
     less free memory than a 96M-position block's count peak but more
     than a 48M one's (both measured first, allocated and reserved), so
     it runs out of memory and halves its block size.  Each table equals
     the fastq run's bit for bit (the card's budget held to the
     reference's blocking); wall, device peak, partitions, launches;
     the genome's first block counted from prepare_reads and from the
     packed inputs it replaced (a yardstick): identical raw tables, walls;
     then the general pather, with and without the tail cut, equal to the
     fused one on the genome's first block;
  8. the genome cut to mixed lengths, on the reads of the barcodes that
     hold its first 45% (~1.35M reads, ~187M bases, two count blocks;
     the whole cut genome, 415.5M bases in five blocks, cost 135 s of the
     script's 1,007 s on one H100, 84% of its 1,200 s limit, and [scaffold]
     added ~250 s): first each
     kernel against its twin at the shapes its first block gives them
     (every position a sort row, the sorted stream ending in one sentinel
     run; K3 with (1, 0) and with the filter, then alone on the real rows,
     the sentinel run and its last half; K2 on both K3 outputs); then
     through Pipeline(device="cuda").run() with the checks of 5, the
     block budgets pinned to 96M positions (fixed_blocks): the blocked
     mixed count and the blocked general pather; its count again at
     48M-position blocks, equal to the Pipeline's table; its paths at
     96M-position blocks, then beside a ballast between one 96M- and one
     48M-position block's paths peak (both measured first): exactly one
     OOM retry and the same ReadPaths;
  9. build_links on the genome's table at the card's budget (one join)
     and with the successor resolve in >= 4 chunks: equal links, each
     run's peak bytes a joined row within LINK_BYTES_PER_ROW;
 10. (run after 5, while the genome is simulated) the partitioned merge
     at the size of the reference's 30 Mb run
     (artifacts/val30mb_r5/run.log): 15 sorted synthetic raw blocks built
     on the card and spilled, 473,961,288 raw rows, 31,200,000 "genome"
     kmers in 13 of the 15 blocks each (kept) and single-block count-1
     "error" kmers (dropped); merged under the card's own budget (>= 2
     partitions) and again cut into >= 4, then the adjacency recompute:
     equal tables, n_valid and the kept count sum the construction
     implies, strictly ascending; walls, device peaks and their bytes a
     row, host peak RSS, K4/K2 launches a partition;
 11. K4 against its twin at the genome's merge shape (its raw row count,
     3 keys) and at its graph's chain-order shape (2 keys, two nodes a
     kmer), and the merge's peak device bytes per raw row;
 12. no module of the JAX package (or jax) was imported, here or in the
     fresh `python -m supernova_tpu_torch` processes (-X importtime).
The mesh path (after 5, on the full slice; MESH_SHARDS = 4 virtual shards,
all on cuda:0): [mesh] sharded_count and sharded_count_hier ((2, 2)), each
shard's table equal to the single-device table's rows of that shard's
kmer hash and the merged table equal to it, overflow 0; sharded_build_graph
equal to the Pipeline's BaseGraph array for array; the Pipeline's mesh
pather with the dictionary replicated and value-sharded (PATH_VS_DICT_ROWS
forced to 0), ReadPaths equal to path_readset's; Pipeline(multi_device=
(1, 4)).run() on the 8 kb slice equal to the single-device run (FASTA, npz
files, summary.json; n_shards and n_shards_path 4, no overflow recount);
the launch counters set to 0 just before these calls and read just after,
every kernel launched; K1-K4 against their twins at shard 0's shapes; walls
and peaks beside the card's name and power limit, marked as virtual shards.
[mesh glue] (after 6's glue): glue_closures_sharded over the 4 shards on
the genome's closures, the one-device glue's partition, overflow 0.
[fleet] (after 11): on a host of two or more cards, stats/fleet.py's 2 x 1
NCCL fleet on the full slice (count, graph, paths, patch and supergraph
across processes), every process's checkpoints equal to one card's; on
one card a line saying
it was not run and why.  Every
phase_slice run prints each stage's mem_peak_host_<stage>_gb.
Each phase's wall is printed as a [time] line.  Then one JSON line with
the kernels (launches from the main path, the fastq run's run(),
stage_patch and stage_supergraph; patch_launches from its rebuild;
supergraph_launches from stage_supergraph; mixed_launches from the mixed
genome's run(); mesh_launches from [mesh], mesh_glue_launches from [mesh
glue], links_launches from [mesh links], fmindex_launches from [fmindex];
mixed_* times from 8, patch_*, glue, links, fmindex and mesh times from 6
and [mesh]),
the nvidia-smi line, and the last line {"ok": true, "device": {...}}.
Exits nonzero without a GPU.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

KERNELS = {
    "kmer_extract": ("supernova_tpu_torch/csrc/kmer_extract.cu",
                     "supernova_tpu/ops/pallas/kmer_extract.py:54"),
    "sort": ("supernova_tpu_torch/csrc/radix_sort.cu",
             "supernova_tpu/ops/pallas/sort.py:172"),
    "run_reduce": ("supernova_tpu_torch/csrc/run_reduce.cu",
                   "supernova_tpu/ops/pallas/run_reduce.py:206"),
    "compact": ("supernova_tpu_torch/csrc/compact.cu",
                "supernova_tpu/ops/pallas/compact.py:115"),
    "scan_max": ("supernova_tpu_torch/csrc/scan_max.cu",
                 "none: jax.lax.cummax (supernova_tpu/kmer/count.py:80,126), lowered by XLA"),
}
# the keys every kernel's entry of the JSON line has; the entry also
# carries the kernel's other measurements (K3 on long runs and on the mixed
# block's parts; K2's sector floor and fill; every kernel's mixed_* keys)
COMMON_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
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


REPO = Path(__file__).resolve().parent


def port_cmd(*args):
    """`python -m supernova_tpu_torch *args` with -X importtime, so that its
    stderr lists every module the fresh process imported."""
    return [sys.executable, "-X", "importtime", "-m", "supernova_tpu_torch", *map(str, args)]


def foreign_imports(stderr):
    """The jax and supernova_tpu modules in an -X importtime listing."""
    names = [line.split("|")[-1].strip() for line in stderr.splitlines()
             if line.startswith("import time:")]
    check("supernova_tpu_torch.cli" in names, "a port process did not list its imports")
    return [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "supernova_tpu")]


class Background:
    """A subprocess run from the repo's root beside the main process: a
    thread collects its output and its wall, start to exit.  Every one still
    running when the script ends is killed (stop_all)."""

    started = []

    def __init__(self, cmd, env=None):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=dict(env or os.environ, PYTHONPATH=str(REPO)),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.wall = self.out = self.err = None
        self.thread = threading.Thread(target=self._collect, daemon=True)
        self.thread.start()
        Background.started.append(self)

    def _collect(self):
        self.out, self.err = self.proc.communicate()
        self.wall = time.perf_counter() - self.t0

    def result(self, timeout=600):
        """-> (exit code, stdout, stderr) once the process has ended."""
        self.thread.join(timeout)
        check(not self.thread.is_alive(), f"{self.proc.args[4:6]} did not end in {timeout} s")
        return self.proc.returncode, self.out, self.err

    @classmethod
    def stop_all(cls):
        for b in cls.started:
            if b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()


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
    """K4 against its twin on `keys`: exactly equal permutations; the
    yardstick is torch.sort of the first two keys packed into one int64
    (the 2-key lexicographic argsort in one call; packed beforehand), or of
    the one key."""
    from supernova_tpu_torch.ops.kernels import sort as k4

    got = k4.lex_argsort_cuda(*keys)
    ref = k4.lex_argsort_plain(*keys)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(got, ref)])
    check(torch.equal(got, ref), f"K4 differs from plain at {shape}")
    rows = keys[0].shape[0]
    packed = k4._pair(keys[0], keys[1]) if len(keys) > 1 else keys[0]
    res = dict(
        shape=shape, max_abs_err=err,
        ms=median_ms(torch, lambda: k4.lex_argsort_cuda(*keys)),
        plain_ms=median_ms(torch, lambda: k4.lex_argsort_plain(*keys)),
        # read every key once, write the int64 permutation
        bound_ms=bound_ms(k4.launch_bytes(rows, len(keys))),
        library_ms=median_ms(torch, lambda: torch.sort(packed, stable=True).indices),
        library_shape=(f"torch.sort(stable=True) of keys 0-1 packed in one int64, {rows} rows"
                       if len(keys) > 1 else f"torch.sort(stable=True) of the key, {rows} rows"),
    )
    print_kernel("sort", res)
    print_launches(torch, "sort", lambda: k4.lex_argsort_cuda(*keys))
    return res, got


def print_launches(torch, name, fn):
    """Every device launch of one call of fn, in order, with its device
    time (median of 5 calls, torch.profiler), then the sums by kernel."""
    from supernova_tpu_torch.stats import kernel_phases as kp

    times = kp.launch_times(fn)
    if not times:
        print(f"[{name} launches] the profiler captured no whole call")
        return
    print(f"[{name} launches] " + ", ".join(f"{i}:{n} {ms:.3f}" for i, (n, ms) in enumerate(times)))
    for kname, (nl, ms) in kp.by_name(times).items():
        print(f"[{name} launches] sum {kname}: {nl} launches, {ms:.3f} ms")


def fold_long_runs(ws, pk):
    """The sorted stream with ~10% of its rows folded into runs of 100k-1M
    rows: each chosen segment takes its first row's words, which keeps the
    stream sorted (K3's adversarial input: a repeat seen in many reads)."""
    import numpy as np

    frac = 0.1
    rng = np.random.default_rng(3)
    a, b, c = (w.clone() for w in ws)
    rows = a.shape[0]
    folded, at = 0, 0
    gap = int(rows * (1 - frac) / 12)
    while folded < frac * rows:
        length = int(rng.integers(100_000, 1_000_001))
        at += int(rng.integers(gap // 2, gap))
        if at + length > rows:
            break
        for w in (a, b, c):
            w[at : at + length] = w[at].clone()
        folded += length
        at += length
    return (a, b, c, pk), folded


def phase_kernels(torch, rs, dev):
    """K1/K4/K3/K2 against their plain twins at one count block's shapes."""
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import compact as k2
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3
    from supernova_tpu_torch.stats import kernel_phases

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
        bound_ms=bound_ms(k1.launch_bytes(codes.numel(), n)),
    )
    print_kernel("kmer_extract", res["kmer_extract"])
    del got, ref, inp, codes

    # the sorted occurrence stream after the tail cut (count_kmers' input
    # to the reduction)
    canon, pk = kernel_phases.occurrence_stream(rs, dev)
    rows = canon.a.shape[0]
    res["sort"], perm = check_sort(torch, (*canon, pk), f"{rows} rows x 4 keys")
    ws, pk = canon.gather(perm), pk[perm]
    del canon, perm
    mf, mb = kcount.MIN_FREQ, kcount.MIN_BC

    def run_k3(cols, label):
        got = k3.run_reduce_cuda(*cols, mf, mb)
        ref = k3.run_reduce_plain(*cols, mf, mb)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"K3 differs from plain ({label})")
        return got, max_abs_err(torch, zip(got, ref)), median_ms(
            torch, lambda: k3.run_reduce_cuda(*cols, mf, mb))

    got, err, ms = run_k3((*ws, pk), "occurrence stream")
    res["run_reduce"] = dict(
        shape=f"{rows} rows", max_abs_err=err, ms=ms,
        plain_ms=median_ms(torch, lambda: k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb)),
        # read three words and the attributes, write keep, count and stats
        bound_ms=bound_ms(k3.launch_bytes(rows)),
    )
    print_kernel("run_reduce", res["run_reduce"])
    print_launches(torch, "run_reduce", lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb))
    adv, folded = fold_long_runs(ws, pk)
    _, adv_err, adv_ms = run_k3(adv, "long runs")
    res["run_reduce"]["adversarial_ms"] = adv_ms
    print(f"[kernels] run_reduce: {rows} rows, {folded} of them in runs of 100k-1M rows: exact "
          f"(max_abs_err {adv_err}); kernel {adv_ms:.3f} ms = "
          f"{adv_ms / res['run_reduce']['ms']:.3f} x the occurrence stream's")
    del adv
    keep, count, stats = got

    # K2 on the count's kept run ends (K3 with the filter), then on a raw
    # block's (K3 with (1, 0): every real run end), as the count calls it
    res["compact"] = check_compact(torch, keep, (ws.a, ws.b, ws.c, count, stats), "filtered")
    print_launches(torch, "compact",
                   lambda: k2.compact_cuda(keep, ws.a, ws.b, ws.c, count, stats, fills=K2_FILLS))
    del keep, count, stats, got
    keep, count, stats = k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, 1, 0)
    raw = check_compact(torch, keep, (ws.a, ws.b, ws.c, count, stats), "raw block")
    res["compact"].update(raw_shape=raw["shape"], raw_ms=raw["ms"], raw_fill_ms=raw["fill_ms"],
                          raw_three_step_ms=raw["three_step_ms"])
    return res


# K5's shapes on the main path (the benchmark's val10mb readset: 1,575,580
# pairs of 2 x 150 bases; a 10,462,765-kmer table; 2 pather blocks of
# 361,747,200 positions, 103 queries a 150-base read):
#   (label, elements, values given, one mask bit every `period` elements)
SCAN_SHAPES = (
    # the extraction's read starts, values None (count.py extract_occurrences)
    ("extraction", 472_674_000, False, 150),
    # a recompute join: the table and a chunk of the same size, merged;
    # 2 of its 3 scans take values None, the third the table rows
    ("recompute join", 20_925_530, False, 2),
    # a pather block's join: 248,399,744 queries beside the table
    ("pather join", 258_862_509, False, 25),
    # the hits of the first pather block (~90% of its queries), the slot
    # counter masked at each read's first hit (pather.py _compact_and_place)
    ("block hits", 224_000_000, True, 93),
)


def phase_scan_max(torch, dev):
    """K5 against its plain twin (torch.where, then torch.cummax) and
    torch.cummax alone (of the where's result, built beforehand) at the main
    path's shapes; exact equality, median times by CUDA events."""
    from supernova_tpu_torch.ops.kernels import scan_max as k5

    res = {}
    for label, n, has_values, period in SCAN_SHAPES:
        idx = torch.arange(n, device=dev)
        mask = idx % period == 0
        # a non-decreasing counter (as the pather's slot counter) or None
        values = torch.cumsum(mask.long(), 0) if has_values else None
        x = torch.where(mask, idx if values is None else values, -1)
        del idx
        got = k5.scan_max_cuda(values, mask, -1)
        ref = torch.cummax(x, 0).values
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K5 differs from torch.cummax ({label})")
        r = dict(
            shape=f"{label}: {n} elements, " + ("int64 values" if has_values else "values None")
            + f", mask 1 in {period}",
            max_abs_err=max_abs_err(torch, [(got, ref)]),
            ms=median_ms(torch, lambda: k5.scan_max_cuda(values, mask, -1)),
            plain_ms=median_ms(torch, lambda: k5.scan_max_plain(values, mask, -1)),
            # read the values (if any) and the mask, write the int64 result
            bound_ms=bound_ms(k5.launch_bytes(n, 8, has_values, True)),
            library_ms=median_ms(torch, lambda: torch.cummax(x, 0).values),
            library_shape=f"torch.cummax of the masked values, {n} elements",
        )
        if label == "recompute join":  # the join's third scan: the table rows
            rows = torch.cumsum(mask.long(), 0) - 1
            r["values_ms"] = median_ms(torch, lambda: k5.scan_max_cuda(rows, mask, -1))
            r["values_bound_ms"] = bound_ms(k5.launch_bytes(n, 8, True, True))
            del rows
        print_kernel("scan_max", r)
        res[label] = r
        del got, ref, x, values, mask
        torch.cuda.empty_cache()
    print_launches(torch, "scan_max", lambda: k5.scan_max_cuda(
        None, torch.ones(1 << 20, dtype=torch.bool, device=dev), 0))
    # the entry is the extraction's; the other shapes' numbers under their labels
    out = dict(res["extraction"])
    for label, r in res.items():
        if label != "extraction":
            key = label.replace(" ", "_")
            out.update({f"{key}_{k}": v for k, v in r.items() if k != "library_shape"})
    return out


def once_ms(torch, fn):
    """fn() once, timed by CUDA events -> (result, ms)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def phase_kernels_derived(torch, rs, dev, res, crec):
    """K1/K4/K3/K2 against their plain twins at the shapes the card's own
    count block gave them on the genome's main path (crec, the count
    stage's record: its block_positions, blocks and first block's
    positions and sort rows, which the block here must match): the first
    block's positions, its sort rows after the tail cut (4 keys), K3 with
    the count's filter on the sorted stream and K2 on its kept run ends.
    Exactly equal; kernel ms (median of 3), the plain twin's (one call:
    K3's takes seconds here), the bound and one library call where one
    exists; kept in res[name] as derived_* keys."""
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3
    from supernova_tpu_torch.ops.kernels import sort as k4

    blocks = kcount.split_readset_blocks(rs, crec["block_positions"])
    check(len(blocks) == crec["blocks"], f"derived kernels: {len(blocks)} blocks at "
          f"{crec['block_positions']} positions, the main path counted {crec['blocks']}")
    # prepared as the main path's count prepared its first block
    p = (kcount.prepare_reads(rs, dev) if len(blocks) == 1 else kcount.prepare_reads(
        blocks[0], dev, pad_to_positions=max(int(b.offsets[-1]) for b in blocks),
        pad_to_reads=max(b.n_reads for b in blocks)))
    check(p["pos_read"].shape[0] == crec["first_block_positions"],
          f"derived kernels: {p['pos_read'].shape[0]} positions, the main path's first block "
          f"had {crec['first_block_positions']}")
    codes, n = p["codes_ext"], p["pos_read"].shape[0]
    out = {}

    def against_twin(name, got, twin, shape):
        ref, plain = once_ms(torch, twin)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"{name} differs from plain (derived block)")
        out[name] = dict(shape=shape, max_abs_err=max_abs_err(torch, zip(got, ref)),
                         plain_ms=plain, library_ms=None)

    against_twin("kmer_extract", k1.sliding_words_cuda(codes, n),
                 lambda: k1.sliding_words_plain(codes, n), f"{n} positions")
    out["kmer_extract"].update(ms=median_ms(torch, lambda: k1.sliding_words_cuda(codes, n), reps=3),
                               bound_ms=bound_ms(k1.launch_bytes(codes.numel(), n)))
    canon, pk = kcount.occurrence_rows(codes, p["pos_read"], p["glen_pos"], p["bc_pos"],
                                       p["uniform_rl"])
    del p, codes
    keys, rows = (*canon, pk), pk.shape[0]
    check(rows == crec["first_block_sort_rows"], f"derived kernels: {rows} sort rows, the "
          f"main path's first block had {crec['first_block_sort_rows']}")
    perm = k4.lex_argsort_cuda(*keys)
    against_twin("sort", perm, lambda: k4.lex_argsort_plain(*keys), f"{rows} rows x 4 keys")
    packed = k4._pair(keys[0], keys[1])
    out["sort"].update(
        ms=median_ms(torch, lambda: k4.lex_argsort_cuda(*keys), reps=3),
        bound_ms=bound_ms(k4.launch_bytes(rows, len(keys))),
        library_ms=median_ms(torch, lambda: torch.sort(packed, stable=True).indices, reps=3),
        library_shape=f"torch.sort(stable=True) of keys 0-1 packed in one int64, {rows} rows")
    del packed
    ws, pk = canon.gather(perm), pk[perm]
    del canon, perm, keys
    mf, mb = kcount.MIN_FREQ, kcount.MIN_BC
    got = k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)
    against_twin("run_reduce", got, lambda: k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb),
                 f"{rows} rows")
    out["run_reduce"].update(
        ms=median_ms(torch, lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb), reps=3),
        bound_ms=bound_ms(k3.launch_bytes(rows)))
    keep, count, stats = got
    del pk, got
    out["compact"] = compact_kept(torch, keep, (ws.a, ws.b, ws.c, count, stats), "derived block")[0]
    for name, r in out.items():
        print_kernel(f"{name} (the card's count block)", r)
        res[name].update({f"derived_{k}": v for k, v in r.items()})


def phase_kernels_mixed(torch, rs, dev, res):
    """K1/K4/K3/K2 against their plain twins at the shapes the first block
    of the mixed-length genome gives them in the blocked count: every
    position a sort row (no tail cut), so the sorted stream ends in one run
    of sentinel rows, the positions that start no kmer.  K3 with (1, 0) as
    the block calls it and with the count's filter; K2 on both outputs.
    Then K3 on the stream's parts (the real rows; the sentinel run, whole
    and its last half), which shows where K3's time goes.  Adds mixed_*
    keys to the kernels' entries in `res`."""
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import _lib
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3

    blocks = kcount.split_readset_blocks(rs, kcount.BLOCK_POSITIONS)
    inp = kcount.prepare_reads(blocks[0], dev, pad_to_positions=max(int(b.offsets[-1]) for b in blocks),
                               pad_to_reads=max(b.n_reads for b in blocks))
    check(inp["uniform_rl"] is None, "mixed kernels: the first block has uniform reads")
    codes, n = inp["codes_ext"], inp["pos_read"].shape[0]
    got = k1.sliding_words_cuda(codes, n)
    ref = k1.sliding_words_plain(codes, n)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K1 differs from plain (mixed block)")
    res["kmer_extract"].update(
        mixed_shape=f"{n} positions", mixed_max_abs_err=max_abs_err(torch, zip(got, ref)),
        mixed_ms=median_ms(torch, lambda: k1.sliding_words_cuda(codes, n)),
        mixed_plain_ms=median_ms(torch, lambda: k1.sliding_words_plain(codes, n)),
        mixed_bound_ms=bound_ms(k1.launch_bytes(codes.numel(), n)))
    print_kernel("kmer_extract (mixed block)", mixed_view(res["kmer_extract"]))
    del got, ref

    canon, pk = kcount.occurrence_rows(inp["codes_ext"], inp["pos_read"], inp["glen_pos"],
                                       inp["bc_pos"], inp["uniform_rl"])
    del inp, codes
    rows = pk.shape[0]
    r, perm = check_sort(torch, (*canon, pk), f"{rows} rows x 4 keys (mixed block)")
    res["sort"].update({f"mixed_{k}": r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "library_ms")})
    ws, pk = canon.gather(perm), pk[perm]
    del canon, perm

    outs, k3res = {}, res["run_reduce"]
    for (mf, mb), key in (((1, 0), "mixed"), ((kcount.MIN_FREQ, kcount.MIN_BC), "mixed_filtered")):
        got = k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)
        ref, plain = once_ms(torch, lambda: k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb))
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"K3 differs from plain (mixed block, ({mf}, {mb}))")
        k3res.update({
            f"{key}_shape": f"{rows} rows, ({mf}, {mb})",
            f"{key}_max_abs_err": max_abs_err(torch, zip(got, ref)),
            f"{key}_ms": median_ms(torch, lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)),
            f"{key}_plain_ms": plain,  # one call: the twin takes seconds here
            f"{key}_bound_ms": bound_ms(k3.launch_bytes(rows))})
        print_kernel(f"run_reduce (mixed block, ({mf}, {mb}))", mixed_view(k3res, key))
        outs[key] = got
        del ref

    # where K3's time goes: the real rows alone, then the sentinel run
    # (every row past the last real one) whole and its last half
    sent = k3.SENTINEL
    n_real = int(((ws.a != sent) | (ws.b != sent) | (ws.c != sent)).sum())
    run_rows = rows - n_real
    tile = _lib.library().sn_run_reduce_tile_rows()
    parts = {"real": (0, n_real), "sentinel_run": (n_real, rows),
             "half_sentinel_run": (rows - run_rows // 2, rows)}
    for key, (lo, hi) in parts.items():
        cols = (ws.a[lo:hi], ws.b[lo:hi], ws.c[lo:hi], pk[lo:hi])
        k3res[f"{key}_ms"] = median_ms(torch, lambda: k3.run_reduce_cuda(*cols, 1, 0))
        k3res[f"{key}_rows"] = hi - lo
    t = run_rows // tile
    print(f"[kernels] run_reduce (mixed block): {rows} rows = {n_real} real + a sentinel run of "
          f"{run_rows} ({t} tiles of {tile}): whole {k3res['mixed_ms']:.3f} ms, real rows "
          f"{k3res['real_ms']:.3f} ms, the sentinel run {k3res['sentinel_run_ms']:.3f} ms, its "
          f"last half {k3res['half_sentinel_run_ms']:.3f} ms (ratio "
          f"{k3res['sentinel_run_ms'] / k3res['half_sentinel_run_ms']:.2f}; a tile k tiles into a "
          f"run walks back over k / 32 steps of the tail aggregates: ~{t * t // 64} steps over "
          "the run, 4x for 2x its length)")

    # K2 on K3's outputs, with the fill (as the count calls it) and without
    for key, label in (("mixed", "mixed block, raw"), ("mixed_filtered", "mixed block, filtered")):
        keep, count, stats = outs.pop(key)
        r = check_compact(torch, keep, (ws.a, ws.b, ws.c, count, stats), label)
        res["compact"].update({f"{key}_{k}": r[k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "fill_ms",
            "fill_plain_ms", "fill_bound_ms")})
        del keep, count, stats, r


def mixed_view(r, key="mixed"):
    """The `key`_* entries of a kernel's result under print_kernel's names."""
    return {k: r[f"{key}_{k}"] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms")}


# the count's tail fill: the sentinel in the three words, 0 in count and stats
K2_FILLS = (0xFFFFFFFF,) * 3 + (0, 0)


def compact_kept(torch, keep, cols, label):
    """K2 against its twin without fill: the kept rows exactly equal; its
    time beside the bound (read the mask, read and write the kept rows of
    every column), the sector floor (a kept row's read of a column costs
    32 B), the plain twin and `c[keep]` for each column (the library)."""
    from supernova_tpu_torch.ops.kernels import compact as k2

    rows = keep.shape[0]
    nv_k, out_k = k2.compact_cuda(keep, *cols)
    nv_p, out_p = k2.compact_plain(keep, *cols)
    torch.cuda.synchronize()
    nv = int(nv_p)
    check(int(nv_k) == nv, f"K2 n_valid {int(nv_k)} != plain {nv} ({label})")
    err = max_abs_err(torch, [(x[:nv], y[:nv]) for x, y in zip(out_k, out_p)])
    check(all(torch.equal(x[:nv], y[:nv]) for x, y in zip(out_k, out_p)),
          f"K2 differs from plain ({label})")
    del out_k, out_p
    row_bytes = sum(c.element_size() for c in cols)
    return dict(
        shape=f"{rows} rows x {len(cols)} columns, {nv} kept ({nv / rows:.4f})", max_abs_err=err,
        ms=median_ms(torch, lambda: k2.compact_cuda(keep, *cols)),
        plain_ms=median_ms(torch, lambda: k2.compact_plain(keep, *cols)),
        bound_ms=bound_ms(k2.launch_bytes(rows, nv, row_bytes, fill=False)),
        sector_floor_ms=bound_ms(rows + nv * len(cols) * 32 + nv * row_bytes),
        library_ms=median_ms(torch, lambda: [c[keep] for c in cols]),
        library_shape=f"c[keep] for each of the {len(cols)} columns",
    ), nv


def check_compact(torch, keep, cols, label):
    """K2 against its twin on the count's five columns, without fill (the
    kept rows; compact_kept) and with the count's fill (every row), beside
    the sequence the count ran before K2 wrote the tail: K2, a zero pass
    over every column and a sentinel pass over the words.  Bounds: bytes
    the function must move, and the sector floor."""
    from supernova_tpu_torch.ops.kernels import compact as k2

    rows = keep.shape[0]
    r, nv = compact_kept(torch, keep, cols, label)

    def three_step():
        n_valid, outs = k2.compact_cuda(keep, *cols)
        live = torch.arange(rows, device=keep.device) < n_valid
        outs = [torch.where(live, c, 0) for c in outs]
        m = torch.arange(rows, device=keep.device) < n_valid
        return [torch.where(m, w, 0xFFFFFFFF) for w in outs[:3]] + outs[3:]

    fill_k = k2.compact_cuda(keep, *cols, fills=K2_FILLS)[1]
    fill_p = k2.compact_plain(keep, *cols, fills=K2_FILLS)[1]
    old = three_step()
    torch.cuda.synchronize()
    r["max_abs_err"] = max(r["max_abs_err"], max_abs_err(torch, zip(fill_k, fill_p)))
    check(all(torch.equal(x, y) for x, y in zip(fill_k, fill_p)),
          f"K2 with fill differs from plain ({label})")
    check(all(torch.equal(x, y) for x, y in zip(fill_k, old)),
          f"K2 with fill differs from K2 + zero + sentinel passes ({label})")
    del fill_k, fill_p, old
    row_bytes = sum(c.element_size() for c in cols)
    sectors = nv * len(cols) * 32
    r.update(
        fill_ms=median_ms(torch, lambda: k2.compact_cuda(keep, *cols, fills=K2_FILLS)),
        fill_plain_ms=median_ms(torch, lambda: k2.compact_plain(keep, *cols, fills=K2_FILLS)),
        three_step_ms=median_ms(torch, three_step),
        # ... and write every row of every column
        fill_bound_ms=bound_ms(k2.launch_bytes(rows, nv, row_bytes, fill=True)),
        fill_sector_floor_ms=bound_ms(rows + sectors + rows * row_bytes),
    )
    print_kernel(f"compact ({label})", r)
    print(f"[kernels] compact ({label}) with fill: exact; kernel {r['fill_ms']:.3f} ms, "
          f"plain {r['fill_plain_ms']:.3f} ms, K2 + zero + sentinel passes "
          f"{r['three_step_ms']:.3f} ms, bound {r['fill_bound_ms']:.3f} ms, sector floor "
          f"{r['fill_sector_floor_ms']:.3f} ms; without fill: sector floor "
          f"{r['sector_floor_ms']:.3f} ms")
    return r


def print_kernel(name, r):
    lib = (f", library {r['library_ms']:.3f} ms ({r['library_shape']})"
           if r.get("library_ms") is not None else "")
    print(f"[kernels] {name}: {r['shape']}: exact (max_abs_err {r['max_abs_err']}); "
          f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.3f} ms{lib}")


def phase_small_slice(torch, rs, tag="small", block_positions=None):
    """The slice on CUDA vs the CPU plain path: identical outputs (table,
    every BaseGraph array, ReadPaths[:n_reads], paths.npz and ebcx.npz).
    block_positions, when given, pins both devices' block budgets
    (fixed_blocks) so that both take the blocked count and the blocked
    pather."""
    import contextlib

    import numpy as np
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.pipeline.run import Pipeline

    outs, records = {}, {}
    with fixed_blocks(block_positions) if block_positions else contextlib.nullcontext():
        with tempfile.TemporaryDirectory() as d:
            for dev in ("cuda", "cpu"):
                pl = Pipeline(f"{d}/{dev}", device=dev)
                table, bg, rp = pl.run_slice(rs)
                records[dev] = pl.stage_records
                npz = {name: dict(np.load(f"{d}/{dev}/{name}"))
                       for name in ("paths.npz", "ebcx.npz")}
                outs[dev] = (convert.table_to_numpy(table), bg, convert.readpaths_to_numpy(rp),
                             npz, {k: pl.stats.get(k) for k in PATHS_STATS})
    (tg, bgg, rg, zg, sg), (tc, bgc, rc, zc, sc) = outs["cuda"], outs["cpu"]
    check(tg.n_valid == tc.n_valid, f"{tag} slice: n_valid differs")
    for f in ("count", "nbc", "left_mask", "right_mask"):
        check(np.array_equal(getattr(tg, f), getattr(tc, f)), f"{tag} slice: table {f}")
    for i in range(3):
        check(np.array_equal(tg.words[i], tc.words[i]), f"{tag} slice: table word {i}")
    for f in ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos"):
        check(np.array_equal(getattr(bgg, f), getattr(bgc, f)), f"{tag} slice: graph {f}")
    check(np.array_equal(bgg.edges.values, bgc.edges.values), f"{tag} slice: edge codes")
    check(np.array_equal(bgg.edges.offsets, bgc.edges.offsets), f"{tag} slice: edge offsets")
    check(bgg.n_vertices == bgc.n_vertices, f"{tag} slice: n_vertices")
    n = rs.n_reads
    for f in rg._fields:
        check(np.array_equal(getattr(rg, f)[:n], getattr(rc, f)[:n]), f"{tag} slice: paths {f}")
    for name in zc:
        check(zg[name].keys() == zc[name].keys(), f"{tag} slice: {name} arrays differ")
        for k in zc[name]:
            check(zg[name][k].dtype == zc[name][k].dtype
                  and np.array_equal(zg[name][k], zc[name][k]), f"{tag} slice: {name} {k}")
    check(sg == sc, f"{tag} slice: paths stats {sg} vs {sc}")
    if block_positions:
        for st in ("count", "paths"):
            nblk = records["cuda"][st].get("blocks", 1)
            check(nblk >= 2, f"{tag} slice: {st} took {nblk} block(s), not the blocked path")
    blocks = (f", {records['cuda']['count']['blocks']} count / "
              f"{records['cuda']['paths']['blocks']} paths blocks" if block_positions else "")
    print(f"[{tag}] {n} reads, {int(rs.offsets[-1])} bases: kmers {tg.n_valid}, edges "
          f"{bgg.n_edges}{blocks}, {sg}: CUDA == CPU (table, graph, paths, paths.npz, ebcx.npz)")


# the paths stage's stats, in the reference's logging order
PATHS_STATS = ("paths_rescued", "paths_extended", "placed_perc")


def check_fasta(path, tag, alphabet="ACGT"):
    """A FASTA file (assembly.raw.fasta.gz by default): nonempty records of
    `alphabet` only -> (records, bases, N50 of the record lengths)."""
    from supernova_tpu_torch.out import fasta as fout
    from supernova_tpu_torch.stats.logger import n50

    recs = fout.read_fasta(path)
    check(recs, f"{tag}: no FASTA records")
    lens = [len(seq) for _, seq in recs]
    check(min(lens) > 0, f"{tag}: an empty FASTA record")
    check(set("".join(seq for _, seq in recs)) <= set(alphabet),
          f"{tag}: FASTA holds letters outside {alphabet}")
    return len(recs), sum(lens), n50(lens)


def phase_slice(torch, rs, tag, outdir, min_blocks=None):
    """The slice through Pipeline(device="cuda").run() with the launch
    counters reset just before and read just after: the FASTA, summary.json
    and the npz files written and checked; the table is kmers.npz reloaded
    by a resumed Pipeline.  Returns (launches, count stage record, host
    table, BaseGraph, Pipeline)."""
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.core import kmer_codec as kc
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline.run import Pipeline

    kernels.reset_launch_counts()
    pl = Pipeline(outdir, device="cuda")
    bg, fasta = pl.run(rs)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    files = {name: os.path.getsize(f"{outdir}/{name}")
             for name in ("paths.npz", "ebcx.npz", "summary.json", "assembly.raw.fasta.gz")
             if os.path.exists(f"{outdir}/{name}")}
    for name, rec in pl.stage_records.items():
        print(f"[{tag}] stage {name}: wall {rec['wall_s']:.3f} s, "
              f"peak device memory {rec['peak_gb']:.3f} GiB, mem_peak_host_{name}_gb "
              f"{pl.stats.get(f'mem_peak_host_{name}_gb')}")
        check(rec["host_peak_gb"] > 0, f"{tag}: stage {name} logged no host peak")
    crec, prec = pl.stage_records["count"], pl.stage_records["paths"]
    spilled = (f"{crec['block_rows']} raw rows spilled; merged {crec['raw_rows']} raw rows in "
               f"{crec['partitions']} device merge(s)" if "raw_rows" in crec
               else "one block: nothing spilled or merged")
    print(f"[{tag}] count: {crec['blocks']} block(s) at {crec['block_positions']} positions, "
          f"{spilled}; OOM retries {crec.get('oom_retries', 0)}; stage peak "
          f"{crec['peak_gb']:.3f} GiB")
    print(f"[{tag}] paths: {prec['blocks']} block(s) at {prec['block_positions']} positions; "
          f"OOM retries {prec.get('oom_retries', 0)}; stage peak {prec['peak_gb']:.3f} GiB")
    if min_blocks is not None:
        check(crec["blocks"] >= min_blocks, f"{crec['blocks']} count blocks < {min_blocks}")
    kd, ne, placed = (pl.stats.get(k) for k in ("kmers_distinct", "n_edges", "placed_perc"))
    print(f"[{tag}] reads {rs.n_reads}, bases {int(rs.offsets[-1])}: kmers_distinct {kd}, "
          f"n_edges {ne}, placed_perc {placed:.3f}, est_coverage {pl.stats.get('est_coverage')}")
    print(f"[{tag}] paths: rescued {pl.stats.get('paths_rescued')} reads in "
          f"{prec['rescue_s']:.3f} s (host), extended {pl.stats.get('paths_extended')} in "
          f"{prec['extend_s']:.3f} s (host); written {files} (bytes)")
    nrec, nbases, ctg_n50 = check_fasta(fasta, tag)
    print(f"[{tag}] assembly.raw.fasta.gz: {nrec} records, {nbases} bases, contig N50 {ctg_n50}")
    print(f"[{tag}] launches {launches}")
    check(placed >= 95.0, f"placed_perc {placed} < 95")
    check(len(files) == 4, f"{tag}: written {sorted(files)}")
    table = Pipeline(outdir, device="cuda", resume=True).stage_count(rs)
    n = int(table.n_valid)
    check(n == kd, f"{tag}: kmers.npz holds {n} kmers, the count logged {kd}")
    w = table.words
    head, tail = kc.W3(w.a[: n - 1], w.b[: n - 1], w.c[: n - 1]), kc.W3(w.a[1:n], w.b[1:n], w.c[1:n])
    check(bool(kc.lex_lt(head, tail).all()), "table not strictly ascending over n_valid")
    bg.validate()
    print(f"[{tag}] BaseGraph.validate() passed; table (kmers.npz reloaded) strictly "
          f"ascending over {n} rows")
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the main path")
    return launches, crec, convert.table_to_numpy(table), bg, pl


MESH_SHARDS = 4  # virtual shards, all on cuda:0 on a one-card host
FM_QUERIES = 1_000_000  # [fmindex]: patterns on the card
FM_CPU_QUERIES = 10_000  # of them, again on CPU tensors
FM_HOST_QUERIES = 1_000  # ... through FMIndex.count
FM_LOCATE = 100  # ... through locate and a brute-force search


def mesh_kernels(torch, mesh, inputs, res):
    """K1-K4 against their twins at one shard's shapes (shard 0 of the
    4-shard count: its read block's codes, then the occurrence rows the
    exchange gave it, sorted, reduced and compacted); adds a mesh_* entry
    to each kernel of `res`."""
    from supernova_tpu_torch.core.kmer_codec import W3
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3
    from supernova_tpu_torch.parallel import sharded_count as psc

    codes, n = inputs[0]["codes_ext"], inputs[0]["pos_read"].shape[0]
    got, ref = k1.sliding_words_cuda(codes, n), k1.sliding_words_plain(codes, n)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "mesh: K1 differs from plain")
    res["kmer_extract"]["mesh"] = dict(
        shape=f"{n} positions (shard 0 of {MESH_SHARDS})",
        max_abs_err=max_abs_err(torch, zip(got, ref)),
        ms=median_ms(torch, lambda: k1.sliding_words_cuda(codes, n)),
        plain_ms=median_ms(torch, lambda: k1.sliding_words_plain(codes, n)),
        bound_ms=bound_ms(k1.launch_bytes(codes.numel(), n)))
    print_kernel("kmer_extract (mesh shard)", res["kmer_extract"]["mesh"])
    del got, ref
    cols, keys = [], []
    for inp in inputs:
        rows, valid = psc._occurrences(inp)
        cols.append(rows)
        keys.append(torch.where(valid, psc.kmer_shard_hash(W3(*rows[:, :3].T)) % mesh.size,
                                mesh.size))
    recv = mesh.exchange(cols, keys, mesh.size)[0][0]
    del cols, keys
    keys4 = [recv[:, j].contiguous() for j in range(4)]
    rows = keys4[0].shape[0]
    r, perm = check_sort(torch, keys4, f"{rows} rows x 4 keys (shard 0's received rows)")
    res["sort"]["mesh"] = {k: r[k] for k in COMMON_KEYS + ("shape", "library_shape")}
    ws = [k[perm] for k in keys4]
    mf, mb = kcount.MIN_FREQ, kcount.MIN_BC
    got = k3.run_reduce_cuda(*ws, mf, mb)
    ref = k3.run_reduce_plain(*ws, mf, mb)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "mesh: K3 differs from plain")
    res["run_reduce"]["mesh"] = dict(
        shape=f"{rows} rows (shard 0)", max_abs_err=max_abs_err(torch, zip(got, ref)),
        ms=median_ms(torch, lambda: k3.run_reduce_cuda(*ws, mf, mb)),
        plain_ms=median_ms(torch, lambda: k3.run_reduce_plain(*ws, mf, mb)),
        bound_ms=bound_ms(k3.launch_bytes(rows)), library_ms=None)
    print_kernel("run_reduce (mesh shard)", res["run_reduce"]["mesh"])
    keep, count, stats = got
    r, _ = compact_kept(torch, keep, (ws[0], ws[1], ws[2], count, stats), "mesh shard 0")
    res["compact"]["mesh"] = {k: r[k] for k in COMMON_KEYS + ("shape", "library_shape")}
    print_kernel("compact (mesh shard)", res["compact"]["mesh"])


def phase_mesh(torch, rs, bg, dev, smi, res):
    """The multi-shard layer on the full slice over MESH_SHARDS virtual
    shards on one card, the launch counters set to 0 just before the mesh
    calls and read just after: sharded_count (4 shards) and
    sharded_count_hier ((2, 2)), each shard's table equal to the
    single-device table's rows of that shard's hash and the merged table
    equal to it, overflow 0; sharded_build_graph equal to the Pipeline's
    BaseGraph array for array; the Pipeline's mesh pather with the
    dictionary replicated and value-sharded (PATH_VS_DICT_ROWS forced to
    0), ReadPaths[:n_reads] equal to path_readset's; then
    Pipeline(multi_device=(1, 4)).run() on the 8 kb slice equal to the
    single-device run (FASTA, npz files, summary.json), n_shards and
    n_shards_path 4, no overflow recount.  Every kernel must launch inside
    the mesh calls.  Walls on the host clock, each ending in a sync; the
    shards are virtual shards on one card, not a scaling number.  Returns
    the launches."""
    import numpy as np
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.dbg import build as dbuild
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.parallel import mesh as pmesh
    from supernova_tpu_torch.parallel import sharded_build as psb
    from supernova_tpu_torch.parallel import sharded_count as psc
    from supernova_tpu_torch.pipeline import datasets
    from supernova_tpu_torch.pipeline import run as prun

    inp = kcount.prepare_reads(rs, dev)
    single = dbuild.trim_table(kcount.count_kmers(
        inp["codes_ext"], inp["pos_read"], inp["glen_pos"], inp["bc_pos"],
        uniform_rl=inp["uniform_rl"]))
    del inp
    n = int(single.n_valid)
    owner = (psc.kmer_shard_hash(type(single.words)(*(w[:n] for w in single.words)))
             % MESH_SHARDS).cpu().numpy()
    want = convert.table_to_numpy(single)
    rp_single = convert.readpaths_to_numpy(pather.path_readset(bg, rs, dev))
    del single
    torch.cuda.empty_cache()
    fields = ("count", "nbc", "left_mask", "right_mask")

    def same_rows(t, sel, label):
        h = convert.table_to_numpy(t)
        m = h.n_valid
        check(m == int(sel.sum()), f"mesh: {label}: {m} kmers, not {int(sel.sum())}")
        for j in range(3):
            check(np.array_equal(h.words[j][:m], want.words[j][:n][sel]), f"mesh: {label} words")
        for f in fields:
            check(np.array_equal(getattr(h, f)[:m], getattr(want, f)[:n][sel]), f"mesh: {label} {f}")

    walls = {}

    def timed_call(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    # the 8 kb single-device run, outside the launch window
    d = tempfile.mkdtemp()
    rs_small = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    pl1 = prun.Pipeline(f"{d}/single", device=dev, multi_device=False)
    fa1 = fasta_bytes(pl1.run(rs_small)[1])

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mesh = pmesh.make_mesh(MESH_SHARDS, dev)
    inputs, nbl = psc.split_readset(rs, mesh)
    tables, ovf = timed_call("sharded_count", lambda: psc.sharded_count(mesh, inputs, 4 * nbl))
    check(sum(ovf) == 0, f"mesh: sharded_count overflow {ovf}")
    for s, t in enumerate(tables):
        same_rows(t, owner == s, f"shard {s} of sharded_count")
    merged = psc.merge_shard_tables(tables, dev)
    same_rows(merged, np.ones(n, bool), "merge_shard_tables")
    del merged
    mesh2 = pmesh.make_mesh2(2, MESH_SHARDS // 2, dev)
    inputs2, _ = psc.split_readset(rs, mesh2)
    tables2, ovf2 = timed_call("sharded_count_hier",
                               lambda: psc.sharded_count_hier(mesh2, inputs2, 4 * nbl))
    check(sum(ovf2) == 0, f"mesh: sharded_count_hier overflow {ovf2}")
    for s, t in enumerate(tables2):
        same_rows(t, owner == s, f"shard {s} of sharded_count_hier")
    del tables2, inputs2
    count_peak = torch.cuda.max_memory_allocated() / 2**30
    count_launches = kernels.launch_counts()
    mesh_kernels(torch, mesh, inputs, res)
    del inputs
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()  # the comparisons' launches do not count
    torch.cuda.reset_peak_memory_stats()
    bg_m = timed_call("sharded_build_graph", lambda: psb.sharded_build_graph(mesh, tables, dev))
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    del tables
    for f in ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos"):
        a, b = getattr(bg_m, f), getattr(bg, f)
        check(a.dtype == b.dtype and np.array_equal(a, b), f"mesh: sharded build {f} differs")
    check(np.array_equal(bg_m.edges.values, bg.edges.values)
          and np.array_equal(bg_m.edges.offsets, bg.edges.offsets), "mesh: sharded build edges")
    check(bg_m.n_vertices == bg.n_vertices, "mesh: sharded build n_vertices")
    try:
        pl = prun.Pipeline(f"{d}/paths", device=dev, multi_device=(1, MESH_SHARDS))
        saved = prun.PATH_VS_DICT_ROWS
        for vs in (False, True):
            prun.PATH_VS_DICT_ROWS = 0 if vs else saved
            try:
                rp = timed_call("sharded_path_vs" if vs else "sharded_path",
                                lambda: pl._path_sharded(bg, rs, MESH_SHARDS))
            finally:
                prun.PATH_VS_DICT_ROWS = saved
            check(pl.stats.get("path_dict_sharded") == int(vs), "mesh: wrong dictionary layout")
            got = convert.readpaths_to_numpy(rp)
            for f in got._fields:
                check(np.array_equal(getattr(got, f), getattr(rp_single, f)[: rs.n_reads]),
                      f"mesh: {'value-sharded' if vs else 'replicated'} pather {f} differs")
            del rp, got
        torch.cuda.empty_cache()

        pl4 = prun.Pipeline(f"{d}/mesh", device=dev, multi_device=(1, MESH_SHARDS))
        fa4 = fasta_bytes(timed_call("Pipeline((1, 4)).run 8 kb", lambda: pl4.run(rs_small))[1])
        check(fa4 == fa1, "mesh: Pipeline((1, 4)).run() FASTA differs from the single device's")
        for name in ("kmers.npz", "graph.npz", "paths.npz", "ebcx.npz"):
            za, zb = np.load(f"{d}/single/{name}"), np.load(f"{d}/mesh/{name}")
            check(sorted(za.files) == sorted(zb.files)
                  and all(np.array_equal(za[k], zb[k]) for k in za.files),
                  f"mesh: Pipeline((1, 4)).run() {name} differs")
        summ = [{k: v for k, v in json.loads(Path(d, t, "summary.json").read_text()).items()
                 if not k.startswith(("etime_", "mem_"))} for t in ("single", "mesh")]
        check(summ[0] == summ[1], "mesh: Pipeline((1, 4)).run() summary.json differs")
        crec = pl4.stage_records["count"]
        check((pl4.stats.get("n_shards"), pl4.stats.get("n_shards_path")) == (4, 4)
              and crec.get("count_route") == "mesh" and crec.get("count_overflow") == 0,
              f"mesh: Pipeline((1, 4)).run() took n_shards {pl4.stats.get('n_shards')}, "
              f"n_shards_path {pl4.stats.get('n_shards_path')}, route {crec.get('count_route')}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    launches = {k: v + count_launches[k] for k, v in kernels.launch_counts().items()}
    print(f"[mesh] {smi}: {MESH_SHARDS} VIRTUAL shards on one card (not a scaling number); "
          f"full slice {rs.n_reads} reads, {n} kmers; walls (host clock, synchronized): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    print(f"[mesh] sharded counts: every shard's table == the single-device table's rows of "
          f"its hash (shards {np.bincount(owner, minlength=MESH_SHARDS).tolist()} kmers), merged "
          f"== single, overflow 0, peak device memory {count_peak:.3f} GiB; sharded build == "
          f"the Pipeline's BaseGraph ({bg.n_edges} edges), peak {build_peak:.3f} GiB; mesh "
          f"pather (replicated, value-sharded) == path_readset; Pipeline((1, 4)).run() on 8 kb "
          f"== single device, n_shards 4, n_shards_path 4, count_route mesh")
    print(f"[mesh] launches {launches}")
    for name, c in launches.items():
        check(c > 0, f"mesh: kernel {name} was not launched on the mesh path")
    return launches


def phase_mesh_glue(torch, dev, sg, rs, outdir, smi):
    """glue_closures_sharded over MESH_SHARDS virtual shards on the card, on
    the genome's glue inputs (the closures stage_supergraph glued): the
    partition of the one-device glue (glue_closures_device on the card),
    overflow 0."""
    import numpy as np
    from supernova_tpu_torch.asm import nucleate as anuc
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.parallel import device_nucleate as dn
    from supernova_tpu_torch.parallel import mesh as pmesh
    from supernova_tpu_torch.parallel import sharded_nucleate as psn

    _, cls = glue_inputs(sg["bg"], sg["rp"], rs, outdir)
    info = {}
    want = dn.glue_closures_device(sg["bg"], cls, anuc.MIN_OVER_BASES, True, dev, info=info)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, ovf = psn.glue_closures_sharded(pmesh.make_mesh(MESH_SHARDS, dev), sg["bg"], cls,
                                         anuc.MIN_OVER_BASES, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(ovf == 0, f"mesh glue: overflow {ovf}")

    def canon(labels):
        first = {}
        return [first.setdefault(int(x), i) for i, x in enumerate(labels)]

    check(len(got) == len(want) and canon(got) == canon(want),
          "mesh glue: the partition differs from the one-device glue's")
    for name in ("sort", "compact"):
        check(launches[name] > 0, f"mesh glue: {name} was not launched")
    print(f"[mesh glue] {smi}: glue_closures_sharded over {MESH_SHARDS} VIRTUAL shards on one "
          f"card == glue_closures_device's partition ({len(got)} boundaries, "
          f"{len(np.unique(got))} classes, P {info['positions']}), overflow 0; {wall:.3f} s "
          f"(host clock); launches {launches}")
    return launches


# 10x lanes the genome's FASTQs are written as, one process each
LANES = 8


def phase_fleet(torch, smi):
    """[fleet]: on a host of two or more cards, `python -m
    supernova_tpu_torch.stats.fleet --dataset FULL --locals 1` in a fresh
    process: the full slice's count, graph, paths, patch and supergraph on
    one card, then over a fleet of 2 processes x 1 card joined over NCCL
    (the count's exchange, the build over the fleet's shard tables, the
    pather and the closure glue over its flat mesh crossing the processes),
    every process's checkpoints equal to the one card's; its exit code and
    last line checked.  On one card, one line saying it was not run and
    why."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[fleet] not run: this host has {cards} card and NCCL needs one card per "
              "process, so the 2 x 1 fleet needs two (tests/test_torch_multiprocess.py's "
              "NCCL tests and stats/fleet.py run it on a 4-card host)")
        return
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, "-m", "supernova_tpu_torch.stats.fleet", "--out", d,
                              "--dataset", "FULL", "--locals", "1"],
                             capture_output=True, text=True, timeout=900)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    check(out.returncode == 0 and lines and lines[-1].get("ok"),
          f"fleet: exit {out.returncode}: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    last = lines[-1]
    check({"kmers.npz", "graph.npz", "paths.npz", "supergraph.npz"} <= set(last["files"])
          and len(last["equal"]) == 2 * len(last["files"]) and all(last["equal"].values()),
          f"fleet: outputs differ from one card's: {last['equal']}")
    for x in lines:
        if "stage" in x and x["stage"] != "ingest":
            print(f"[fleet] {smi}: {x['role']} {x['stage']} {x['wall_s']:.3f} s, card peaks "
                  f"{x['card_peak_gib']} GiB, {x['rows_out']} rows sent to the other process")
    print(f"[fleet] 2 processes x 1 card over NCCL: {', '.join(last['files'])} equal to one "
          "card's on both processes")


def _simulate_and_write(root):
    """The genome's reads simulated and written as LANES lanes of FASTQs
    under root/fastqs, its whitelist to root/whitelist.npy and the walls to
    root/simulate.json (run in a process of its own while the main process
    runs the phases before [fastq run])."""
    import numpy as np
    from supernova_tpu_torch.pipeline import datasets
    from supernova_tpu_torch.stats.rung import write_lanes

    t0 = time.perf_counter()
    reads, wl = datasets.simulate_reads(datasets.GENOME, datasets.GENOME_SEED)
    sim_s = time.perf_counter() - t0
    n_pairs = reads.n_pairs()
    t0 = time.perf_counter()
    write_lanes(reads, f"{root}/fastqs", "GENOME", LANES)
    np.save(f"{root}/whitelist.npy", wl)
    Path(root, "simulate.json").write_text(json.dumps(
        {"pairs": n_pairs, "simulate_s": sim_s, "write_s": time.perf_counter() - t0}))


def start_fastq_writer(root):
    """Start _simulate_and_write(root) in a forked process (it touches no
    CUDA state, as the lane writers do not) -> the process."""
    import multiprocessing

    proc = multiprocessing.get_context("fork").Process(target=_simulate_and_write, args=(root,))
    proc.start()
    return proc


def fasta_bytes(path):
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()


def phase_fastq_run(torch, dev, outdir, writer):
    """The genome from 10x FASTQs (simulated and written by `writer`, the
    process start_fastq_writer(outdir) started) through the port's own
    ingest, then Pipeline(device="cuda").run() and stage_patch: the main
    path.  Returns (launches of run() + stage_patch, count record, host
    table, BaseGraph, ReadSet, the patch stage's record)."""
    import numpy as np
    from supernova_tpu_torch.ingest.barcodes import Whitelist
    from supernova_tpu_torch.ingest.discovery import discover_input_fastqs
    from supernova_tpu_torch.ingest.tenx import ingest_10x_fastqs
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline.preflight import preflight
    from supernova_tpu_torch.pipeline.run import Pipeline

    t0 = time.perf_counter()
    writer.join()
    check(writer.exitcode == 0, f"fastq run: the FASTQ writer exited {writer.exitcode}")
    wait_s = time.perf_counter() - t0
    sim = json.loads(Path(outdir, "simulate.json").read_text())
    wl = np.load(f"{outdir}/whitelist.npy")
    write_s = sim["write_s"]
    print(f"[fastq run] genome: {sim['pairs']} read pairs simulated in {sim['simulate_s']:.1f} s "
          f"in a process of its own, beside the earlier phases (waited {wait_s:.1f} s for it)")
    fq = f"{outdir}/fastqs"
    size = sum(os.path.getsize(f"{fq}/{f}") for f in os.listdir(fq) if f.endswith(".gz"))
    t0 = time.perf_counter()
    found = discover_input_fastqs(fq)
    check(found["mode"] == "ILMN_BCL2FASTQ" and len(found["r1"]) == LANES,
          f"fastq run: discovery found {found['mode']}, {len(found['r1'])} R1 files")
    pf = preflight(found["r1"], found["r2"], len(wl))
    check(pf.ok, f"fastq run: preflight errors {pf.errors}")
    rs = ingest_10x_fastqs(found["r1"], found["r2"], Whitelist.from_codes(wl))
    ingest_s = time.perf_counter() - t0
    lens = rs.lengths()
    print(f"[fastq run] FASTQs: {LANES} lanes, {size} bytes gzipped, written in {write_s:.3f} s "
          f"({LANES} processes); discovery + preflight (warnings {pf.warnings}) + "
          f"ingest_10x_fastqs {ingest_s:.3f} s -> {rs.n_reads} reads, {int(rs.offsets[-1])} "
          f"bases, R1 {int(lens[0::2].min())}-{int(lens[0::2].max())} bases, R2 "
          f"{int(lens[1::2].min())}-{int(lens[1::2].max())} bases, "
          f"{100 * float((rs.bc > 0).mean()):.3f}% of reads on a whitelist barcode")
    shutil.rmtree(fq)
    asm = f"{outdir}/asm"
    launches, crec, table, bg, pl = phase_slice(torch, rs, "fastq run", asm)
    # the main path plans its blocks from the card: neither stage took the
    # reference's fixed 96M positions (phase 7 holds its table to those)
    prec = pl.stage_records["paths"]
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.kmer import count as kcount

    print(f"[fastq run] block budgets from the card: count {crec['block_positions']} positions "
          f"(free bytes / COUNT_BYTES_PER_POSITION {kcount.COUNT_BYTES_PER_POSITION}), paths "
          f"{prec['block_positions']} (beside the {bg.kmer_words.shape[0]}-row dictionary at "
          f"PATH_BYTES_PER_DICT_ROW {pather.PATH_BYTES_PER_DICT_ROW}, at "
          f"PATH_BYTES_PER_POSITION {pather.PATH_BYTES_PER_POSITION}); the reference's block "
          f"{kcount.BLOCK_POSITIONS}")
    for name, r in (("count", crec), ("paths", prec)):
        check(r.get("oom_retries", 0) == 0, f"fastq run: the {name} ran out of memory at the "
              "block its budget planned")
        check(r["block_positions"] != kcount.BLOCK_POSITIONS
              and r["block_positions"] % kcount.BLOCK_QUANTUM == 0,
              f"fastq run: the {name} planned {r['block_positions']}-position blocks")

    # the pather's output for stage_patch: paths.npz, reused by a resumed
    # Pipeline (same reads, same graph), with no launch
    kernels.reset_launch_counts()
    rp = Pipeline(asm, device="cuda", resume=True).stage_paths(bg, rs)
    check(sum(kernels.launch_counts().values()) == 0, "fastq run: paths.npz was not reused")
    kernels.reset_launch_counts()
    bg2, rp2 = pl._timed("patch", pl.stage_patch, bg, rp, rs)
    torch.cuda.synchronize()
    patch_launches = kernels.launch_counts()
    rec = pl.stage_records["patch"]
    pairs, closed = pl.stats.get("gap_pairs"), pl.stats.get("gap_closures")
    print(f"[fastq run] stage patch: wall {rec['wall_s']:.3f} s, peak device memory "
          f"{rec['peak_gb']:.3f} GiB, mem_peak_host_patch_gb "
          f"{pl.stats.get('mem_peak_host_patch_gb')}; gap_pairs {pairs}, gap_closures {closed}; find "
          f"{pl.stats.get('etime_patch_find_s'):.3f} s, close "
          f"{pl.stats.get('etime_patch_close_s'):.3f} s, rebuild "
          f"{pl.stats.get('etime_patch_rebuild_s')} s, re-path "
          f"{pl.stats.get('etime_patch_repath_s')} s (host clock)")
    if closed:
        bg2.validate()
        placed = pl.stats.get("placed_perc")
        print(f"[fastq run] patched graph: {bg2.n_edges} edges (was {bg.n_edges}); re-path "
              f"placed_perc {placed:.3f}; rebuild launches {rec['rebuild_launches']}; the "
              f"stage's {patch_launches}")
        check(os.path.exists(f"{asm}/graph.patched.npz") and os.path.exists(f"{asm}/closures.npz"),
              "fastq run: graph.patched.npz / closures.npz not written")
        for name, c in rec["rebuild_launches"].items():
            check(c > 0, f"kernel {name} was not launched by the patch rebuild")
        check(placed >= 95.0, f"re-path placed_perc {placed} < 95")
    else:
        print("[fastq run] nothing closed: the patch stage returned its inputs, no rebuild")
    sg = phase_supergraph(torch, pl, bg2, rp2, rs)
    total = {k: launches[k] + patch_launches[k] + sg["launches"][k] for k in launches}
    return total, crec, table, bg, rs, rec, sg


def same_supergraph(want, got, label):
    """Two SuperGraphs with the same edges, involution and vertices."""
    import numpy as np

    for f in ("dinv", "from_v", "to_v"):
        check(np.array_equal(getattr(want, f), getattr(got, f)), f"{label}: D {f} differs")
    check(np.array_equal(want.epaths.values, got.epaths.values)
          and np.array_equal(want.epaths.offsets, got.epaths.offsets),
          f"{label}: D epaths differ")
    check(want.n_vertices == got.n_vertices, f"{label}: D n_vertices differs")


def lines_key(lines):
    """A line decomposition as nested tuples (cells' paths, line_of_edge,
    linv)."""
    return (tuple(tuple(tuple(tuple(int(e) for e in q) for q in cell.paths)
                        for cell in line.elements) for line in lines.lines),
            tuple(int(x) for x in lines.line_of_edge), tuple(int(x) for x in lines.linv))


def phase_supergraph(torch, pl, bg, rp, rs):
    """stage_supergraph on the patched graph and its paths, on the card,
    the launch counters set to 0 just before and read just after: the
    closure glue must take the device route with no budget overflow and
    launch K4 and K2.  Returns the patched graph, its paths (on the host),
    D, the lines, the stage's launches, its record and the stats getter."""
    from supernova_tpu_torch.ops import kernels

    asm = pl.outdir
    kernels.reset_launch_counts()
    D, lines, _ = pl._timed("supergraph", pl.stage_supergraph, bg, rp, rs)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    rec = pl.stage_records["supergraph"]
    st = pl.stats.get
    print(f"[supergraph] stage_supergraph: wall {rec['wall_s']:.3f} s, peak device memory "
          f"{rec['peak_gb']:.3f} GiB, mem_peak_host_supergraph_gb "
          f"{st('mem_peak_host_supergraph_gb')}; glue_route {rec.get('glue_route')}, closure "
          f"positions P {rec.get('glue_positions')}, overflow (candidates, long pairs, union pairs) "
          f"{rec.get('glue_overflow')}; launches {launches}")
    print(f"[supergraph] n_closures {st('n_closures')}, closures_trimmed "
          f"{st('closures_trimmed')}, supergraph_mode {st('supergraph_mode')}, "
          f"super_edges_cleaned {st('super_edges_cleaned')}, n_pullaparts "
          f"{st('n_pullaparts')}, n_decycled {st('n_decycled')}, n_loops_captured "
          f"{st('n_loops_captured')}, n_messy_loops_captured {st('n_messy_loops_captured')}; "
          f"n_super_edges {st('n_super_edges')}, n_lines {st('n_lines')}, n_lines_after_break "
          f"{st('n_lines_after_break')}; lw_mean_mol_len {st('lw_mean_mol_len')}, dup_frac "
          f"{st('dup_frac')}, median_ins_sz {st('median_ins_sz')}")
    check(rec.get("glue_route") == "device",
          f"supergraph: the closure glue took route {rec.get('glue_route')}, not the device")
    check(tuple(rec["glue_overflow"]) == (0, 0, 0),
          f"supergraph: glue budget overflow {rec['glue_overflow']}")
    for name in ("sort", "compact"):
        check(launches[name] > 0, f"supergraph: kernel {name} was not launched by the stage")
    for name in ("cpaths.npz", "dpaths.npz", "supergraph.npz", "stats/histogram_molecules.json"):
        check(os.path.exists(f"{asm}/{name}"), f"supergraph: {name} not written")
    check(lines.n_lines > 0 and st("n_lines_after_break") >= st("n_lines"),
          "supergraph: no lines, or the break lost lines")
    D.validate()
    rp_host = type(rp)(*(x.cpu() for x in rp))
    return dict(bg=bg, rp=rp_host, D=D, lines=lines, launches=launches, rec=rec, stats=st)


def glue_inputs(bg, rp, rs, outdir):
    """The closures the stage glued: cpaths.npz less those on a weak fork
    edge (the stage's trim) -> (closures, sanitized closures)."""
    import numpy as np
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.align import index as pindex
    from supernova_tpu_torch.asm import closures as aclos
    from supernova_tpu_torch.asm import nucleate as anuc
    from supernova_tpu_torch.asm import supergraph as asg

    edges, plen, _ = (x[: rs.n_reads] for x in convert.readpaths_to_numpy(rp)[:3])
    keep_forks = asg.trim_weak_edges(bg, pindex.edge_read_counts(edges, plen, bg.n_edges),
                                     tips=False)
    cl = [c for c in aclos.load_closures(f"{outdir}/cpaths.npz")
          if bool(keep_forks[np.asarray(c, np.int64)].all())]
    return cl, anuc.sanitize_closures(bg, cl)


# the glue's first sorts, in call order; then step 6's one-key sort (the
# adaptive gate's candidates) and the zipper's first 2-key sort
GLUE_SORTS = ("step 1 (edge, closure)", "step 3 (edge, closure, pos)",
              "step 4 (c1, c2, off)")
GLUE_STEP6 = "step 6 gate (over)"
GLUE_ZIPPER = "step 10 zipper (head, edge)"


def phase_glue(torch, dev, sg, rs, outdir, res):
    """The stage's closure glue again, three ways: D through the device
    glue (nucleate_graph's own gate) against D through the host core; the
    labels of glue_closures_device on the card against its plain twin on
    CPU tensors, exactly; and K4 and K2 against their twins at the inputs
    the glue gave them (recorded by wrapping the module's lex_argsort and
    compact), each timed beside its bound and, for the 1- and 2-key sorts,
    a stable torch.sort of the key or the packed pair.  Adds glue_* keys to
    the sort and compact entries of `res`."""
    import numpy as np
    from supernova_tpu_torch.asm import nucleate as anuc
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.parallel import device_nucleate as dn

    bg = sg["bg"]
    cl, cls = glue_inputs(bg, sg["rp"], rs, outdir)
    st = sg["stats"]
    check(len(cl) == st("n_closures") - (st("closures_trimmed") or 0),
          f"glue: {len(cl)} closures rebuilt, not the {st('n_closures')} less "
          f"{st('closures_trimmed')} trimmed that the stage glued")
    info = {}
    t0 = time.perf_counter()
    D_dev = anuc.nucleate_graph(bg, cl, None, device=dev, info=info)
    dev_s = time.perf_counter() - t0
    check(info["glue_route"] == "device", f"glue: route {info['glue_route']}")
    t0 = time.perf_counter()
    D_host = anuc.nucleate_graph(bg, cl, None, device_glue=False)
    host_s = time.perf_counter() - t0
    same_supergraph(D_host, D_dev, "glue: device glue vs host core")
    print(f"[supergraph] D from the device glue == D from the host core: {D_dev.n_edges} "
          f"edges, {D_dev.n_vertices} vertices; nucleate_graph {dev_s:.3f} s through the "
          f"device glue, {host_s:.3f} s through the host core (host clock, _quotient included)")

    calls, kept, compacts = [], [], []

    def sort_spy(*keys):
        calls.append(len(keys))
        labels = [label for label, _ in kept]
        if len(calls) <= len(GLUE_SORTS):
            kept.append((GLUE_SORTS[len(calls) - 1], keys))
        elif len(keys) == 1 and GLUE_STEP6 not in labels:
            kept.append((GLUE_STEP6, keys))
        elif len(keys) == 2 and GLUE_ZIPPER not in labels:
            kept.append((GLUE_ZIPPER, keys))
        return lex_argsort(*keys)

    def compact_spy(valid, *cols, **kw):
        compacts.append((valid, cols))
        return compact(valid, *cols, **kw)

    lex_argsort, compact = dn.lex_argsort, dn.compact
    dn.lex_argsort, dn.compact = sort_spy, compact_spy
    info = {}
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lab_dev = dn.glue_closures_device(bg, cls, anuc.MIN_OVER_BASES, True, dev, info=info)
        torch.cuda.synchronize()
        glue_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        dn.lex_argsort, dn.compact = lex_argsort, compact
    t0 = time.perf_counter()
    lab_cpu = dn.glue_closures_device(bg, cls, anuc.MIN_OVER_BASES, True, "cpu")
    cpu_s = time.perf_counter() - t0
    check(lab_dev is not None and lab_cpu is not None, "glue: a budget overflowed")
    check(info["positions"] == sg["rec"]["glue_positions"],
          f"glue: P {info['positions']} is not the stage's {sg['rec']['glue_positions']}")
    check(np.array_equal(lab_dev, lab_cpu), "glue: labels on the card differ from the CPU twin's")
    n_classes = len(np.unique(lab_dev))
    zips = calls[len(GLUE_SORTS):].count(2) // 2
    check({GLUE_STEP6, GLUE_ZIPPER} <= {label for label, _ in kept},
          f"glue: sorts of {calls} keys: no one-key gate sort or no zipper sort")
    rows = info["rows"]
    per_row = peak / max(sum(rows), 1)
    print(f"[supergraph] glue labels on the card == the plain twin's on the CPU: "
          f"{len(lab_dev)} boundaries, {n_classes} classes; {len(cls)} sanitized closures, "
          f"P {info['positions']}; glue_closures_device {glue_s:.3f} s on the card "
          f"({launches}; sorts of {calls} keys, {zips} zipper rounds), {cpu_s:.3f} s on the "
          f"CPU (host clock)")
    print(f"[supergraph] glue rows: candidates {rows[0]}, long pairs {rows[1]}, union pairs "
          f"{rows[2]} ({rows[2] / info['positions']:.2f} P); peak device memory "
          f"{peak / 2**30:.3f} GiB above its inputs, {per_row:.1f} B a row")
    rows = []
    for label, keys in kept:
        shape = f"{keys[0].shape[0]} rows x {len(keys)} keys (glue {label})"
        r, _ = check_sort(torch, [k.contiguous() for k in keys], shape)
        if len(keys) > 2:  # a 2-key library sort is not the same function
            r["library_ms"] = None
        rows.append({k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "library_ms")})
    res["sort"]["glue"] = rows
    valid, cols = compacts[0]
    r, _ = compact_kept(torch, valid, cols, "glue seeds")
    print_kernel("compact (glue seeds)", r)
    res["compact"]["glue"] = [{k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "library_ms")}]


def phase_resume(torch, rs, outdir, sg):
    """The fastq run's outdir again with resume=True: the count and graph
    stages reload kmers.npz and graph.npz (no launch), the paths stage runs
    no K3 and no K2, and the FASTA's bytes are the same; then
    stage_supergraph on the patched graph (`sg`, phase_supergraph's) re-enters
    from supergraph.npz and dpaths.npz with no launch and returns the same
    D and lines."""
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline.run import Pipeline

    asm = f"{outdir}/asm"
    want = fasta_bytes(f"{asm}/assembly.raw.fasta.gz")
    # run() re-paths the base graph over the patched graph's paths.npz and
    # ebcx.npz; they are put back after it for [scaffold]'s run_full
    patched_paths = {name: Path(asm, name).read_bytes() for name in ("paths.npz", "ebcx.npz")}
    kernels.reset_launch_counts()
    pl = Pipeline(asm, device="cuda", resume=True)
    t0 = time.perf_counter()
    _, fasta = pl.run(rs)
    wall = time.perf_counter() - t0
    for name, data in patched_paths.items():
        Path(asm, name).write_bytes(data)
    for name, rec in pl.stage_records.items():
        print(f"[resume] stage {name}: wall {rec['wall_s']:.3f} s, peak device memory "
              f"{rec['peak_gb']:.3f} GiB, launches {rec['launches']}")
    recs = pl.stage_records
    for st in ("count", "graph"):
        check(sum(recs[st]["launches"].values()) == 0, f"resume: the {st} stage launched kernels")
    for st in ("count", "graph", "paths"):
        for name in ("run_reduce", "compact"):
            check(recs[st]["launches"][name] == 0, f"resume: the {st} stage launched {name}")
    check(fasta_bytes(fasta) == want, "resume: the FASTA differs")
    print(f"[resume] run() {wall:.3f} s: kmers.npz and graph.npz reloaded, no K3 or K2 in the "
          f"count, graph and paths stages; assembly.raw.fasta.gz identical ({len(want)} bytes "
          "decompressed)")
    kernels.reset_launch_counts()
    pl = Pipeline(asm, device="cuda", resume=True)
    D, lines, _ = pl._timed("supergraph", pl.stage_supergraph, sg["bg"], sg["rp"], rs)
    launches = kernels.launch_counts()
    check(sum(launches.values()) == 0, f"resume: stage_supergraph launched {launches}")
    same_supergraph(sg["D"], D, "resume: supergraph")
    check(lines_key(lines) == lines_key(sg["lines"]), "resume: the lines differ")
    rec = pl.stage_records["supergraph"]
    print(f"[resume] stage_supergraph: wall {rec['wall_s']:.3f} s, no launch: supergraph.npz "
          f"and dpaths.npz reloaded, the same D ({D.n_edges} edges) and {lines.n_lines} lines "
          f"(the break and the molecules recomputed on the host)")


FLAVOR_FILES = ("assembly.raw.fasta.gz", "assembly.megabubbles.fasta.gz",
                "assembly.pseudohap.fasta.gz", "assembly.pseudohap2.fasta.gz")
RUN_FULL_FILES = ("graph.gfa.gz", "supergraph.gfa.gz", "assembly_state.pkl", "summary.json",
                  "stats/histogram_contig.json", "stats/histogram_scaffold.json",
                  "stats/histogram_edge.json", "stats/histogram_phase_block.json",
                  "stats/histogram_reads_per_barcode.json", "final/a.sup.lines.npz")


def gib(x):
    """A stage record's peak (None off CUDA) for printing."""
    return "n/a" if x is None else f"{x:.3f}"


def haplotype_share(fasta, strands, min_len=400):
    """The pseudohap contigs (records split at N) longer than min_len, and
    how many are exact substrings of one of `strands`."""
    from supernova_tpu_torch.out import fasta as fout

    contigs = [c for _, seq in fout.read_fasta(fasta) for c in seq.split("N")
               if len(c) > min_len]
    return len(contigs), sum(any(c in s for s in strands) for c in contigs)


def phase_scaffold(torch, dev, outdir):
    """`run --resume --out <the fastq run's outdir> --device cuda` through
    the command line (cli.main, in this process), which loads reads.npz and
    calls run_full with resume=True: the count and graph stages reload
    their checkpoints and launch nothing, the paths stage is skipped, the
    patch and supergraph stages re-enter from their checkpoints with no
    launch, and the scaffold stage runs its phases on the genome (each
    snapshotted), then phasing and the het DP on the card (held to the same
    DP on CPU tensors on the genome's own bubble pairs); the four FASTA
    flavors (A/C/G/T/N only), the GFA files, the super files, the
    histograms and summary.json are written; the CLI exits 0, printed
    summary.json, marked every stage it ran complete in pipestance.json and
    wrote the .mri.tgz bundle.  Prints each phase's wall, each stage's
    pipestance.json record and the share of pseudohap contigs (split at N,
    > 400 bp) that are exact substrings of a simulated haplotype strand.
    Returns `python -m supernova_tpu_torch evaluate` of the pseudohap FASTA
    against the genome's haplotypes, started in the background.  (A resumed
    run re-entering after the last phase is checked on the star-gap
    fixture in [small run_full]: the genome takes the legacy scaffolder,
    after which a resumed run first re-enters after starstar and runs the
    other phases, as the reference's does, so two more genome-scale
    run_full calls would be needed; PERF.md section 4.)"""
    import contextlib
    import io

    import numpy as np
    from supernova_tpu_torch import cli
    from supernova_tpu_torch.asm import het as ahet
    from supernova_tpu_torch.asm import links as alinks
    from supernova_tpu_torch.asm import scaffold as asc
    from supernova_tpu_torch.core import dna
    from supernova_tpu_torch.ops import alignment as al
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline import datasets
    from supernova_tpu_torch.pipeline.run import Pipeline

    asm = f"{outdir}/asm"
    het_pairs, runs, bundle_s, scaffolding = [], [], [], []

    def align_spy(pairs, device, **kw):
        het_pairs.extend(pairs)
        return align_pairs(pairs, device, **kw)

    def run_full_spy(self, rs, *a, **kw):
        got = run_full(self, rs, *a, **kw)
        runs.append((self, rs, got))
        return got

    def scaffold_lines_spy(*a, **kw):
        """The legacy scaffolder's link_triples_np call: its incidence rows
        (the canonical lines' barcode sets), arguments and triples."""
        def links_spy(*la, **lkw):
            scaffolding.append((la, lkw, link_triples_np(*la, **lkw)))
            return scaffolding[-1][2]

        alinks.link_triples_np = links_spy
        try:
            return scaffold_lines(*a, **kw)
        finally:
            alinks.link_triples_np = link_triples_np

    def bundle_spy(*a, **kw):
        t0 = time.perf_counter()
        path = make_mri_bundle(*a, **kw)
        bundle_s.append(time.perf_counter() - t0)
        return path

    align_pairs, run_full, make_mri_bundle = ahet.align_pairs, Pipeline.run_full, cli.make_mri_bundle
    scaffold_lines, link_triples_np = asc.scaffold_lines, alinks.link_triples_np
    ahet.align_pairs, Pipeline.run_full, cli.make_mri_bundle = align_spy, run_full_spy, bundle_spy
    asc.scaffold_lines = scaffold_lines_spy
    kernels.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["run", "--resume", "--out", asm, "--device", "cuda"])
    finally:
        ahet.align_pairs, Pipeline.run_full, cli.make_mri_bundle = (
            align_pairs, run_full, make_mri_bundle)
        asc.scaffold_lines = scaffold_lines
    wall = time.perf_counter() - t0
    check(rc == 0 and len(runs) == 1, f"scaffold: the CLI's run exited {rc}")
    pl, rs, (D, lines, scaffolds, phasings, outs) = runs[0]
    check(pl.device == dev and pl.resume, f"scaffold: the CLI built {pl.device}, {pl.resume}")
    recs = pl.stage_records
    for name, rec in recs.items():
        print(f"[scaffold] stage {name}: wall {rec['wall_s']:.3f} s, peak device memory "
              f"{gib(rec['peak_gb'])} GiB, host RSS peak {gib(rec['host_peak_gb'])} GiB, "
              f"launches {rec['launches']}")
    check("paths" not in recs, "scaffold: run_full ran the paths stage on a patched outdir")
    for name in ("count", "graph", "patch", "supergraph", "scaffold"):
        check(sum(recs[name]["launches"].values()) == 0,
              f"scaffold: the {name} stage launched {recs[name]['launches']}")
    rec = recs["scaffold"]
    st = pl.stats.get
    phase_s = rec.get("phase_s", {})
    print("[scaffold] phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phase_s.items()))
    print(f"[scaffold] stage_scaffold_phase: wall {rec['wall_s']:.3f} s, peak device memory "
          f"{gib(rec['peak_gb'])} GiB; scaffold_mode {st('scaffold_mode')}, n_scaffolds "
          f"{st('n_scaffolds')} ({len(scaffolds)}), n_line_lines {st('n_line_lines')}, "
          f"line_line_N50 {st('line_line_N50')}, star_gap_joins {st('star_gap_joins')}, "
          f"barcode_joins {st('barcode_joins')}, gaps_filled_post {st('gaps_filled_post')}, "
          f"{len(phasings)} lines phased; D {D.n_edges} edges, {lines.n_lines} lines")
    # the star-gap mode runs all the phases; with no star join the stage
    # leaves them after starstar for the legacy scaffolder
    phases = Pipeline.SUP_PHASES
    if st("scaffold_mode") != "star-gap":
        phases = phases[: phases.index("starstar") + 1]
    check(list(phase_s) == list(phases), f"scaffold: ran the phases {list(phase_s)}")
    for name in phases:
        path = Path(asm, name, "a.sup.npz")
        check(path.exists() and path.stat().st_mtime >= time.time() - wall - 1,
              f"scaffold: phase snapshot {name}/a.sup.npz not written by this run")
    print(f"[scaffold] {len(phases)} phase snapshots written")
    for name in RUN_FULL_FILES:
        check(Path(asm, name).exists(), f"scaffold: {name} not written")
    for name in FLAVOR_FILES:
        nrec, nbases, n50 = check_fasta(Path(asm, name), f"scaffold {name}", "ACGTN")
        print(f"[scaffold] {name}: {nrec} records, {nbases} bases, N50 {n50}")
    hd = st("hetdist_aligned")
    check(hd is not None, "scaffold: hetdist_aligned was not logged")
    check(len(het_pairs) == rec["het_pairs"], "scaffold: the het DP's pairs were not recorded")
    t0 = time.perf_counter()
    on_cpu = al.align_pairs(het_pairs, "cpu")
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(al.align_pairs(het_pairs, dev), on_cpu),
          "scaffold: the het DP on the card differs from the same DP on CPU tensors")
    print(f"[scaffold] het DP: {rec['het_pairs']} bubble pairs, LA x LB {rec['het_shape']}, "
          f"{rec['het_dp_s']:.3f} s on the card (host clock, result on the host), {cpu_s:.3f} s "
          f"on CPU tensors: equal; hetdist_aligned {hd:.1f}")
    g, hb = datasets.simulate_haplotypes(datasets.GENOME, datasets.GENOME_SEED)
    strands = [dna.codes_to_seq(x) for x in (g, dna.revcomp(g), hb, dna.revcomp(hb))]
    n_ctg, n_hit = haplotype_share(outs["pseudohap"], strands)
    print(f"[scaffold] pseudohap contigs (split at N) > 400 bp: {n_hit} of {n_ctg} "
          f"({100 * n_hit / max(n_ctg, 1):.2f}%) are exact substrings of a haplotype strand")
    summary = json.loads(Path(asm, "summary.json").read_text())
    check(json.loads(printed.getvalue()) == summary, "scaffold: the CLI did not print summary.json")
    state = json.loads(Path(asm, "pipestance.json").read_text())["stages"]
    for name in recs:
        check(state.get(name, {}).get("status") == "complete",
              f"scaffold: pipestance.json has {name} {state.get(name)}")
    print("[scaffold] pipestance.json (attempts and wall_s add up over the earlier phases' "
          "orchestrated stages): " + "; ".join(
              f"{k} {v['status']}, attempts {v['attempts']}, wall_s {v['wall_s']:.3f}"
              for k, v in state.items()))
    bundle = Path(asm, "asm.mri.tgz")
    check(bundle.exists() and len(bundle_s) == 1, "scaffold: the CLI wrote no .mri.tgz bundle")
    print(f"[scaffold] {bundle.name}: {bundle.stat().st_size} bytes in {bundle_s[0]:.3f} s")
    print(f"[scaffold] cli.main run --resume: {wall:.3f} s (run_full resumed up to the scaffold "
          "stage, reads.npz loaded, the bundle)")
    # evaluate against the truth, beside the later phases (its index is
    # host work of about a minute at this size); the FASTA is copied out of
    # asm/, which [patch kernels] removes
    ev = Path(outdir, "evaluate")
    ev.mkdir()
    shutil.copy(outs["pseudohap"], ev / "assembly.pseudohap.fasta.gz")
    np.save(ev / "hap_a.npy", g)
    np.save(ev / "hap_b.npy", hb)
    job = Background(port_cmd("evaluate", "--fasta", ev / "assembly.pseudohap.fasta.gz",
                              "--truth", ev / "hap_a.npy", ev / "hap_b.npy"))
    check(len(scaffolding) == 1,
          "scaffold: the stage did not take the legacy scaffolder's one link_triples_np call")
    return job, dict(D=D, lines=lines, scaffolds=scaffolds, dpaths=pl._dpaths, dlen=pl._dlen,
                     bc=rs.bc, reads=(rs.codes, rs.offsets), scaffolding=scaffolding[0])


def report_evaluate(job):
    """The genome's `evaluate` (phase_scaffold's background job)."""
    rc, out, err = job.result()
    check(rc == 0, f"evaluate: exited {rc}: {err[-2000:]}")
    check(not foreign_imports(err), f"evaluate imported {foreign_imports(err)[:5]}")
    res = json.loads(out)
    print(f"[evaluate] the genome's pseudohap: anchored_frac {res['anchored_frac']}, "
          f"mean_identity {res['mean_identity']}, misassemblies {res['misassemblies']}, "
          f"perfect_stretch_N50 {res['perfect_stretch_N50']}, n_contigs {res['n_contigs']}, "
          f"misassembly_rate_perc {res['misassembly_rate_perc']}; {job.wall:.3f} s "
          "(a fresh process, beside the phases after [scaffold])")
    check(res["anchored_frac"] > 0.9, f"evaluate: anchored_frac {res['anchored_frac']}")


def phase_mesh_links(torch, dev, asm, smi, res):
    """The genome's barcode links on the card: the incidence rows of the
    canonical lines with barcodes, as the scaffold stage built them and
    passed them to link_triples_np (phase_scaffold records the call);
    bc_link_triples at cap 16 (the reference's
    default) and at the longest barcode run (nothing dropped), then
    sharded_bc_links over MESH_SHARDS virtual shards at both caps, each
    equal to link_triples_np(max_per_bc=cap), and at the longest run to the
    stage's own call; then the dry run's scaffold-join round on the shards.
    The launch counters are set to 0 just before these calls and read just
    after (K4 and K2 must launch).  Then K4 at the (bc, item) and pair
    sorts and K2 at the run-total compaction against their twins
    (phase_links_kernels).  Returns the launches."""
    import numpy as np
    from supernova_tpu_torch.asm.links import link_triples_np
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.parallel import mesh as pmesh
    from supernova_tpu_torch.parallel import rounds
    from supernova_tpu_torch.parallel import sharded_scaffold as pss

    (bcv, item), kw, stage = asm["scaffolding"]
    check(set(kw) == {"min_shared"}, f"mesh links: the stage called link_triples_np with {kw}")
    min_shared = kw["min_shared"]
    longest = int(np.unique(bcv, return_counts=True)[1].max()) if len(bcv) else 0
    caps = (16, max(longest, 2))
    want = {cap: link_triples_np(bcv, item, min_shared=min_shared, max_per_bc=cap)
            for cap in caps}
    check(all(np.array_equal(a, b) for a, b in zip(want[caps[1]], stage)),
          "mesh links: link_triples_np at the longest run differs from the stage's call")
    mesh = pmesh.make_mesh(MESH_SHARDS, dev)
    shards = pss.split_incidence(bcv, item, MESH_SHARDS)
    walls, info = {}, {}

    def timed_call(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    kernels.reset_launch_counts()
    got = {}
    for cap in caps:
        o1, o2, tot, nv = timed_call(f"bc_link_triples cap {cap}", lambda: pss.bc_link_triples(
            bcv, item, cap=cap, min_shared=min_shared, device=dev))
        got[cap] = (o1.cpu().numpy(), o2.cpu().numpy(), tot.cpu().numpy())
        info[cap] = {}
        got[("mesh", cap)] = timed_call(f"sharded_bc_links cap {cap}", lambda: pss.sharded_bc_links(
            mesh, *shards, cap=cap, min_shared=min_shared, info=info[cap]))
    rnd = timed_call("scaffold_join_round", lambda: rounds.scaffold_join_round(mesh))
    launches = kernels.launch_counts()
    for cap in caps:
        for key, label in ((cap, "bc_link_triples"), (("mesh", cap), "sharded_bc_links")):
            check(all(a.dtype == b.dtype and np.array_equal(a, b)
                      for a, b in zip(got[key], want[cap])),
                  f"mesh links: {label} at cap {cap} differs from link_triples_np")
        check(sum(info[cap]["dropped"]) == 0, f"mesh links: rows dropped {info[cap]['dropped']}")
    check(rnd[0] > rnd[1], f"mesh links: the scaffold-join round joined nothing {rnd}")
    for name in ("sort", "compact"):
        check(launches[name] > 0, f"mesh links: {name} was not launched")
    print(f"[mesh links] {smi}: the genome's scaffold incidence: N {len(np.unique(item))} "
          f"canonical lines with barcodes, {len(bcv)} incidence rows, "
          f"{len(np.unique(bcv))} barcodes, longest barcode run {longest}; min_shared "
          f"{min_shared}")
    for cap in caps:
        print(f"[mesh links] cap {cap}: bc_link_triples on the card == sharded_bc_links over "
              f"{MESH_SHARDS} VIRTUAL shards == link_triples_np(max_per_bc={cap}): "
              f"{len(want[cap][0])} triples; {info[cap]['pair_rows']} pair rows, "
              f"{info[cap]['local_rows']} pre-reduced rows exchanged, 0 dropped"
              + (" (== the scaffold stage's link_triples_np)" if cap == caps[1] else ""))
    print(f"[mesh links] scaffold_join_round over {MESH_SHARDS} shards: lines {rnd[0]} -> "
          f"{rnd[1]}; walls (host clock, synchronized): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    print(f"[mesh links] launches {launches}")
    phase_links_kernels(torch, dev, bcv, item, caps[1], res)
    return launches


def phase_links_kernels(torch, dev, bcv, item, cap, res):
    """K4 at the links' (bc, item) sort and pair sort, K2 at the run-total
    compaction (with the zero fill, as segments.stable_compact calls it),
    on the genome's incidence at `cap`, each against its twin; adds
    links_* entries to `res`."""
    from supernova_tpu_torch.ops import segments as seg
    from supernova_tpu_torch.ops.kernels import compact as k2
    from supernova_tpu_torch.ops.kernels import sort as k4
    from supernova_tpu_torch.parallel import sharded_scaffold as pss

    bc, it = (torch.from_numpy(x.astype("int64")).to(dev) for x in (bcv, item))
    keep_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
                 "library_shape")
    r, perm = check_sort(torch, [bc, it], f"{bc.shape[0]} rows x 2 keys (links (bc, item))")
    res["sort"]["links_bc_item"] = {k: r[k] for k in keep_keys}
    e1, e2 = pss._pairs_from_sorted(bc[perm], it[perm], cap)
    r, perm = check_sort(torch, [e1, e2], f"{e1.shape[0]} rows x 2 keys (links pairs)")
    res["sort"]["links_pairs"] = {k: r[k] for k in keep_keys}
    k1, k2_, w = e1[perm], e2[perm], torch.ones_like(e1)
    starts = seg.run_starts(k1, k2_)
    cs = torch.cumsum(w, 0)
    cols = (k1, k2_, cs - seg.run_broadcast_from_start(cs - w, starts))
    keep = seg.run_end_mask(starts)
    fills = (0,) * 3
    nv_k, out_k = k2.compact_cuda(keep, *cols, fills=fills)
    nv_p, out_p = k2.compact_plain(keep, *cols, fills=fills)
    torch.cuda.synchronize()
    check(int(nv_k) == int(nv_p) and all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "links: K2 differs from plain at the run-total compaction")
    rows, nv = keep.shape[0], int(nv_p)
    r = dict(
        shape=f"{rows} rows x 3 int64 columns, {nv} kept ({nv / max(rows, 1):.4f}), zero fill "
              "(links run totals)",
        max_abs_err=max_abs_err(torch, zip(out_k, out_p)),
        ms=median_ms(torch, lambda: k2.compact_cuda(keep, *cols, fills=fills)),
        plain_ms=median_ms(torch, lambda: k2.compact_plain(keep, *cols, fills=fills)),
        # read the mask and the kept rows, write every row of every column
        bound_ms=bound_ms(k2.launch_bytes(rows, nv, 24, fill=True)),
        library_ms=median_ms(torch, lambda: [c[keep] for c in cols]),
        library_shape="c[keep] for each of the 3 columns")
    print_kernel("compact (links run totals)", r)
    res["compact"]["links_run_totals"] = r


def vote_rows(D, dpaths, dlen, read_bc, edge_bubble):
    """One vote row per distinct (read, D-edge) placement of a barcoded read
    on an arm edge, as asm/phasing.build_edge_bc_counts counts them ->
    (D-edges, barcodes)."""
    import numpy as np

    r, mp = dpaths.shape
    mapped = np.where(np.arange(mp)[None, :] < np.asarray(dlen)[:r, None], dpaths, -1)
    bc = np.asarray(read_bc)[:r]
    keep = (mapped >= 0) & (bc[:, None] > 0)
    reads = np.broadcast_to(np.arange(r)[:, None], (r, mp))[keep]
    uniq = np.unique(reads.astype(np.int64) * (D.n_edges + 1) + mapped[keep])
    ur, ud = uniq // (D.n_edges + 1), uniq % (D.n_edges + 1)
    on_arm = edge_bubble[np.minimum(ud, D.n_edges - 1)] >= 0
    on_arm &= ud < D.n_edges
    return ud[on_arm], bc[ur[on_arm]]


def phase_mesh_phase(torch, dev, asm, smi):
    """The genome's phasing votes over MESH_SHARDS virtual shards on the
    card: every bubble of every scaffolded line (phase_line's bubbles; a
    bubble whose arms share a D-edge, or share one with an earlier bubble,
    is left out and counted), one vote row per (read, D-edge) placement on
    an arm edge (vote_rows), the barcodes remapped to dense molecule
    indices; sharded_vote_matrix's (B, M) matrix must hold each line's
    _support_matrix (of the host's build_edge_bc_counts) in its rows and
    columns, and zeros elsewhere in those rows; phase_line from the mesh's
    counts must give the host's x on every line with no bubble left out
    (the dry run's phasing round at genome scale)."""
    import numpy as np
    from supernova_tpu_torch.asm import phasing as aph
    from supernova_tpu_torch.parallel import mesh as pmesh
    from supernova_tpu_torch.parallel import rounds
    from supernova_tpu_torch.parallel import sharded_phase as psp

    D, lines = asm["D"], asm["lines"]
    dinv = np.asarray(D.dinv)
    line_ids = sorted({int(li) for sc in asm["scaffolds"] for li in sc.line_ids})
    edge_bubble = np.full(D.n_edges, -1, np.int32)
    edge_sign = np.zeros(D.n_edges, np.int32)
    per_line, left_out, whole = {}, 0, []
    for li in line_ids:
        kept, n_line = [], 0
        for i, el in enumerate(lines.lines[li].elements):
            if len(el) != 2 or np.array_equal(dinv[el.paths[0][::-1]], el.paths[1]):
                continue  # phase_line's bubbles: no inversion artifacts
            n_line += 1
            arms = [np.asarray(el.paths[0]), np.asarray(el.paths[1])]
            both = np.concatenate(arms)
            if len(np.unique(both)) < len(both) or (edge_bubble[both] >= 0).any():
                left_out += 1
                continue
            g = sum(len(v) for v in per_line.values()) + len(kept)
            for arm, sign in zip(arms, (1, -1)):
                edge_bubble[arm], edge_sign[arm] = g, sign
            kept.append((g, aph.Bubble(i, [arms[0].copy(), arms[1].copy()])))
        per_line[li] = kept
        if len(kept) == n_line:
            whole.append(li)
    n_bub = sum(len(v) for v in per_line.values())
    t0 = time.perf_counter()
    re, rbc = vote_rows(D, asm["dpaths"], asm["dlen"], asm["bc"], edge_bubble)
    mols, rb = np.unique(rbc, return_inverse=True)
    host_counts = aph.build_edge_bc_counts(D, asm["dpaths"], asm["dlen"], asm["bc"])
    prep_s = time.perf_counter() - t0
    shards = psp.split_votes(re, rb.astype(np.int32), MESH_SHARDS)
    mesh = pmesh.make_mesh(MESH_SHARDS, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    S = psp.sharded_vote_matrix(mesh, edge_bubble, edge_sign, *shards, n_bub, len(mols))
    mesh_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(S.shape == (n_bub, len(mols)) and S.any(), f"mesh phase: matrix {S.shape}")
    t0 = time.perf_counter()
    for li in line_ids:
        rows = [g for g, _ in per_line[li]]
        if not rows:
            continue
        s_host, bcs = aph._support_matrix([b for _, b in per_line[li]], host_counts)
        cols = np.searchsorted(mols, bcs)
        check(np.array_equal(mols[cols], bcs), f"mesh phase: line {li}: a barcode has no column")
        check(np.array_equal(S[np.ix_(rows, cols)], s_host),
              f"mesh phase: line {li}: the mesh matrix differs from _support_matrix")
        rest = np.ones(len(mols), bool)
        rest[cols] = False
        check(not S[np.ix_(rows, rest)].any(), f"mesh phase: line {li}: votes off its molecules")
    support_s = time.perf_counter() - t0
    counts_mesh: dict = {}
    for li in whole:
        for g, b in per_line[li]:
            nz = np.flatnonzero(S[g])
            for m, v in zip(mols[nz].tolist(), S[g, nz].tolist()):
                counts_mesh.setdefault(int(b.arms[0 if v > 0 else 1][0]), {})[m] = abs(v)
    t0 = time.perf_counter()
    x_host = {li: aph.phase_line(lines.lines[li], host_counts, dinv=D.dinv).x for li in whole}
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_mesh = {li: aph.phase_line(lines.lines[li], counts_mesh, dinv=D.dinv).x for li in whole}
    phase_s = time.perf_counter() - t0
    for li in whole:
        check(np.array_equal(x_host[li], x_mesh[li]),
              f"mesh phase: line {li} phases differently from the mesh's counts")
    phased = sum(int((x != 0).sum()) for x in x_host.values())
    rnd = rounds.phase_round(mesh)
    check(rnd == (2, 1.0), f"mesh phase: the dry run's phasing round gave {rnd}")
    print(f"[mesh phase] {smi}: {len(line_ids)} scaffolded lines, B {n_bub} bubbles "
          f"({left_out} left out: arms sharing a D-edge), M {len(mols)} molecules (dense "
          f"barcode indices), {len(re)} vote rows over {MESH_SHARDS} VIRTUAL shards; "
          f"sharded_vote_matrix {mesh_s:.3f} s (host clock, the matrix on the host), peak "
          f"device memory {peak:.3f} GiB above its inputs; vote rows and host counts "
          f"{prep_s:.3f} s")
    print(f"[mesh phase] every line's _support_matrix == the mesh matrix's rows and columns "
          f"({support_s:.3f} s); phase_line from the mesh's counts == from the host's on "
          f"{len(whole)} lines ({phased} bubbles phased): host {host_s:.3f} s, mesh counts "
          f"{phase_s:.3f} s; phase_round over {MESH_SHARDS} shards {rnd}")


def phase_fmindex(torch, dev, asm, smi, res):
    """The FM-index of the genome's patched base graph on the card:
    FMIndex.from_edges (text length, doubling rounds, K4 launches; the
    counters set to 0 just before and read after it and the batched
    search), its suffix array equal to the same doubling on K4's plain twin
    on the card, its bwt, less and occ_ck equal to those derived from it on
    the host; count_batch_device on FM_QUERIES patterns of 16-100 bases cut
    from the genome's reads, equal to the same function on CPU tensors on
    FM_CPU_QUERIES of them, to FMIndex.count on FM_HOST_QUERIES and, for
    FM_LOCATE of them, locate equal to a brute-force search of the text.
    K4 against its twin at the last doubling round's sort.  Returns the
    launches."""
    import numpy as np
    from supernova_tpu_torch.align import fmindex as pfm
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.ops.kernels import sort as k4

    edges = asm["D"].bg.edges
    sorts = []

    def sort_spy(*keys):
        sorts[:] = [keys]  # the last round's keys
        return lex_argsort(*keys)

    lex_argsort = pfm.lex_argsort
    pfm.lex_argsort = sort_spy
    info = {}
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = pfm.FMIndex.from_edges(edges, device=dev, info=info)
        build_s = time.perf_counter() - t0
    finally:
        pfm.lex_argsort = lex_argsort
    t, starts = pfm._text(edges)
    n = len(t)
    rng = np.random.default_rng(17)
    codes, offsets = asm["reads"]
    ri = rng.integers(0, len(offsets) - 1, FM_QUERIES)
    rlen = offsets[ri + 1] - offsets[ri]
    lens = np.minimum(rng.integers(16, 101, FM_QUERIES), rlen)
    at = offsets[ri] + (rng.random(FM_QUERIES) * (rlen - lens + 1)).astype(np.int64)
    span = np.arange(100)
    pats = np.where(span < lens[:, None], codes[np.minimum(at[:, None] + span, len(codes) - 1)],
                    0).astype(np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fm.count_batch_device(pats, lens, device=dev).cpu().numpy()
    query_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(launches["sort"] == info["rounds"], f"fmindex: {launches} for {info['rounds']} rounds")

    pfm.lex_argsort = k4.lex_argsort_plain
    try:
        t0 = time.perf_counter()
        sa_plain = pfm.suffix_array(t, dev)
        plain_s = time.perf_counter() - t0
    finally:
        pfm.lex_argsort = lex_argsort
    check(np.array_equal(fm.sa, sa_plain), "fmindex: the suffix array differs from K4's twin's")
    check(np.array_equal(fm.bwt, t[fm.sa - 1]), "fmindex: bwt differs from t[sa - 1]")
    counts = np.bincount(t, minlength=pfm.SIGMA)
    check(np.array_equal(fm.less, np.concatenate([[0], np.cumsum(counts)[:-1]])), "fmindex: less")
    nck = n // pfm.CHECK + 1
    for a in range(pfm.SIGMA):
        cum = np.cumsum(fm.bwt == a)[pfm.CHECK - 1 :: pfm.CHECK][: nck - 1]
        check(fm.occ_ck[0, a] == 0 and np.array_equal(fm.occ_ck[1:, a], cum),
              f"fmindex: occ_ck of symbol {a}")
    check(np.array_equal(fm.edge_starts, starts), "fmindex: edge_starts")
    sub = rng.choice(FM_QUERIES, FM_CPU_QUERIES, replace=False)
    t0 = time.perf_counter()
    on_cpu = fm.count_batch_device(pats[sub], lens[sub], device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(got[sub], on_cpu), "fmindex: batched counts on the card differ from CPU")
    t0 = time.perf_counter()
    host = [fm.count(pats[q, : lens[q]]) for q in sub[:FM_HOST_QUERIES]]
    host_s = time.perf_counter() - t0
    check(np.array_equal(got[sub[:FM_HOST_QUERIES]], host), "fmindex: counts differ from count()")
    text = t.tobytes()
    for q in sub[:FM_LOCATE]:
        p = pats[q, : lens[q]].tobytes()
        hits, i = [], text.find(p)
        while i >= 0:
            e = int(np.searchsorted(starts, i, "right")) - 1
            hits.append((e, i - int(starts[e])))
            i = text.find(p, i + 1)
        check([tuple(x) for x in fm.locate(pats[q, : lens[q]]).tolist()] == sorted(hits)
              and got[q] == len(hits), f"fmindex: locate of pattern {q} differs from brute force")
    found = float((got > 0).mean())
    print(f"[fmindex] {smi}: the genome's patched base graph: {edges.n_rows} edges, text "
          f"length {n}, {info['rounds']} doubling rounds; FMIndex.from_edges on the card "
          f"{build_s:.3f} s (host clock, the arrays on the host), the doubling on K4's twin "
          f"{plain_s:.3f} s: the same suffix array; bwt, less, occ_ck == derived on the host")
    print(f"[fmindex] count_batch_device: {FM_QUERIES} patterns of {int(lens.min())}-"
          f"{int(lens.max())} bases from the genome's reads, {query_s:.3f} s on the card "
          f"({FM_QUERIES / query_s:.1f} queries/s, host clock, counts on the host), "
          f"{100 * found:.2f}% found; == CPU tensors on {FM_CPU_QUERIES} ({cpu_s:.3f} s), == "
          f"FMIndex.count on {FM_HOST_QUERIES} ({host_s:.3f} s), locate == brute force on "
          f"{FM_LOCATE}; launches {launches}")
    keys = [k.contiguous() for k in sorts[0]]
    r, _ = check_sort(torch, keys, f"{n} rows x 2 keys (fmindex doubling round {info['rounds']})")
    res["sort"]["fmindex_doubling"] = {
        k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
                          "library_shape")}
    return launches


def phase_small_run_full(torch):
    """run_full on CUDA and on the CPU for the e2e genome and the star-gap
    fixture (pipeline/datasets.py SMALL_RUNS): the four FASTA files and
    summary.json apart from the timing keys identical, every kernel
    launched by each CUDA run.  Then the star-gap fixture's CUDA outdir
    resumed with the early phases poisoned: it re-enters after the last
    phase (fase), runs no phase, launches nothing and writes the same FASTA
    bytes."""
    import json

    import numpy as np
    from supernova_tpu_torch.ingest.ingest import ingest_sim
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline import datasets
    from supernova_tpu_torch.pipeline.run import Pipeline

    timing = ("etime_", "mem_")
    for name, (recipe, opts) in datasets.SMALL_RUNS.items():
        rs = ingest_sim(*recipe(np.random.default_rng(0)))
        got = {}
        with tempfile.TemporaryDirectory() as d:
            for device in ("cuda", "cpu"):
                kernels.reset_launch_counts()
                pl = Pipeline(f"{d}/{device}", device=device, **opts)
                t0 = time.perf_counter()
                pl.run_full(rs)
                wall = time.perf_counter() - t0
                launches = kernels.launch_counts()
                summary = json.loads(Path(d, device, "summary.json").read_text())
                got[device] = ({f: fasta_bytes(Path(d, device, f)) for f in FLAVOR_FILES},
                               {k: v for k, v in summary.items() if not k.startswith(timing)})
                print(f"[small run_full] {name} on {device}: {rs.n_reads} reads, {wall:.3f} s, "
                      f"scaffold_mode {pl.stats.get('scaffold_mode')}, n_scaffolds "
                      f"{pl.stats.get('n_scaffolds')}, launches {launches}")
                if device == "cuda":
                    for k, c in launches.items():
                        check(c > 0, f"small run_full {name}: kernel {k} was not launched")
            check(got["cuda"] == got["cpu"],
                  f"small run_full {name}: the FASTA files or summary.json differ on CUDA and CPU")
            print(f"[small run_full] {name}: the four FASTA files and summary.json identical on "
                  "CUDA and the CPU")
            if pl.stats.get("scaffold_mode") != "star-gap":
                continue
            kernels.reset_launch_counts()
            pl = Pipeline(f"{d}/cuda", device="cuda", resume=True, **opts)
            pl._star_multipass = pl._barcode_join_passes = pl._fix_misassemblies = None
            t0 = time.perf_counter()
            pl.run_full(rs)
            wall = time.perf_counter() - t0
            ran = list(pl.stage_records["scaffold"].get("phase_s", {}))
            check(ran == [], f"small run_full {name}: resumed after fase, it ran {ran}")
            check(sum(kernels.launch_counts().values()) == 0,
                  f"small run_full {name}: the resumed run launched {kernels.launch_counts()}")
            check({f: fasta_bytes(Path(d, "cuda", f)) for f in FLAVOR_FILES} == got["cuda"][0],
                  f"small run_full {name}: the resumed run's FASTA files differ")
            print(f"[small run_full] {name} resumed on cuda with the early phases poisoned: "
                  f"{wall:.3f} s, re-entered after fase, no phase run, no launch, the same four "
                  "FASTA files")


# tests/test_cli.py's simulation
CLI_SIM = ["--genome-size", "6000", "--barcodes", "40", "--whitelist-size", "128",
           "--repeats", "1"]


def cli_outcome(out):
    """A run dir's four FASTA files, summary.json without its timing keys
    and pipestance.json's stage states."""
    summary = json.loads(Path(out, "summary.json").read_text())
    stages = json.loads(Path(out, "pipestance.json").read_text())["stages"]
    return ({f: fasta_bytes(Path(out, f)) for f in FLAVOR_FILES},
            {k: v for k, v in summary.items() if not k.startswith(("etime_", "mem_"))},
            {k: (v["status"], v["attempts"]) for k, v in stages.items()})


def phase_cli(torch, root):
    """The command line on tests/test_cli.py's simulation: `simulate`, then
    `run --device cuda` in this process with the launch counters reset
    (every kernel launched) and `run --device cpu` (the same FASTA files,
    summary.json and pipestance.json stage states); a stage that raises once
    (retried: attempts 2, the same bytes) and one that raises
    torch.cuda.OutOfMemoryError every time (exit 185, the traceback of both
    attempts, the bundle, no FASTA); `run --device cuda` in a fresh process
    that sees no card (nonzero, no FASTA); then every tool subcommand as
    `python -m supernova_tpu_torch <tool>` in fresh processes, all at once,
    each exiting 0 with its JSON, and none importing jax or supernova_tpu.
    -> the number of fresh processes checked."""
    import contextlib
    import gzip
    import io

    from supernova_tpu_torch import cli
    from supernova_tpu_torch.ops import kernels
    from supernova_tpu_torch.pipeline.run import Pipeline

    def main(argv):
        printed, t0 = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main([str(a) for a in argv])
        return rc, printed.getvalue(), time.perf_counter() - t0

    root = Path(root)
    sim = root / "sim"
    rc, _, wall = main(["simulate", "--out", sim, *CLI_SIM])
    check(rc == 0, f"cli: simulate exited {rc}")
    print(f"[cli] simulate {' '.join(CLI_SIM)}: {wall:.3f} s")
    fq = ["--r1", sim / "sample_R1.fastq.gz", "--r2", sim / "sample_R2.fastq.gz",
          "--whitelist", sim / "whitelist.txt"]
    got = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        rc, printed, wall = main(["run", *fq, "--out", root / device, "--device", device])
        launches = kernels.launch_counts()
        check(rc == 0 and json.loads(printed)["nreads"] > 0, f"cli: run --device {device} exited {rc}")
        if device == "cuda":
            for k, c in launches.items():
                check(c > 0, f"cli: run --device cuda did not launch {k}")
        got[device] = cli_outcome(root / device)
        print(f"[cli] run --device {device}: {wall:.3f} s, launches {launches}, contig_N50 "
              f"{got[device][1]['contig_N50']}, stages {got[device][2]}")
    check(got["cuda"] == got["cpu"], "cli: run on cuda and on cpu differ")
    print("[cli] cuda and cpu: the four FASTA files, summary.json and pipestance.json identical")

    graph, calls = Pipeline.stage_graph, []

    def flaky(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("injected transient failure")
        return graph(self, *a, **kw)
    Pipeline.stage_graph = flaky
    try:
        rc, _, wall = main(["run", *fq, "--out", root / "retry", "--device", "cuda"])
    finally:
        Pipeline.stage_graph = graph
    check(rc == 0, f"cli: the retried run exited {rc}")
    outcome = cli_outcome(root / "retry")
    tb = (root / "retry" / "_stage_graph_traceback.txt").read_text()
    check(outcome[2]["graph"] == ("complete", 2) and tb.count("--- attempt") == 1,
          f"cli: the graph stage's record after one failure {outcome[2]['graph']}")
    check(outcome[0] == got["cuda"][0], "cli: the retried run's FASTA files differ")
    print(f"[cli] the graph stage raising once: retried (attempts 2, one traceback on file), "
          f"exit 0, the same FASTA files; {wall:.3f} s")

    def oom(self, rs):
        raise torch.cuda.OutOfMemoryError("injected: CUDA out of memory")
    count = Pipeline._count_with_cov_guard
    Pipeline._count_with_cov_guard = oom
    try:
        rc, printed, wall = main(["run", *fq, "--out", root / "oom", "--device", "cuda"])
    finally:
        Pipeline._count_with_cov_guard = count
    state = json.loads((root / "oom" / "pipestance.json").read_text())["stages"]
    tb = (root / "oom" / "_stage_count_traceback.txt").read_text()
    check(rc == 185 and not printed, f"cli: a stage raising OutOfMemoryError exited {rc}")
    check(state == {"count": state["count"]} and state["count"]["status"] == "failed"
          and state["count"]["attempts"] == 2 and tb.count("--- attempt") == 2
          and "OutOfMemoryError" in tb, f"cli: the failed count stage's record {state}")
    check((root / "oom" / "oom.mri.tgz").exists() and not list((root / "oom").glob("*.fasta.gz")),
          "cli: the failed run wrote no bundle or wrote FASTA")
    print(f"[cli] the count stage raising torch.cuda.OutOfMemoryError: exit 185, attempts 2, "
          f"both tracebacks and oom.mri.tgz written, no FASTA; {wall:.3f} s")

    # the tools' inputs: an I1 FASTQ beside the reads for demux; the patched
    # graph as graph.npz beside its ebcx.npz for graph-stats and scaf-graph,
    # which read graph.npz (the pre-patch graph, whose edges ebcx.npz does
    # not index, in a run_full dir: both packages raise there); a copy of
    # the run dir for tarmri, which writes into it
    run, tools = root / "cuda", root / "tools"
    with gzip.open(sim / "sample_R1.fastq.gz", "rt") as f:
        n_pairs = sum(1 for _ in f) // 4
    with gzip.open(sim / "I1.fastq.gz", "wt") as f:
        for i in range(n_pairs):
            si = ("ACGTACGT", "TTTTCCCC")[i % 2] if i % 50 else "GGGGGGGG"
            f.write(f"@read{i}\n{si}\n+\nIIIIIIII\n")
    patched = root / "patched"
    patched.mkdir()
    shutil.copy(run / "graph.patched.npz", patched / "graph.npz")
    shutil.copy(run / "ebcx.npz", patched / "ebcx.npz")
    shutil.copytree(run, root / "tarmri")
    truth = ["--truth", sim / "truth_hap_a.npy", sim / "truth_hap_b.npy"]
    pseudohap = run / "assembly.pseudohap.fasta.gz"
    head = tools / "ref" / "frag"
    jobs = {
        "sitecheck": ["sitecheck"],
        "stats": ["stats", "--graph", run / "graph.npz"],
        "mkoutput": ["mkoutput", "--dir", run, "--out", tools / "mk", "--flavors",
                     "raw,megabubbles,pseudohap,pseudohap2,efasta"],
        "graph-fasta": ["graph-fasta", "--dir", run, "--out", tools / "edges.fa.gz", "--patched"],
        "graph-stats": ["graph-stats", "--dir", patched, "--out", tools / "edges.tsv"],
        "scaf-graph": ["scaf-graph", "--dir", patched, "--out", tools / "scaf.csv",
                       "--min-ctg", "100"],
        "bcmat": ["bcmat", "--dir", run, "--out", tools / "bc.mm"],
        "sam": ["sam", "--dir", run, "--out", tools / "reads.sam.gz"],
        "readqa": ["readqa", "--dir", run, "--out", tools / "qa", "--whitelist",
                   sim / "whitelist.txt"],
        "evaluate": ["evaluate", "--fasta", pseudohap, *truth],
        "diagnose": ["diagnose", "--fasta", pseudohap, *truth, "--dir", run, "--min-len", "200"],
        "readcount": ["readcount", "--reads", run / "reads.npz"],
        "export-ref": ["export-ref", "--dir", run, "--out-head", head, "--graph"],
        "demux": ["demux", "--si", sim / "I1.fastq.gz", "--reads",
                  f"R1={sim / 'sample_R1.fastq.gz'}", f"R2={sim / 'sample_R2.fastq.gz'}",
                  "--out", tools / "demux"],
        "tarmri": ["tarmri", "--dir", root / "tarmri"],
    }
    tools.mkdir()
    t0 = time.perf_counter()
    nocard = Background(port_cmd("run", *fq, "--out", root / "nocard", "--device", "cuda"),
                        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    started = {name: Background(port_cmd(*argv)) for name, argv in jobs.items()}
    results = {}
    for name, job in list(started.items()):
        results[name] = job.result()
        if name == "export-ref":
            check(results[name][0] == 0, f"cli: export-ref exited {results[name][0]}")
            started["import-ref"] = job = Background(port_cmd(
                "import-ref", "--fastb", f"{head}.fastb", "--qualp", f"{head}.qualp",
                "--bci", f"{head}.bci", "--out", tools / "imported"))
            results["import-ref"] = job.result()
    all_s = time.perf_counter() - t0
    for name, (rc, out, err) in results.items():
        check(rc == 0, f"cli: {name} exited {rc}: {err[-1500:]}")
        check(not foreign_imports(err), f"cli: {name} imported {foreign_imports(err)[:5]}")
        if name == "mkoutput":
            shown = [Path(line).name for line in out.split()]
            check(len(shown) == 5 and all(Path(line).exists() for line in out.split()),
                  f"cli: mkoutput printed {out!r}")
        else:
            shown = json.loads(out.strip().splitlines()[-1] if name == "diagnose" else out)
        if name == "sitecheck":
            check([d["name"] for d in shown["cuda_devices"]][:1] == [torch.cuda.get_device_name(0)],
                  f"cli: sitecheck named {shown['cuda_devices']}")
            shown = {k: shown[k] for k in ("torch_version", "cuda_version", "cuda_devices",
                                           "nvcc_on_path")}
        print(f"[cli] {name}: exit 0 in {started[name].wall:.3f} s; {json.dumps(shown)[:300]}")
    rc, _, err = nocard.result()
    check(rc != 0 and not list((root / "nocard").glob("*.fasta.gz")),
          f"cli: run --device cuda without a visible card exited {rc}")
    check(not foreign_imports(err), f"cli: the no-card run imported {foreign_imports(err)[:5]}")
    print(f"[cli] CUDA_VISIBLE_DEVICES= run --device cuda: exit {rc}, no FASTA, "
          f"{nocard.wall:.3f} s; ({err.strip().splitlines()[-1][:200]})")
    print(f"[cli] {len(results)} tools and the no-card run: {all_s:.3f} s in all, in parallel")
    return len(results) + 1


def phase_kernels_patch(torch, dev, bg, outdir, res, save_s):
    """The patch rebuild's steps timed one by one (patch_readset, count,
    build_graph, from_device; save_s: the stage's graph.patched.npz write),
    then K1/K4/K3/K2 against their plain twins at the shapes
    the rebuild's count gives them: one strand of every edge plus the
    closures (closures.npz), unbarcoded, of 0 to thousands of bases,
    min_freq 1 and min_read_len K, every position a sort row.  Adds
    patch_* keys to the kernels' entries in `res`."""
    import numpy as np
    from supernova_tpu_torch.asm import patch as apatch
    from supernova_tpu_torch.core.kmer_codec import K
    from supernova_tpu_torch.dbg import build as dbuild
    from supernova_tpu_torch.dbg import graph as dgraph
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.ops.kernels import kmer_extract as k1
    from supernova_tpu_torch.ops.kernels import run_reduce as k3

    path = f"{outdir}/asm/closures.npz"
    closures = []
    if os.path.exists(path):
        z = np.load(path)
        closures = [z["values"][a:b] for a, b in zip(z["offsets"][:-1], z["offsets"][1:])]
    t0 = time.perf_counter()
    prs = apatch.patch_readset(bg, closures)
    reads_s = time.perf_counter() - t0
    lens = prs.lengths()
    check(int(prs.offsets[-1]) <= kcount.BLOCK_POSITIONS, "patch kernels: the rebuild is blocked")
    # where the rebuild's wall goes: insert_patches' steps, one at a time
    table, count_s, count_peak, count_launches = measured(
        torch, lambda: dbuild.trim_table(kcount.count_readset(prs, dev, min_freq=1,
                                                             min_read_len=K)))
    dg, build_s, build_peak, build_launches = measured(torch, lambda: dbuild.build_graph(table))
    t0 = time.perf_counter()
    bg2 = dgraph.from_device(dg, table)
    host_s = time.perf_counter() - t0
    print(f"[patch kernels] the rebuild's steps: patch_readset {reads_s:.3f} s (host), count "
          f"{count_s:.3f} s ({count_peak:.3f} GiB, {count_launches}), build_graph {build_s:.3f} s "
          f"({build_peak:.3f} GiB, {build_launches}), from_device {host_s:.3f} s (host); "
          f"{bg2.n_edges} edges; the stage wrote graph.patched.npz in {save_s:.3f} s (host)")
    del table, dg, bg2
    inp = kcount.prepare_reads(prs, dev)
    codes, n = inp["codes_ext"], inp["pos_read"].shape[0]
    print(f"[patch kernels] the rebuild's reads: {prs.n_reads} ({len(closures)} closures), "
          f"{int(prs.offsets[-1])} bases, {int(lens.min())}-{int(lens.max())} bases a read, "
          f"unbarcoded; {n} positions")
    got = k1.sliding_words_cuda(codes, n)
    ref = k1.sliding_words_plain(codes, n)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K1 differs from plain (patch)")
    res["kmer_extract"].update(
        patch_shape=f"{n} positions", patch_max_abs_err=max_abs_err(torch, zip(got, ref)),
        patch_ms=median_ms(torch, lambda: k1.sliding_words_cuda(codes, n)),
        patch_plain_ms=median_ms(torch, lambda: k1.sliding_words_plain(codes, n)),
        patch_bound_ms=bound_ms(k1.launch_bytes(codes.numel(), n)))
    print_kernel("kmer_extract (patch rebuild)", mixed_view(res["kmer_extract"], "patch"))
    del got, ref

    canon, pk = kcount.occurrence_rows(inp["codes_ext"], inp["pos_read"], inp["glen_pos"],
                                       inp["bc_pos"], inp["uniform_rl"], min_read_len=K)
    del inp, codes
    rows = pk.shape[0]
    r, perm = check_sort(torch, (*canon, pk), f"{rows} rows x 4 keys (patch rebuild)")
    res["sort"].update({f"patch_{k}": r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "library_ms")})
    ws, pk = canon.gather(perm), pk[perm]
    del canon, perm
    mf, mb = 1, kcount.MIN_BC  # the rebuild's filter (count_readset(min_freq=1))
    got = k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)
    ref, plain = once_ms(torch, lambda: k3.run_reduce_plain(ws.a, ws.b, ws.c, pk, mf, mb))
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "K3 differs from plain (patch)")
    sent = k3.SENTINEL
    n_real = int(((ws.a != sent) | (ws.b != sent) | (ws.c != sent)).sum())
    res["run_reduce"].update(
        patch_shape=f"{rows} rows ({n_real} real + a sentinel run of {rows - n_real}), "
                    f"({mf}, {mb})",
        patch_max_abs_err=max_abs_err(torch, zip(got, ref)),
        patch_ms=median_ms(torch, lambda: k3.run_reduce_cuda(ws.a, ws.b, ws.c, pk, mf, mb)),
        patch_plain_ms=plain, patch_bound_ms=bound_ms(k3.launch_bytes(rows)),
        patch_sentinel_run_ms=median_ms(torch, lambda: k3.run_reduce_cuda(
            ws.a[n_real:], ws.b[n_real:], ws.c[n_real:], pk[n_real:], mf, mb)))
    print_kernel("run_reduce (patch rebuild)", mixed_view(res["run_reduce"], "patch"))
    print(f"[kernels] run_reduce (patch rebuild): the sentinel run alone "
          f"{res['run_reduce']['patch_sentinel_run_ms']:.3f} ms")
    del ref
    keep, count, stats = got
    r = check_compact(torch, keep, (ws.a, ws.b, ws.c, count, stats), "patch rebuild")
    res["compact"].update({f"patch_{k}": r[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "fill_ms",
        "fill_plain_ms", "fill_bound_ms")})


def same_table(want, got, label):
    """Two host tables (convert.table_to_numpy) equal bit for bit."""
    import numpy as np

    check(want.n_valid == got.n_valid, f"{label}: n_valid {got.n_valid} != {want.n_valid}")
    for f, x, y in zip(("a", "b", "c", "count", "nbc", "left_mask", "right_mask"),
                       (*want.words, *want[1:5]), (*got.words, *got[1:5])):
        check(x.dtype == y.dtype and np.array_equal(x, y), f"{label}: table {f} differs")


def measured(torch, fn):
    """fn() with the launch counters set to 0 just before and read just
    after -> (result, wall s, device peak GiB above the bytes allocated
    before, launches)."""
    import gc

    from supernova_tpu_torch.ops import kernels

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    return out, wall, (torch.cuda.max_memory_allocated() - base) / 2**30, launches


class fixed_blocks:
    """The count's and the pather's block budgets pinned to `positions` on
    every device (count_block_positions, path_block_positions), so that a
    run on the card plans the blocks a CPU run plans, or the reference's
    96M-position blocks: the blocked paths at a size the card's free memory
    would not give."""

    def __init__(self, positions):
        self.positions = positions

    def __enter__(self):
        from supernova_tpu_torch.align import pather
        from supernova_tpu_torch.kmer import count as kcount

        self.saved = kcount.count_block_positions, pather.path_block_positions
        kcount.count_block_positions = lambda device, free_bytes=None: self.positions
        pather.path_block_positions = lambda device, bg, free_bytes=None: self.positions
        return self

    def __exit__(self, *exc):
        from supernova_tpu_torch.align import pather
        from supernova_tpu_torch.kmer import count as kcount

        kcount.count_block_positions, pather.path_block_positions = self.saved
        return False


def leave_free(torch, target, dev):
    """A ballast tensor that leaves `target` bytes for the caching
    allocator: the card's free memory (mem_get_info) plus the idle bytes
    the allocator still holds (inside segments that live tensors pin,
    which empty_cache cannot hand back) -> the ballast."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    idle = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    check(free + idle > target and target > idle,
          f"{free} bytes free and {idle} idle: no ballast leaves {target}")
    return torch.empty(free + idle - target, dtype=torch.uint8, device=dev)


def block_peak_gib(torch, rs, max_positions, dev):
    """Device peak of counting the first block of rs cut at max_positions
    (its inputs' copies to the card included) -> (allocated GiB above the
    bytes allocated before, reserved GiB: every segment the allocator held,
    the budget's measure)."""
    from supernova_tpu_torch.kmer import count as kcount

    blocks = kcount.split_readset_blocks(rs, max_positions)

    def count():
        p = kcount.prepare_reads(blocks[0], dev, pad_to_positions=max(int(b.offsets[-1]) for b in blocks),
                                 pad_to_reads=max(b.n_reads for b in blocks))
        return int(kcount.count_block_raw(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                                          p["uniform_rl"]).n_valid)

    peak = measured(torch, count)[2]
    reserved = torch.cuda.max_memory_reserved() / 2**30
    print(f"[genome count] one block at {max_positions} positions: device peak {peak:.3f} GiB "
          f"allocated, {reserved:.3f} GiB reserved")
    return peak, reserved


def phase_genome_count(torch, rs, want, dev):
    """The genome's count at the reference's 96M-position blocks (>= 2
    blocks spilled, one device merge), then partitioned + spilled, resumed
    (with no block size given: the spills' own) and OOM-halved: each table
    equals the fastq run's (`want`, on the host, counted at the card's
    budget) -> the raw rows at 96M-position blocks."""
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.kmer import count as kcount

    ref_block = kcount.BLOCK_POSITIONS

    def run(label, fn, info):
        table, wall, peak, launches = measured(torch, fn)
        same_table(want, convert.table_to_numpy(table), f"genome count {label}")
        print(f"[genome count] {label}: {info['blocks']} blocks at {info['block_positions']} "
              f"positions ({info['spilled_blocks']} counted and spilled, "
              f"{info['resumed_blocks']} resumed), {info['raw_rows']} raw rows in "
              f"{info['partitions']} partition(s) of {info['partition_rows']} rows; wall "
              f"{wall:.3f} s, device peak {peak:.3f} GiB, host peak RSS "
              f"{info['peak_rss_gb']:.2f} GB; launches {launches}; table identical")
        return launches

    info = {}
    run("(0) at the reference's blocks", lambda: kcount.count_readset_blocked(
        rs, dev, max_positions=ref_block, info=info), info)
    check(info["blocks"] >= 2 and info["spilled_blocks"] == info["blocks"]
          and info["partitions"] == 1,
          f"genome count (0): {info['blocks']} blocks, {info['spilled_blocks']} spilled, "
          f"{info['partitions']} merges (want >= 2 blocks spilled, one device merge)")
    raw_rows = info["raw_rows"]
    with tempfile.TemporaryDirectory() as d:
        # (b) gives no block size: it takes the spills' 96M, not the budget
        for label, max_pos in (("(a) partitioned + spilled", ref_block), ("(b) resumed", None)):
            info = {}
            launches = run(label, lambda: kcount.count_readset_blocked(
                rs, dev, max_positions=max_pos, merge_rows=raw_rows // 3,
                spill_dir=f"{d}/spill", info=info), info)
            check(info["partitions"] >= 4, f"{info['partitions']} merge partitions < 4")
            check(launches["sort"] > 0 and launches["compact"] >= info["partitions"],
                  f"genome count {label}: the merge's kernels were not launched")
        check(info["resumed_blocks"] == info["blocks"] and info["spilled_blocks"] == 0
              and info["block_positions"] == ref_block,
              f"genome count: a block was not resumed ({info['block_positions']}-position "
              f"blocks; the card's budget is {kcount.count_block_positions(dev)})")
        check(launches["kmer_extract"] == 0 and launches["run_reduce"] == 0,
              "genome count: a resumed block was recounted")

    p96, r96 = block_peak_gib(torch, rs, ref_block, dev)
    p48, r48 = block_peak_gib(torch, rs, ref_block // 2, dev)
    ballast = leave_free(torch, int((p96 + p48) / 2 * 2**30), dev)
    print(f"[genome count] count peak of one block: {p96:.3f} GiB at {ref_block} positions, "
          f"{p48:.3f} GiB at {ref_block // 2} ({(p96 - p48) * 2**30 / (ref_block // 2):.1f} B a "
          f"position; reserved {(r96 - r48) * 2**30 / (ref_block // 2):.1f}; "
          f"COUNT_BYTES_PER_POSITION {kcount.COUNT_BYTES_PER_POSITION}); "
          f"a {ballast.numel() / 2**30:.3f} GiB ballast leaves "
          f"{torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB free")
    info = {}
    try:
        launches = run("(c) OOM-halved", lambda: kcount.count_readset(
            rs, dev, info=info, max_positions=ref_block), info)
    finally:
        del ballast
    check(info["oom_retries"] >= 1, "genome count (c): the ballast caused no OOM retry")
    for name, c in launches.items():
        check(c > 0, f"genome count (c): kernel {name} was not launched")
    print(f"[genome count] (c) OOM retries {info['oom_retries']}")
    # the budget plans reserved bytes: the allocator's segments, not its tensors
    check((r96 - r48) * 2**30 / (ref_block // 2) <= kcount.COUNT_BYTES_PER_POSITION
          and r96 * 2**30 <= kcount.COUNT_BYTES_PER_POSITION * ref_block,
          "genome count: a block reserves more than COUNT_BYTES_PER_POSITION")
    return raw_rows


def phase_block_prep(torch, rs, dev):
    """A uniform block counted from the port's inputs (prepare_reads: 2-bit
    codes and per-read lengths, good lengths and barcodes, expanded on the
    card by repeat_interleave and gathers) and from the packed inputs the
    count used for uniform reads until it took prepare_reads for every
    block (prepare_reads_packed, expanded by a reshape of the read grid; a
    yardstick kept here, used nowhere in the port), alternated (packed,
    port, port, packed).  Each wall runs from the host ReadSet to the
    block's spill columns on the host; the raw tables must be identical."""
    import numpy as np

    from supernova_tpu_torch.core.kmer_codec import K
    from supernova_tpu_torch.kmer import count as kcount

    blocks = kcount.split_readset_blocks(rs, kcount.BLOCK_POSITIONS)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    t = lambda a: torch.from_numpy(a).to(dev)

    def packed():
        p = kcount.prepare_reads_packed(blocks[0], pad_to_positions=pad_pos)
        rl, nbp = p["uniform_rl"], p["nbp"]
        codes_ext = kcount._unpack_codes_dev(t(p["codes_packed"]), nbp, max(K, 128))
        pos_read = (torch.arange(nbp, device=dev) // rl).clamp(max=p["n_reads"])
        grid = lambda a: t(a)[:, None].expand(nbp // rl, rl).reshape(-1)
        return kcount.count_block_raw(codes_ext, pos_read, grid(p["glen"]), grid(p["read_bc"]), rl)

    def port():
        p = kcount.prepare_reads(blocks[0], dev, pad_to_positions=pad_pos, pad_to_reads=pad_rd)
        return kcount.count_block_raw(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                                      p["uniform_rl"])

    walls, peaks, cols = {"packed": [], "port": []}, {}, {}
    for label, fn in (("packed", packed), ("port", port), ("port", port), ("packed", packed)):
        out, wall, peaks[label], _ = measured(torch, lambda: kcount.raw_block_columns(fn()))
        walls[label].append(wall)
        cols.setdefault(label, out)
    nv = len(cols["port"][0])
    check(len(cols["packed"][0]) == nv, f"block prep: {len(cols['packed'][0])} raw rows != {nv}")
    for i, (x, y) in enumerate(zip(cols["packed"], cols["port"])):
        check(x.dtype == y.dtype and np.array_equal(x, y), f"block prep: raw column {i} differs")
    print(f"[block prep] the uniform genome's first block ({blocks[0].n_reads} reads, "
          f"{int(blocks[0].offsets[-1])} bases, {nv} raw rows) to the host's spill columns: "
          f"prepare_reads {walls['port'][0]:.3f} / {walls['port'][1]:.3f} s, "
          f"{peaks['port']:.3f} GiB; packed inputs (yardstick) {walls['packed'][0]:.3f} / "
          f"{walls['packed'][1]:.3f} s, {peaks['packed']:.3f} GiB; raw tables identical")


# the share of the mixed genome's reads its phases run on: two count
# blocks (the whole mixed genome is five), to keep the script inside its
# time limit on a slow host
MIXED_FRACTION = 0.45


def first_barcodes(rs, fraction):
    """The reads of rs's first barcodes (in id order) up to `fraction` of
    its reads, whole barcodes and pairs: coverage falls evenly, since each
    barcode's molecules lie at random places of the genome."""
    import numpy as np
    from supernova_tpu_torch.ingest.reads import ReadSet

    end = int(rs.bci[np.searchsorted(rs.bci, fraction * rs.n_reads)])
    check(end % 2 == 0, "first_barcodes: a barcode's reads are not whole pairs")
    cut = int(rs.offsets[end])
    return ReadSet(codes=rs.codes[:cut], offsets=rs.offsets[:end + 1], quals=rs.quals[:cut],
                   bc=rs.bc[:end], bci=np.minimum(rs.bci, end), barcoded=rs.barcoded)


def phase_mixed_count(torch, rs, want, dev):
    """The mixed genome counted again in blocks of 48M positions: the
    table equals the Pipeline's (`want`) bit for bit."""
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.kmer import count as kcount

    info = {}
    max_pos = kcount.BLOCK_POSITIONS // 2
    table, wall, peak, launches = measured(torch, lambda: kcount.count_readset_blocked(
        rs, dev, max_positions=max_pos, info=info))
    same_table(want, convert.table_to_numpy(table), "mixed count")
    print(f"[mixed count] {info['blocks']} blocks at {max_pos} positions, {info['raw_rows']} raw "
          f"rows in {info['partitions']} partition(s); wall {wall:.3f} s, device peak "
          f"{peak:.3f} GiB, host peak RSS {info['peak_rss_gb']:.2f} GB; launches {launches}; "
          "table identical to the Pipeline's")
    check(info["blocks"] >= 2, f"mixed count: {info['blocks']} blocks < 2")


def paths_block_peak_gib(torch, bg, rs, max_positions, dev):
    """Device peak of pathing the first block of the mixed-length rs cut at
    max_positions, padded as the blocked pather pads it (its inputs' copies
    to the card included; the graph's device arrays are already there) ->
    (allocated GiB above the bytes allocated before, reserved GiB, wall s)."""
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.kmer import count as kcount

    blocks = kcount.split_readset_blocks(rs, max_positions)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    _, wall, peak, _ = measured(torch, lambda: int(pather._path_full(
        bg, kcount.prepare_reads(blocks[0], dev, pad_to_positions=pad_pos, pad_to_reads=pad_rd),
        dev, pather.MAX_PATH).path_len.sum()))
    reserved = torch.cuda.max_memory_reserved() / 2**30
    print(f"[mixed paths] one block at {max_positions} positions: device peak {peak:.3f} GiB "
          f"allocated, {reserved:.3f} GiB reserved")
    return peak, reserved, wall


def same_paths(want, got, label):
    """Two ReadPaths on the card equal over want's rows."""
    n = got.edges.shape[0]
    for f, x, y in zip(want._fields, want, got):
        check(x[:n].shape == y.shape and bool((x[:n] == y).all()), f"{label}: paths {f} differ")


def phase_mixed_paths(torch, bg, rs, dev):
    """The blocked general pather at 96M-position blocks, then again beside
    a ballast that leaves free memory between one 96M- and one 48M-position
    block's paths peak: exactly one OOM retry, and the same ReadPaths."""
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.kmer import count as kcount

    ref_block = kcount.BLOCK_POSITIONS
    p96, r96, w96 = paths_block_peak_gib(torch, bg, rs, ref_block, dev)
    p48, r48, w48 = paths_block_peak_gib(torch, bg, rs, ref_block // 2, dev)
    per_pos = (p96 - p48) * 2**30 / (ref_block // 2)
    reserved_per_pos = (r96 - r48) * 2**30 / (ref_block // 2)
    m = int(bg.kmer_words.shape[0])
    planned = pather.PATH_BYTES_PER_POSITION * ref_block + pather.PATH_BYTES_PER_DICT_ROW * m
    info = {}
    want, wall, peak, _ = measured(torch, lambda: pather.path_readset(
        bg, rs, dev, info=info, max_positions=ref_block))
    check(info["oom_retries"] == 0, f"mixed paths: {info['oom_retries']} OOM retries unballasted")
    print(f"[mixed paths] {info['blocks']} blocks at {info['block_positions']} positions: wall "
          f"{wall:.3f} s, device peak {peak:.3f} GiB")
    # the dictionary again in fresh segments, so that no idle segment
    # space beside it counts as free room
    bg.__dict__.pop("_device_arrays", None)
    torch.cuda.empty_cache()
    bg.device_arrays(dev)
    ballast = leave_free(torch, int((p96 + p48) / 2 * 2**30), dev)
    print(f"[mixed paths] paths peak of one block: {p96:.3f} GiB ({w96:.3f} s) at "
          f"{ref_block} positions, {p48:.3f} GiB ({w48:.3f} s) at {ref_block // 2} "
          f"({per_pos:.1f} B a position; reserved {r96:.3f} / {r48:.3f} GiB, "
          f"{reserved_per_pos:.1f} B a position; PATH_BYTES_PER_POSITION "
          f"{pather.PATH_BYTES_PER_POSITION}; the budget plans {planned / 2**30:.3f} GiB at "
          f"{ref_block} beside the {m}-row dictionary at PATH_BYTES_PER_DICT_ROW "
          f"{pather.PATH_BYTES_PER_DICT_ROW}); a {ballast.numel() / 2**30:.3f} GiB ballast leaves "
          f"{torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB free")
    info = {}
    try:
        rp, wall, peak, launches = measured(torch, lambda: pather.path_readset(
            bg, rs, dev, info=info, max_positions=ref_block))
    finally:
        del ballast
    check(info["oom_retries"] == 1, f"mixed paths: {info['oom_retries']} OOM retries, not 1")
    same_paths(want, rp, "mixed paths (OOM-halved)")
    print(f"[mixed paths] beside the ballast: {info['oom_retries']} OOM retry, then "
          f"{info['blocks']} blocks at {info['block_positions']} positions; wall {wall:.3f} s, "
          f"device peak {peak:.3f} GiB; launches {launches}; ReadPaths identical to the "
          "96M-position blocks'")
    # the budget plans reserved bytes: the allocator's segments, not its tensors
    check(reserved_per_pos <= pather.PATH_BYTES_PER_POSITION and r96 * 2**30 <= planned,
          "mixed paths: a block reserves more than its budget plans")


def phase_general_vs_fused(torch, bg, rs, dev):
    """The general pather (with and without the tail cut) against the fused
    one on the first block of the uniform genome, at full width (walls from
    the inputs' host arrays: packed codes, prepare_reads' tensors)."""
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.kmer import count as kcount

    block = kcount.split_readset_blocks(rs, kcount.BLOCK_POSITIONS)[0]
    pk = kcount.prepare_reads_packed(block)
    fused, wf, pf, _ = measured(torch, lambda: pather._path_packed(
        bg, pather.packed_inputs(pk, dev), dev, pather.MAX_PATH,
        kcount._round_up(block.n_reads + 1, 1024)))
    inp = kcount.prepare_reads(block, dev)
    for rl in (inp["uniform_rl"], None):
        general, wg, pg, _ = measured(torch, lambda: pather._path_full(
            bg, dict(inp, uniform_rl=rl), dev, pather.MAX_PATH))
        same_paths(fused, general, f"general pather (uniform_rl={rl})")
        print(f"[mixed paths] general pather (uniform_rl={rl}) == fused on the uniform genome's "
              f"first block ({block.n_reads} reads, {int(block.offsets[-1])} bases): general "
              f"{wg:.3f} s, {pg:.3f} GiB; fused {wf:.3f} s, {pf:.3f} GiB")
        del general


def phase_graph_chunks(torch, table, dev):
    """build_links at the card's budget (one join at this size) and with
    the successor resolve in >= 4 chunks: the same links; each run's peak
    bytes a joined row within LINK_BYTES_PER_ROW (the genome's table, back
    on the card)."""
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.dbg import build as dbuild

    t = convert.table_from_numpy(table, dev)
    m = t.words.a.shape[0]
    budget = dbuild.link_chunk_rows(dev, m)
    whole = None
    for label, chunk in (("the card's budget", budget), (">= 4 chunks", 2 * m // 4 + 1)):
        torch.cuda.empty_cache()
        links, wall, peak, launches = measured(torch, lambda: dbuild.build_links(t, chunk=chunk))
        nchunks = -(-2 * m // chunk)
        per_row = peak * 2**30 / (m + chunk)
        if whole is None:
            whole = links
        for f, x, y in zip(whole._fields, whole, links):
            check(torch.equal(x, y), f"graph chunks ({label}): links {f} differ")
        print(f"[graph chunks] {label}: {nchunks} chunk(s) of {chunk} of the {2 * m} oriented "
              f"nodes, {m} table rows: {wall:.3f} s, device peak {peak:.3f} GiB = {per_row:.1f} B "
              f"a joined row (LINK_BYTES_PER_ROW {dbuild.LINK_BYTES_PER_ROW}), K4 "
              f"{launches['sort']} launches; links identical")
        check(per_row <= dbuild.LINK_BYTES_PER_ROW,
              f"graph chunks ({label}): {per_row:.1f} B a joined row > LINK_BYTES_PER_ROW")
        del links
    check(budget == 2 * m, f"graph chunks: the card's budget cut {2 * m} nodes into chunks")
    check(nchunks >= 4, f"graph chunks: {nchunks} chunks < 4")


# the reference's 30 Mb run (artifacts/val30mb_r5/run.log): 15 blocks of
# ~31.8M raw rows, 473,961,288 in all, ~31.2M kmers kept
SCALE = dict(n_blocks=15, rows=473_961_288, kmers=31_200_000, absent=2)


def scale_blocks(torch, sd, dev, n_blocks, rows, kmers, absent, seed=30):
    """Synthetic raw blocks built on the card and spilled to `sd`: genome
    kmer g in every block i but those with (7 g + i) % n_blocks < absent,
    with count 1-6, nbc 1-3 and random masks a block (all pass the filter);
    the other rows single-block "error" kmers of count 1 and nbc 1
    (dropped).  Words: an odd-multiplier bijection of the id (distinct
    leading words), a second hash, the id.  -> (blocks as memory maps,
    the kept count sum the construction implies)."""
    from supernova_tpu_torch.core.kmer_codec import W3
    from supernova_tpu_torch.kmer import count as kcount

    g = torch.Generator(device=dev).manual_seed(seed)
    errors = rows - kmers * (n_blocks - absent)
    gid = torch.arange(kmers, device=dev)
    count_sum = 0
    for i in range(n_blocks):
        genome = gid[(gid * 7 + i) % n_blocks >= absent]
        ng = genome.shape[0]
        ids = torch.cat([genome, kmers + torch.arange(errors * i // n_blocks,
                                                      errors * (i + 1) // n_blocks, device=dev)])
        n = ids.shape[0]
        rand = lambda lo, hi, k: torch.randint(lo, hi, (k,), device=dev, generator=g,
                                               dtype=torch.int32)
        count = torch.ones(n, dtype=torch.int32, device=dev)
        count[:ng] = rand(1, 7, ng)
        nbc = torch.ones_like(count)
        nbc[:ng] = rand(1, 4, ng)
        ign = torch.zeros_like(count)
        ign[:ng] = (torch.rand(ng, device=dev, generator=g) < 0.1).int()
        stats = (nbc << 9) | (rand(0, 256, n) << 1) | ign
        count_sum += int(count[:ng].sum())
        a = (ids * 2654435761 + 12345) & 0xFFFFFFFF
        order = torch.sort(a).indices
        raw = kcount.RawBlockTable(
            W3(a[order], ((ids * 40503 + 17) & 0xFFFFFFFF)[order], ids[order]),
            count[order], stats[order], torch.tensor(n))
        sd.save(i, kcount.raw_block_columns(raw))
        del raw, ids, a, order
    return [sd.load(i) for i in range(n_blocks)], count_sum


def phase_scale_merge(torch, dev, n_blocks, rows, kmers, absent):
    """The partitioned merge and the adjacency recompute at the size of the
    reference's 30 Mb run, under the card's own budget and cut into >= 4
    partitions: equal tables, the n_valid and kept count sum the
    construction implies, strictly ascending."""
    from supernova_tpu_torch import convert
    from supernova_tpu_torch.core import kmer_codec as kc
    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.kmer.spill import SpillDir

    dev = torch.device(dev)
    print(f"[scale] host RSS before the phase {kcount._rss_gb():.2f} GB")
    t0 = time.perf_counter()
    with SpillDir(None, {}) as sd:
        blocks, count_sum = scale_blocks(torch, sd, dev, n_blocks, rows, kmers, absent)
        print(f"[scale] {n_blocks} sorted raw blocks, {sum(len(b[0]) for b in blocks)} raw rows "
              f"({kmers} kmers in {n_blocks - absent} blocks each, the rest single-block "
              f"count-1 kmers) built on the card and spilled at 20 B a row in "
              f"{time.perf_counter() - t0:.1f} s")
        tables = []
        for label, merge_rows, min_parts in (("card budget", None, 2), ("cut", rows // 3, 4)):
            torch.cuda.empty_cache()
            budget = kcount.merge_row_limit(dev)
            info = {}
            table, merge_s, merge_peak, ml = measured(torch, lambda: kcount.merge_blocks(
                blocks, dev, kcount.MIN_FREQ, kcount.MIN_BC, merge_rows, info))
            parts = info["partitions"]
            check(parts >= min_parts, f"scale merge ({label}): {parts} partitions < {min_parts}")
            check(ml["sort"] >= parts and ml["compact"] >= parts,
                  f"scale merge ({label}): K4/K2 not launched in every partition")
            merge_per_row = merge_peak * 2**30 / max(info["partition_rows"])
            check(merge_per_row <= kcount.MERGE_BYTES_PER_ROW,
                  f"scale merge took {merge_per_row:.1f} B/row > MERGE_BYTES_PER_ROW")
            m = table.words.a.shape[0]
            chunk = kcount.join_chunk_rows(dev, m)
            table, fin_s, fin_peak, fl = measured(torch, lambda: kcount.recompute_adjacencies(table))
            join_per_row = fin_peak * 2**30 / (m + chunk)
            check(join_per_row <= kcount.JOIN_BYTES_PER_ROW,
                  f"recompute took {join_per_row:.1f} B/joined row > JOIN_BYTES_PER_ROW")
            n = int(table.n_valid)
            kept = int(table.count[:n].sum())
            check(n == kmers, f"scale merge ({label}): n_valid {n} != {kmers}")
            check(kept == count_sum, f"scale merge ({label}): kept count sum {kept} != {count_sum}")
            w = table.words
            check(bool(kc.lex_lt(kc.W3(w.a[: n - 1], w.b[: n - 1], w.c[: n - 1]),
                                 kc.W3(w.a[1:n], w.b[1:n], w.c[1:n])).all()),
                  f"scale merge ({label}): table not strictly ascending")
            print(f"[scale] merge ({label}, budget {budget} rows): {parts} partitions of "
                  f"{info['partition_rows']} raw rows; wall {merge_s:.3f} s, device peak "
                  f"{merge_peak:.3f} GiB = {merge_per_row:.1f} B a row of the largest partition "
                  f"(MERGE_BYTES_PER_ROW {kcount.MERGE_BYTES_PER_ROW}); K4 "
                  f"{ml['sort'] / parts:.2f}, K2 {ml['compact'] / parts:.2f} launches a partition; "
                  f"host peak RSS {info['peak_rss_gb']:.2f} GB")
            print(f"[scale] finalize ({label}): adjacency recompute of {m} rows, query chunks of "
                  f"{chunk}: wall {fin_s:.3f} s, device peak {fin_peak:.3f} GiB = "
                  f"{join_per_row:.1f} B a joined row (JOIN_BYTES_PER_ROW "
                  f"{kcount.JOIN_BYTES_PER_ROW}), K4 {fl['sort']} launches; n_valid {n}, kept "
                  f"count sum {kept}: as constructed; strictly ascending")
            tables.append(convert.table_to_numpy(table))
            del table
        del blocks
    same_table(tables[0], tables[1], "scale merge")
    print("[scale] the card-budget and the cut merges give the same table")


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
    check_sort(torch, words, f"{raw_rows} rows x 3 keys (merge)")
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


def phase_graph_sort(torch, kmers):
    """K4 at the graph's chain-order sort (dbg/build.py materialize_edges:
    lex_argsort(head, dist) over two oriented nodes a kmer): synthetic
    chains of 1-360 nodes in a random node order, keys (chain head's node
    id, distance from the head)."""
    rows = 2 * kmers
    g = torch.Generator(device="cuda").manual_seed(4)
    order = torch.randperm(rows, device="cuda", generator=g)
    lengths = torch.randint(1, 361, (rows // 120 + 1,), device="cuda", generator=g)
    starts = torch.cumsum(lengths, 0) - lengths
    starts = starts[starts < rows]
    is_start = torch.zeros(rows, dtype=torch.bool, device="cuda")
    is_start[starts] = True
    chain = torch.cumsum(is_start.long(), 0) - 1
    pos = torch.arange(rows, device="cuda")
    head = torch.empty(rows, dtype=torch.int64, device="cuda")
    dist = torch.empty_like(head)
    head[order] = order[starts[chain]]
    dist[order] = pos - starts[chain]
    check_sort(torch, (head, dist), f"{rows} rows x 2 keys (graph chain order)")


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
    genome_dir = tempfile.mkdtemp()
    writer = start_fastq_writer(genome_dir)
    try:
        return run_phases(torch, smi, t_start, genome_dir, writer)
    finally:
        if writer.is_alive():
            writer.terminate()
        writer.join()
        Background.stop_all()
        shutil.rmtree(genome_dir, ignore_errors=True)


def run_phases(torch, smi, t_start, genome_dir, writer) -> int:
    """Every phase after the card check; the genome's FASTQs come from
    `writer` into genome_dir."""
    from supernova_tpu_torch.ops.kernels import _lib

    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.library()
    print(f"[build] {lib_path.relative_to(_lib.PKG_DIR.parent)} in "
          f"{time.perf_counter() - t0:.2f} s")

    from supernova_tpu_torch.kmer import count as kcount
    from supernova_tpu_torch.pipeline import datasets

    dev = torch.device("cuda", 0)
    phase_s = {}

    def timed(name, fn, *a, **kw):
        """fn(*a, **kw), its wall kept under `name` and printed."""
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    rs_full = timed("simulate full slice", datasets.simulate, datasets.FULL, datasets.FULL_SEED)
    print(f"[data] full slice: {rs_full.n_reads} reads, {int(rs_full.offsets[-1])} bases")
    kres = timed("kernels", phase_kernels, torch, rs_full, dev)
    torch.cuda.empty_cache()
    kres["scan_max"] = timed("scan_max", phase_scan_max, torch, dev)
    torch.cuda.empty_cache()
    rs_small = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    timed("small", phase_small_slice, torch, rs_small)
    timed("small mixed", phase_small_slice, torch, datasets.r1_trimmed(rs_small), "small mixed",
          block_positions=300_000)
    timed("small run_full", phase_small_run_full, torch)
    del rs_small
    with tempfile.TemporaryDirectory() as d:
        n_fresh = timed("cli", phase_cli, torch, d)
    with tempfile.TemporaryDirectory() as d:
        bg_full = timed("full", phase_slice, torch, rs_full, "full", d)[3]
    torch.cuda.empty_cache()
    mesh_launches = timed("mesh", phase_mesh, torch, rs_full, bg_full, dev, smi, kres)
    del rs_full, bg_full
    torch.cuda.empty_cache()
    # needs no genome: runs while the writer simulates it
    timed("scale", phase_scale_merge, torch, dev, **SCALE)
    torch.cuda.empty_cache()

    d = genome_dir
    launches, crec, table, bg, rs_genome, patch_rec, sg = timed(
        "fastq run", phase_fastq_run, torch, dev, d, writer)
    torch.cuda.empty_cache()
    timed("supergraph glue", phase_glue, torch, dev, sg, rs_genome, f"{d}/asm", kres)
    torch.cuda.empty_cache()
    mesh_glue_launches = timed("mesh glue", phase_mesh_glue, torch, dev, sg, rs_genome,
                               f"{d}/asm", smi)
    torch.cuda.empty_cache()
    timed("resume", phase_resume, torch, rs_genome, d, sg)
    torch.cuda.empty_cache()
    evaluate, genome_asm = timed("scaffold", phase_scaffold, torch, dev, d)
    torch.cuda.empty_cache()
    links_launches = timed("mesh links", phase_mesh_links, torch, dev, genome_asm, smi, kres)
    timed("mesh phase", phase_mesh_phase, torch, dev, genome_asm, smi)
    fmindex_launches = timed("fmindex", phase_fmindex, torch, dev, genome_asm, smi, kres)
    del genome_asm
    torch.cuda.empty_cache()
    timed("patch kernels", phase_kernels_patch, torch, dev, bg, d, kres,
          patch_rec.get("save_s", 0.0))
    torch.cuda.empty_cache()
    timed("derived kernels", phase_kernels_derived, torch, rs_genome, dev, kres, crec)
    shutil.rmtree(f"{d}/asm")
    sg_launches = sg["launches"]
    del sg
    torch.cuda.empty_cache()
    bg.__dict__.pop("_device_arrays", None)  # its segments would stay pinned
    torch.cuda.empty_cache()
    raw_rows = timed("genome count", phase_genome_count, torch, rs_genome, table, dev)
    timed("block prep", phase_block_prep, torch, rs_genome, dev)
    timed("general vs fused", phase_general_vs_fused, torch, bg, rs_genome, dev)
    rs_mixed = first_barcodes(datasets.r1_trimmed(rs_genome), MIXED_FRACTION)
    del rs_genome, bg
    torch.cuda.empty_cache()
    print(f"[data] mixed genome (every R1 cut by {datasets.R1_SKIP} bases; the barcodes of "
          f"{MIXED_FRACTION:.0%} of its reads): {rs_mixed.n_reads} reads, "
          f"{int(rs_mixed.offsets[-1])} bases")
    timed("mixed kernels", phase_kernels_mixed, torch, rs_mixed, dev, kres)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d, fixed_blocks(kcount.BLOCK_POSITIONS):
        launches_mixed, _, table_mixed, bg_mixed, _ = timed(
            "mixed", phase_slice, torch, rs_mixed, "mixed", d, min_blocks=2)
    torch.cuda.empty_cache()
    timed("mixed count", phase_mixed_count, torch, rs_mixed, table_mixed, dev)
    timed("mixed paths", phase_mixed_paths, torch, bg_mixed, rs_mixed, dev)
    del rs_mixed, bg_mixed, table_mixed
    torch.cuda.empty_cache()
    timed("graph chunks", phase_graph_chunks, torch, table, dev)
    torch.cuda.empty_cache()
    timed("merge", phase_merge, torch, raw_rows)
    torch.cuda.empty_cache()
    timed("graph sort", phase_graph_sort, torch, table.n_valid)
    del table
    timed("fleet", phase_fleet, torch, smi)

    timed("evaluate wait", report_evaluate, evaluate)

    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "supernova_tpu"))
    check(not jax_mods, f"the port imported {jax_mods[:5]}")
    print(f"[imports] no jax and no supernova_tpu module in sys.modules, nor in the "
          f"{n_fresh + 1} fresh `python -m supernova_tpu_torch` processes ([cli], [evaluate])")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
             library_ms=r.get("library_ms"), mixed_launches=launches_mixed[name],
             patch_launches=patch_rec.get("rebuild_launches", {}).get(name, 0),
             supergraph_launches=sg_launches[name], mesh_launches=mesh_launches[name],
             mesh_glue_launches=mesh_glue_launches.get(name, 0),
             links_launches=links_launches[name], fmindex_launches=fmindex_launches[name],
             **{k: v for k, v in r.items() if k not in COMMON_KEYS})
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
