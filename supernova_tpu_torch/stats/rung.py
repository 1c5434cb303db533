"""A genome-size rung of the reference's validation ladder on one device:
simulated 10x FASTQs through the Pipeline's stages and the command line's
`run --resume` and `evaluate`, one JSON line a step.

    python -m supernova_tpu_torch.stats.rung --out DIR --genome-size N --repeats R \\
        --barcodes B --whitelist-size W --seed S \\
        [--through count|graph|paths|patch|supergraph|scaffold|fasta|evaluate] \\
        [--device cuda|cpu] [--check-96m]

The rungs are the reference's scripts/val*mb.sh; the 100 Mb one is
--genome-size 100000000 --repeats 2000 --barcodes 40000 --whitelist-size
163840 --seed 13, the 10 Mb one (held through evaluate to the JAX
package's own run of the same reads, rung_records/val10mb_cpu.json)
--genome-size 10000000 --repeats 200 --barcodes 4000 --whitelist-size 16384
--seed 11.  Steps:
  1. simulate with `simulate`'s model (cli.simulate_sample; its other
     arguments at their defaults) and 2. write the reads as LANES
     bcl2fastq-named lanes of 10x FASTQs, one forked process a lane, with
     `simulate`'s whitelist.txt and truth files, all in DIR/sim by a process
     of its own (its memory goes back when it ends); skipped when DIR/sim
     holds them;
  3. discovery, preflight and ingest_10x_fastqs of the lanes (DIR/run's
     reads.npz instead when an earlier run left it), then
     Pipeline(DIR/run, device, resume=True): stage_ingest (reads.npz) and,
     for --through count, graph, paths or patch, those stages in order.
     Every stage leaves its checkpoint, so a cut run started again resumes
     without recounting (the count from its spills, DIR/run/count_spill,
     in the blocks they were counted in);
  4. past patch: `python -m supernova_tpu_torch run --resume --flavors
     raw,pseudohap` on DIR/run through cli.main in this process (its
     printed summary goes to stderr), which reloads reads.npz and runs
     every stage itself (count, graph, paths, patch, supergraph and
     scaffold: the star-gap phases or the legacy scaffolder), then writes
     the FASTA flavors, GFA, super files, histograms, report and summary
     files, exactly as the command does: a one-shot run's files (a
     resumed run's StatLogger forgets which keys summary.json holds, in
     both packages).  --through supergraph or scaffold stops the command
     after that stage's line; "fasta" is everything after the scaffold
     stage to the command's exit;
  5. --through evaluate: `python -m supernova_tpu_torch evaluate` of the
     pseudohap against the simulated haplotypes in a fresh process, its
     output in DIR/eval.json.
Each step prints one JSON line: wall; the stage's device peak; its host
peak RSS, and the anonymous and file-backed parts apart (RssAnon, RssFile
of /proc/self/status, sampled); free disk in DIR before and after; the
stage's kernel launches; and its counts (block budget, blocks, raw rows,
partitions, kmers, edges, reads, placed_perc; the patch's closures and its
rebuild's kmers; the supergraph's glue route, positions and overflow; the
scaffold's mode, joins, each phase's wall, the het DP's pairs and seconds
and the scaffolds; each FASTA flavor's records and bases; evaluate's
dict).  --check-96m (after the paths stage, before the patch stage): when
the count's kmers differ from the reference's, the count again at the
reference's 96M-position blocks, its raw rows and its table held to the
stage's (range_recount: a range of leading words at a time, so its spill
fits a chip call's disk); else the raw rows at those blocks (each block
counted on the device and dropped).  Either line gives each block's raw
rows as well as their sum.  The last line holds the reference's recorded
numbers for the rungs in REFERENCE beside this run's, each "equal",
"differs" or "not run" (a block at a time for the per-block raw rows; a
record file's keys as stats/rung_record.py flattens them, the whole
comparison also in DIR/compare.json; past the outputs, this run's own
record in DIR/record.json).

DIR needs room: the count spills ~20 B a raw row of its blocks (the 100 Mb
rung: ~1.2e9 raw rows at an H100's blocks, 2.4e9 at 96M), and reads.npz,
the lazy read store (reads.lazy/, above 2e9 bases), the FASTQs and the
checkpoints take ~25 GB more.  The device is "cuda" unless asked; without a
card it exits 1.  Imports no jax and nothing of supernova_tpu.
"""
from __future__ import annotations

import argparse
import json
import logging
import multiprocessing
import os
import resource
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import rung_record as rr

# 10x lanes the FASTQs are written as, one process each
LANES = 8
STAGES = ("count", "graph", "paths", "patch", "supergraph", "scaffold", "fasta", "evaluate")
# the numbers the reference recorded for its rungs, by (genome size,
# repeats, barcodes, whitelist size, seed)
REFERENCE = {
    (100_000_000, 2000, 40000, 163840, 13): dict(
        source="scripts/val100mb.sh; artifacts/val100mb_r5/stage_walls.log:1,71,90",
        kmers=103_997_650, raw_rows_96m=2_438_263_316, patch_kmers=103_998_749),
    (10_000_000, 200, 4000, 16384, 11): dict(
        source="scripts/val10mb.sh; supernova_tpu_torch/stats/rung_records/val10mb_cpu.json",
        record="val10mb_cpu.json"),
    (30_000_000, 600, 12000, 49152, 12): dict(
        source="scripts/val30mb.sh; artifacts/val30mb_r5/sim.log, run.log:3-18,36",
        pairs=4_733_324, raw_rows_96m=473_961_288, kmers=31_187_695,
        raw_rows_96m_blocks=[31_907_647, 31_884_451, 31_850_176, 31_807_464, 31_803_303,
                             31_824_225, 31_767_361, 31_884_039, 31_869_196, 31_891_607,
                             31_807_020, 31_715_841, 31_762_519, 31_766_172, 28_420_267]),
}
REFERENCE_BLOCK = 96_000_000  # the reference's count block (its raw rows are at this size)
# leading-word ranges of the 96M recount: a quarter of its spill on disk at
# a time (12 GB at the 100 Mb rung, beside ~20 GB of FASTQs, reads and
# checkpoints, within a chip call's 45 GiB of disk writes)
RECOUNT_PARTS = 4

_LANE_READS = None  # the SimReads the forked lane writers read


def _write_lane(job):
    """One lane of _LANE_READS as bcl2fastq-named R1/R2 FASTQs."""
    from ..ingest.tenx import write_sim_fastqs
    from ..sim.genome import SimReads

    lane, lo, hi, root, sample = job
    part = SimReads(**{f: getattr(_LANE_READS, f)[lo:hi] for f in (
        "r1", "q1", "r2", "q2", "barcode", "bc_qual", "truth_pos", "truth_hap")})
    r1, r2 = write_sim_fastqs(part, f"{root}/lane{lane}")
    for mate, path in (("R1", r1), ("R2", r2)):
        Path(path).rename(f"{root}/{sample}_S1_L{lane:03d}_{mate}_001.fastq.gz")
    os.rmdir(f"{root}/lane{lane}")


def write_lanes(reads, root, sample: str, lanes: int = LANES):
    """SimReads as `lanes` lanes of 10x FASTQs named
    {sample}_S1_L00{lane}_R{1,2}_001.fastq.gz (ingest/tenx.py's
    write_sim_fastqs on contiguous slices of the pairs), written by forked
    processes that touch no CUDA state."""
    global _LANE_READS
    n = reads.n_pairs()
    cuts = [n * k // lanes for k in range(lanes + 1)]
    os.makedirs(root, exist_ok=True)
    _LANE_READS = reads
    try:
        with multiprocessing.get_context("fork").Pool(lanes) as pool:
            pool.map(_write_lane, [(k + 1, cuts[k], cuts[k + 1], root, sample)
                                   for k in range(lanes)])
    finally:
        _LANE_READS = None


def _simulate_and_write(sim_args, simdir: Path):
    """Steps 1-2 in this (forked) process: the reads, their lanes, the
    whitelist and truth files, then sim.json with the walls last (its
    presence marks the directory complete)."""
    from ..cli import simulate_sample, write_sample_truth

    t0 = time.perf_counter()
    reads, wl, g, hb = simulate_sample(sim_args)
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_lanes(reads, simdir, "RUNG")
    write_sample_truth(simdir, wl, g, hb)
    (simdir / "sim.json").write_text(json.dumps(dict(
        pairs=reads.n_pairs(), simulate_s=sim_s, write_s=time.perf_counter() - t0)))


def rss_parts() -> dict:
    """This process's resident bytes: VmRSS, and its anonymous and
    file-backed parts, from /proc/self/status (RssAnon, RssFile) or, where
    the kernel has no such lines, from /proc/self/smaps (the Anonymous
    sums, and the rest of the Rss sums)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key = line.split(":", 1)[0]
            if key in ("VmRSS", "RssAnon", "RssFile"):
                out[key] = int(line.split()[1]) * 1024
    if "RssAnon" not in out:
        rss = anon = 0
        with open("/proc/self/smaps") as f:
            for line in f:
                if line.startswith("Rss:"):
                    rss += int(line.split()[1]) * 1024
                elif line.startswith("Anonymous:"):
                    anon += int(line.split()[1]) * 1024
        out.update(RssAnon=anon, RssFile=rss - anon)
    return out


class RssSampler:
    """The high-waters of rss_parts(), sampled on a daemon thread."""

    KEYS = ("VmRSS", "RssAnon", "RssFile")

    def __init__(self, period_s: float = 1.0):
        self.period_s = period_s
        self.peak = dict.fromkeys(self.KEYS, 0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        for key, v in rss_parts().items():
            self.peak[key] = max(self.peak[key], v)

    def _run(self):
        while not self._stop.wait(self.period_s):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sample()
        return False

    def gb(self) -> dict:
        return {f"host_{k}_peak_gb": round(v / 1e9, 3) for k, v in self.peak.items()}


def _disk_free_gb(path) -> float:
    return round(shutil.disk_usage(path).free / 1e9, 3)


def emit(line: dict, file=None) -> None:
    print(json.dumps(line), file=file or sys.stdout, flush=True)


def _step(name: str, out: Path, fn):
    """fn() with the host RSS sampled and the free disk read before and
    after -> (fn's result, the line's common fields)."""
    before = _disk_free_gb(out)
    t0 = time.perf_counter()
    with RssSampler() as rss:
        res = fn()
    return res, dict(step=name, wall_s=round(time.perf_counter() - t0, 3), **rss.gb(),
                     disk_free_gb_before=before, disk_free_gb_after=_disk_free_gb(out))


def simulate_step(sim_args, simdir: Path, out: Path) -> dict:
    """Steps 1-2 (or nothing, where DIR/sim is complete) -> sim.json."""
    if not (simdir / "sim.json").exists():
        simdir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        proc = multiprocessing.get_context("fork").Process(
            target=_simulate_and_write, args=(sim_args, simdir))
        proc.start()
        proc.join()
        if proc.exitcode != 0:
            raise RuntimeError(f"the simulation process exited {proc.exitcode}")
        sim = json.loads((simdir / "sim.json").read_text())
        emit(dict(step="simulate", wall_s=round(time.perf_counter() - t0, 3),
                  simulate_s=round(sim["simulate_s"], 3), write_s=round(sim["write_s"], 3),
                  pairs=sim["pairs"], lanes=LANES,
                  fastq_bytes=sum(p.stat().st_size for p in simdir.glob("*.fastq.gz")),
                  children_max_rss_gb=round(
                      resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024 / 1e9, 3),
                  disk_free_gb_after=_disk_free_gb(out)))
        return sim
    sim = json.loads((simdir / "sim.json").read_text())
    emit(dict(step="simulate", skipped=True, pairs=sim["pairs"]))
    return sim


def fastq_readset(simdir: Path, rundir: Path, out: Path):
    """Step 3's ReadSet: DIR/run/reads.npz when a cut run left it, else
    discovery, preflight and ingest_10x_fastqs of the lanes."""
    from ..ingest.discovery import discover_input_fastqs
    from ..ingest.reads import ReadSet
    from ..ingest.tenx import ingest_10x_fastqs, load_whitelist
    from ..pipeline.preflight import preflight

    ck = rundir / "reads.npz"
    if ck.exists():
        rs, line = _step("reads.npz", out, lambda: ReadSet.load(ck))
    else:
        def ingest():
            found = discover_input_fastqs(str(simdir))
            if found["mode"] != "ILMN_BCL2FASTQ" or len(found["r1"]) != LANES:
                raise RuntimeError(f"discovery found {found['mode']}, {len(found['r1'])} R1 files")
            wl = load_whitelist(str(simdir / "whitelist.txt"))
            pf = preflight(found["r1"], found["r2"], len(wl))
            if not pf.ok:
                raise RuntimeError(f"preflight errors {pf.errors}")
            return ingest_10x_fastqs(found["r1"], found["r2"], wl)

        rs, line = _step("fastq ingest", out, ingest)
    emit(dict(line, reads=rs.n_reads, bases=int(rs.offsets[-1]),
              barcoded_perc=round(100 * float((rs.bc > 0).mean()), 3) if rs.n_reads else 0.0))
    return rs


def raw_blocks(rs, device, block: int):
    """Each block's raw table (kcount.count_block_raw) at `block`-position
    blocks, cut and padded as count_readset_blocked cuts and pads them,
    counted on the device one at a time."""
    from ..kmer import count as kcount

    blocks = kcount.split_readset_blocks(rs, block)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    for b in blocks:
        p = kcount.prepare_reads(b, device, pad_to_positions=pad_pos, pad_to_reads=pad_rd)
        yield kcount.count_block_raw(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                                     p["uniform_rl"])


def raw_rows_at(rs, device, max_positions: int) -> list[int]:
    """The readset's raw rows (each block's distinct kmers) at blocks of
    max_positions, as count_readset_blocked spills them: each block
    counted on the device and dropped -> each block's raw rows."""
    return [int(raw.n_valid) for raw in raw_blocks(rs, device, max_positions)]


def raw_rows_96m(rs, device, out: Path) -> list[int]:
    """--check-96m's raw rows at the reference's blocks (one line) ->
    each block's."""
    rows, line = _step("raw rows at 96M", out, lambda: raw_rows_at(
        rs, device, REFERENCE_BLOCK))
    emit(dict(line, block_positions=REFERENCE_BLOCK, blocks=len(rows), raw_rows=sum(rows),
              block_raw_rows=rows))
    return rows


def range_recount(rs, device, table, spill_dir: Path, block: int, parts: int) -> dict:
    """The count again at `block`-position blocks, held to `table` (the
    count stage's) one range of leading words at a time, so that only one
    range's raw rows are on disk at once: the whole recount's spill (20 B
    a raw row: ~49 GB at the 100 Mb rung) passes a chip call's disk.  For
    each of `parts` ranges every block is counted raw on the device, its
    rows in the range spilled, and the spills merged and filtered
    (kcount.merge_blocks); their extension masks are intersected with
    membership in `table` (recompute_adjacencies with the stage's table as
    the dictionary) and the range's rows compared with the table's.  Equal
    words in every range make that dictionary the recount's own, so equal
    ranges mean equal tables -> blocks, raw rows (in all and of each
    block), kmers, equal."""
    from .. import convert
    from ..core.kmer_codec import W3
    from ..kmer import count as kcount
    from ..kmer import spill

    host = convert.table_to_numpy(table)
    n = host.n_valid
    block_rows = []
    kmers = nblocks = 0
    equal = True
    bounds = [k * (1 << 32) // parts for k in range(parts + 1)]
    for lo, hi in zip(bounds, bounds[1:]):
        with spill.SpillDir(spill_dir, dict(range=[lo, hi], block=block)) as sd:
            for nblocks, raw in enumerate(raw_blocks(rs, device, block), 1):
                a = raw.words.a[: int(raw.n_valid)]
                i0, i1 = (int(torch_searchsorted(a, x)) for x in (lo, hi))
                sub = kcount.RawBlockTable(W3(*(w[i0:i1] for w in raw.words)), raw.count[i0:i1],
                                           raw.stats[i0:i1], i1 - i0)
                if nblocks > len(block_rows):
                    block_rows.append(0)
                block_rows[nblocks - 1] += i1 - i0
                sd.save(nblocks - 1, kcount.raw_block_columns(sub))
                del raw, sub, a
            got = kcount.merge_blocks([sd.load(i) for i in range(nblocks)], device,
                                      kcount.MIN_FREQ, kcount.MIN_BC)
        shutil.rmtree(spill_dir, ignore_errors=True)
        got = convert.table_to_numpy(kcount.recompute_adjacencies(got, dictionary=table.words))
        r0, r1 = np.searchsorted(host.words[0][:n], [lo, hi])
        kmers += got.n_valid
        equal &= got.n_valid == r1 - r0 and all(
            np.array_equal(x[r0:r1], y[: got.n_valid])
            for x, y in zip((*host.words, *host[1:5]), (*got.words, *got[1:5])))
    return dict(blocks=nblocks, raw_rows=sum(block_rows), block_raw_rows=block_rows,
                kmers=kmers, table_equal=bool(equal and kmers == n))


def torch_searchsorted(sorted_col, value: int):
    """First index of the ascending int64 column at or above value."""
    import torch

    return torch.searchsorted(sorted_col, torch.tensor([value], device=sorted_col.device))[0]


def recount_96m(rs, device, table, out: Path) -> list[int]:
    """--check-96m where the kmers differ from the reference's: the count
    again at the reference's blocks, by RECOUNT_PARTS ranges of leading
    words (range_recount; spills under DIR/check_spill, removed after), its
    table held to the stage's (one line) -> each block's raw rows."""
    res, line = _step("count at 96M", out, lambda: range_recount(
        rs, device, table, out / "check_spill", REFERENCE_BLOCK, RECOUNT_PARTS))
    emit(dict(line, block_positions=REFERENCE_BLOCK, parts=RECOUNT_PARTS, **res))
    if not res["table_equal"]:
        raise RuntimeError("the count at 96M-position blocks differs from the stage's table")
    return res["block_raw_rows"]


def _stage_line(pl, name: str, extra: dict) -> dict:
    rec = pl.stage_records.get(name, {})
    return dict(extra, stage=name, stage_wall_s=rec.get("wall_s"),
                device_peak_gib=None if rec.get("peak_gb") is None else round(rec["peak_gb"], 3),
                host_peak_gb=round(rec.get("host_peak_gb", 0.0) * 2**30 / 1e9, 3),
                launches=rec.get("launches"))


def _fields(pl, name: str, res, args: tuple) -> dict:
    """The counts of a stage's line, from its record, the stats and its
    result `res` (args: the stage function's arguments)."""
    rec, st = pl.stage_records.get(name, {}), pl.stats
    if name == "count":
        return dict(kmers=int(res[0].n_valid), resumed_from_kmers_npz="blocks" not in rec,
                    **{k: rec.get(k) for k in ("block_positions", "blocks", "raw_rows",
                                               "partitions", "spilled_blocks", "resumed_blocks",
                                               "oom_retries")})
    if name == "graph":
        return dict(edges=res.n_edges, kmers=int(args[0].n_valid))
    if name == "paths":
        return dict(reads=args[1].n_reads, placed_perc=st.get("placed_perc"),
                    **{k: rec.get(k) for k in ("block_positions", "blocks", "oom_retries")})
    if name == "patch":
        # every valid table row is two oriented nodes of the rebuilt graph
        return dict(gap_pairs=st.get("gap_pairs"), closures=st.get("gap_closures"),
                    rebuild_kmers=int((np.asarray(res[0].node_edge) >= 0).sum()) // 2,
                    edges=res[0].n_edges, placed_perc=st.get("placed_perc"))
    if name == "supergraph":
        return {k: st.get(k) for k in ("glue_route", "glue_positions", "glue_overflow")}
    if name == "scaffold":
        return dict(scaffold_mode=st.get("scaffold_mode") or "legacy",
                    star_gap_joins=st.get("star_gap_joins", 0),
                    barcode_joins=st.get("barcode_joins", 0),
                    phase_s={k: round(v, 3) for k, v in rec.get("phase_s", {}).items()},
                    het_pairs=rec.get("het_pairs"), het_dp_s=rec.get("het_dp_s"),
                    n_scaffolds=st.get("n_scaffolds"))
    return {}


def _note(ours: dict, name: str, fields: dict) -> None:
    """The numbers REFERENCE records from a stage's line: the count's kmers
    and the patch's rebuilt kmers."""
    if name == "count":
        ours["kmers"] = fields["kmers"]
    elif name == "patch":
        ours["patch_kmers"] = fields["rebuild_kmers"]


def check_96m(args, ref, ours: dict, rs, device, table, out: Path) -> None:
    """--check-96m (after the paths stage): the recount where the kmers
    differ from the reference's, else the raw rows at 96M."""
    rows = (recount_96m(rs, device, table, out) if ref and ref.get("kmers") != ours["kmers"]
            else raw_rows_96m(rs, device, out))
    ours.update(raw_rows_96m=sum(rows), raw_rows_96m_blocks=rows)


class _Through(BaseException):
    """Stops `run --resume` after the --through stage's line (a
    BaseException: the orchestrator's retry and cli's crash handling catch
    Exception only)."""


def run_command(args, device, ref, ours: dict, rundir: Path, out: Path) -> None:
    """Step 4: `run --resume --flavors raw,pseudohap` on rundir through
    cli.main in this process (it reloads reads.npz), a line for each of
    run_full's timed stages (--check-96m's after the paths stage's) and one
    for everything after the scaffold stage ("fasta"); stops after the
    --through stage's line where that is supergraph or scaffold."""
    import contextlib

    from .. import cli
    from ..ops import kernels
    from ..pipeline.run import Pipeline

    timed = Pipeline._timed
    held, tail = {}, {}
    stdout = sys.stdout  # the lines' stream: the command's own output goes to stderr

    def observed(pl, name, fn, *a, **kw):
        res, line = _step(name, out, lambda: timed(pl, name, fn, *a, **kw))
        fields = _fields(pl, name, res, a)
        emit(_stage_line(pl, name, dict(line, **fields)), stdout)
        _note(ours, name, fields)
        if name == "count" and args.check_96m:
            held["table"] = res[0]  # through paths, as run_stages holds it
        if name == "paths" and args.check_96m:
            check_96m(args, ref, ours, a[1], device, held.pop("table"), out)
        if name == args.through:
            raise _Through()
        if name == "scaffold":  # the outputs follow: the "fasta" step
            tail.update(t0=time.perf_counter(), disk=_disk_free_gb(out),
                        launches=kernels.launch_counts(), rss=RssSampler().__enter__())
        return res

    argv = ["run", "--fastqs", str(out / "sim"), "--whitelist", str(out / "sim" / "whitelist.txt"),
            "--out", str(rundir), "--resume", "--flavors", ",".join(rr.FLAVORS),
            "--device", str(device)]
    Pipeline._timed = observed
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(argv)
    except _Through:
        return
    finally:
        Pipeline._timed = timed
        if "rss" in tail:
            tail["rss"].__exit__(None, None, None)
    if rc != 0:
        raise RuntimeError(f"run --resume exited {rc}")
    wall = time.perf_counter() - tail["t0"]
    fasta = {fl: rr.fasta_digest(rundir / f"assembly.{fl}.fasta.gz") for fl in rr.FLAVORS}
    emit(dict(step="fasta", wall_s=round(wall, 3), **tail["rss"].gb(),
              disk_free_gb_before=tail["disk"], disk_free_gb_after=_disk_free_gb(out),
              launches=kernels.launches_since(tail["launches"]),
              **{fl: dict(records=d["records"], bases=d["bases"]) for fl, d in fasta.items()}))


def evaluate_step(rundir: Path, out: Path) -> dict:
    """Step 5: `python -m supernova_tpu_torch evaluate` of the pseudohap in a
    fresh process, its output in DIR/eval.json -> its dict."""
    sim = out / "sim"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[2]), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    with open(out / "eval.json", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "supernova_tpu_torch", "evaluate", "--fasta",
             str(rundir / "assembly.pseudohap.fasta.gz"), "--truth",
             str(sim / "truth_hap_a.npy"), str(sim / "truth_hap_b.npy")], stdout=f, env=env)
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode != 0:
        raise RuntimeError(f"evaluate exited {proc.returncode}")
    res = rr.load_eval(out / "eval.json")
    emit(dict(step="evaluate", wall_s=round(time.perf_counter() - t0, 3),
              process_max_rss_gb=round(usage.ru_maxrss * 1024 / 1e9, 3), **res))
    return res


def _result(want, got):
    """"equal", "differs" or "not run"; for a list (a number a block), one
    of them for each element, and "differs" for every block past the
    shorter list."""
    if got is None:
        return "not run"
    if isinstance(want, list):
        n = max(len(want), len(got))
        return ["equal" if i < min(len(want), len(got)) and want[i] == got[i] else "differs"
                for i in range(n)]
    return "equal" if got == want else "differs"


def run_stages(args, device, ref, ours: dict, pl, rs, out: Path) -> None:
    """Step 3's stages from count to --through (patch at most), each
    through the Pipeline's own stage call."""
    through = STAGES.index(args.through)

    def stage(name, fn, *a):
        res, line = _step(name, out, lambda: pl._stage(name, fn, *a))
        fields = _fields(pl, name, res, a)
        emit(_stage_line(pl, name, dict(line, **fields)))
        _note(ours, name, fields)
        return res

    table, rs = stage("count", pl._count_with_cov_guard, rs)
    if through >= 1:
        bg = stage("graph", pl.stage_graph, table)
    if through >= 2:
        rp = stage("paths", pl.stage_paths, bg, rs)
    if args.check_96m:
        check_96m(args, ref, ours, rs, device, table, out)
    if through >= 3:
        del table
        stage("patch", pl.stage_patch, bg, rp, rs)


def run_rung(args, device) -> int:
    from ..pipeline.run import Pipeline

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        emit(dict(step="card", nvidia_smi=smi.stdout.strip()))
    key = (args.genome_size, args.repeats, args.barcodes, args.whitelist_size, args.seed)
    ref = REFERENCE.get(key)
    from ..cli import build_parser

    sim_args = build_parser().parse_args([
        "simulate", "--out", str(out / "sim"), "--genome-size", str(args.genome_size),
        "--repeats", str(args.repeats), "--barcodes", str(args.barcodes),
        "--whitelist-size", str(args.whitelist_size), "--seed", str(args.seed)])
    sim = simulate_step(sim_args, out / "sim", out)
    rundir = out / "run"
    rundir.mkdir(exist_ok=True)
    rs = fastq_readset(out / "sim", rundir, out)

    pl = Pipeline(rundir, device=device, resume=True)
    ours = {"pairs": sim["pairs"]}
    rs, line = _step("ingest", out, lambda: pl._stage("ingest", pl.stage_ingest, rs))
    emit(_stage_line(pl, "ingest", dict(line, reads=rs.n_reads, lazy=bool(rs.is_lazy))))
    through = STAGES.index(args.through)
    if through <= STAGES.index("patch"):
        run_stages(args, device, ref, ours, pl, rs, out)
    else:
        # the command runs every stage itself, from reads.npz, so that what
        # it writes is a one-shot run's (a resumed StatLogger loses which
        # keys summary.json holds)
        del rs, pl
        run_command(args, device, ref, ours, rundir, out)
    ev = evaluate_step(rundir, out) if args.through == "evaluate" else None
    compare = {}
    for k, want in (ref or {}).items():
        if k in ("source", "record"):
            continue
        got = ours.get(k)
        compare[k] = dict(reference=want, ours=got, result=_result(want, got))
    line = dict(step="compare", rung=dict(zip(("genome_size", "repeats", "barcodes",
                                               "whitelist_size", "seed"), key)),
                source=(ref or {}).get("source"), compare=compare)
    flat = dict(ours)
    if through >= STAGES.index("fasta"):
        rec = rr.assembly_record(rundir, ev, pairs=sim["pairs"])
        (out / "record.json").write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
        flat.update(rr.flatten(rec))
    if ref and ref.get("record"):
        compare.update(rr.compare(rr.flatten(rr.load_record(ref["record"])), flat))
        results = [x["result"] for x in compare.values()]
        line["counts"] = {r: results.count(r) for r in ("equal", "differs", "not run")}
    (out / "compare.json").write_text(json.dumps(line, indent=1) + "\n")
    emit(line)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(
        prog="python -m supernova_tpu_torch.stats.rung",
        description="A validation rung: simulated 10x FASTQs through count, graph, paths and "
                    "patch, then `run --resume` (supergraph, scaffold, the FASTA flavors) and "
                    "`evaluate`, one JSON line a step, held to REFERENCE's records.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--genome-size", type=int, required=True)
    ap.add_argument("--repeats", type=int, required=True)
    ap.add_argument("--barcodes", type=int, required=True)
    ap.add_argument("--whitelist-size", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--through", choices=STAGES, default="patch",
                    help="the last step: a Pipeline stage (count, graph, paths, patch), a "
                         "stage of `run --resume` (supergraph, scaffold), its outputs (fasta) "
                         "or `evaluate` of the pseudohap (default: patch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-96m", action="store_true")
    args = ap.parse_args(argv)
    from ..core.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:  # no card: no CPU fallback
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    return run_rung(args, device)


if __name__ == "__main__":
    sys.exit(main())
