"""The port's Pipeline: the base-graph slice of supernova_tpu's main path.

    ReadSet -> stage_ingest -> stage_count -> stage_graph -> stage_paths
            -> (KmerTable, BaseGraph, ReadPaths)

as supernova_tpu/pipeline/run.py runs it on one device.  Readsets above
one count block take the blocked count and pather; the count stage's
record then holds its block, row, partition, spill and OOM-retry counts.
stage_count and stage_graph write kmers.npz,
stats/histogram_kmer_count.json and graph.npz
in the reference's formats and log kmers_distinct, n_edges, edge_N50 and
assembly_checksum.  stage_paths runs the pather, then the reference's
qual-tolerant rescue (align/rescue.py) and extend_paths (asm/bads.py) on
the host, writes paths.npz (align/pathzip.py) and ebcx.npz
(align/index.py), and logs paths_rescued, paths_extended and placed_perc
as the reference does.  all_stats.json is rewritten after every stage.
"""
from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..align import index as pindex
from ..align import pather, pathzip
from ..align import rescue as arescue
from ..asm import bads as abads
from ..core.device import resolve_device
from ..dbg import build as dbuild
from ..dbg import graph as dgraph
from ..ingest.ingest import valid_barcode_fraction
from ..ingest.reads import ReadSet
from ..kmer import count as kcount
from ..stats import gems as sgems
from ..stats import histograms as hist
from ..stats.logger import StatLogger, n50
from ..stats.trace import stage

log = logging.getLogger("supernova_tpu_torch")


class Pipeline:
    def __init__(self, outdir: str | Path, device: str | torch.device):
        self.device = resolve_device(device)
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.stats = StatLogger.load(self.outdir / "all_stats.json")
        self.stage_records: dict[str, dict] = {}

    def _timed(self, name, fn, *a, **kw):
        """Run one stage under the stage timer and persist the stats."""
        rec = self.stage_records.setdefault(name, {})
        with stage(name, self.device, self.stats, rec):
            out = fn(*a, **kw)
        self.stats.dump_json(self.outdir / "all_stats.json")
        return out

    def run(self, rs: ReadSet):
        """The whole slice, each stage timed -> (table, bg, rp)."""
        rs = self._timed("ingest", self.stage_ingest, rs)
        table = self._timed("count", self.stage_count, rs)
        bg = self._timed("graph", self.stage_graph, table)
        rp = self._timed("paths", self.stage_paths, bg, rs)
        return table, bg, rp

    # ---------------------------------------------------------------- stages

    def stage_ingest(self, rs: ReadSet) -> ReadSet:
        """Checkpoint the reads and log the input stats (reference
        run.py:114-223, without user downsampling and the disk-memmap
        re-homing above 2 Gb, which one count block never reaches)."""
        ck = self.outdir / "reads.npz"
        if not ck.exists():
            rs.save(ck)
        self.stats.log("nreads", rs.n_reads, "number of reads", cs=True, stage="ingest")
        self.stats.log(
            "mean_read_len", float(np.mean(rs.lengths())) if rs.n_reads else 0.0,
            "mean input read length", cs=True, stage="ingest",
        )
        if rs.barcoded:
            self.stats.log(
                "valid_bc_perc", 100.0 * valid_barcode_fraction(rs),
                "% reads with valid barcode", cs=True, stage="ingest",
            )
            rpb = np.diff(rs.bci)[1:]  # reads per real barcode
            self.stats.log("rpb_N50", n50(rpb[rpb > 0]), "N50 reads per barcode", cs=True)
            total_bc_reads = int(rpb.sum())
            if total_bc_reads:
                big = int(rpb[rpb >= 50_000].sum())
                self.stats.log(
                    "big_bc_perc", 100.0 * big / total_bc_reads,
                    "% reads in >=50k-read barcodes", stage="ingest",
                )
            n_gems = sgems.estimate_gem_count(rs.bci, rs.n_barcodes)
            if n_gems:
                self.stats.log(
                    "est_gem_count", n_gems,
                    "estimated GEM partitions (whitelist occupancy)", stage="ingest",
                )
        mpr = sgems.mem_per_read_mb(rs.n_reads)
        if mpr is not None:
            self.stats.log("mem_per_read", mpr, "MB of available memory per input read",
                           stage="ingest")
        nq = len(rs.quals)
        q30_n = sum(
            int((rs.quals[s : s + (1 << 26)] >= 30).sum()) for s in range(0, nq, 1 << 26)
        )
        self.stats.log("q30_r2_perc", float(q30_n / nq * 100) if nq else 0.0,
                       "Q30 bases %", stage="ingest")
        if rs.n_reads:
            lens = rs.lengths()
            L = int(lens.min())
            if L > 0:
                if (lens == lens[0]).all():
                    qmat = rs.quals.reshape(rs.n_reads, L)
                else:  # ragged: a 200k-read sample pins the fraction
                    take = np.linspace(0, rs.n_reads - 1, min(rs.n_reads, 200_000)).astype(np.int64)
                    qmat = rs.quals[rs.offsets[:-1][take][:, None] + np.arange(L)[None, :]]
                self.stats.log(
                    "worst_cycle_q2_frac", 100.0 * float((qmat <= 2).mean(axis=0).max()),
                    "worst per-cycle %% of bases with Q<=2", stage="ingest",
                )
        return rs

    def stage_count(self, rs: ReadSet) -> kcount.KmerTable:
        """Count into kmers.npz and the spectrum histogram.  A blocked count
        spills its blocks to count_spill/ (a killed run resumes there; the
        reference's run.py:254-258) and its counts go into the stage's
        record; the spills go once kmers.npz is written."""
        spill_dir = self.outdir / "count_spill"
        table = dbuild.trim_table(kcount.count_readset(
            rs, self.device, info=self.stage_records.setdefault("count", {}),
            spill_dir=spill_dir))
        host = convert.table_to_numpy(table)
        n = host.n_valid
        self.stats.log("kmers_distinct", n, "distinct filtered 48-mers", stage="count")
        spec = hist.kmer_spectrum(host)
        (self.outdir / "stats").mkdir(exist_ok=True)
        hist.write_hist_json(
            self.outdir / "stats" / "histogram_kmer_count.json",
            "48-mer multiplicity spectrum", spec["bins"], spec["counts"],
        )
        np.savez_compressed(
            self.outdir / "kmers.npz",
            words=np.stack(host.words, axis=-1),
            count=host.count,
            nbc=host.nbc,
            left_mask=host.left_mask,
            right_mask=host.right_mask,
            n_valid=np.int64(n),
        )
        shutil.rmtree(spill_dir, ignore_errors=True)
        return table

    def stage_graph(self, table: kcount.KmerTable) -> dgraph.BaseGraph:
        bg = dgraph.from_device(dbuild.build_graph(table), table)
        bg.save(self.outdir / "graph.npz")
        lens = bg.edges.lengths()
        canonical = np.arange(bg.n_edges) <= bg.inv  # one per rc pair
        self.stats.log("n_edges", bg.n_edges, "unipath edges (fwd+rc)", stage="graph")
        self.stats.log("edge_N50", n50(lens[canonical]), "unipath edge N50 (bases)", cs=True)
        self.stats.log("assembly_checksum", bg.checksum(), "graph checksum", stage="graph")
        return bg

    def stage_paths(self, bg: dgraph.BaseGraph, rs: ReadSet) -> pather.ReadPaths:
        """Pather, rescue, extend, paths.npz, placed_perc and ebcx.npz, step
        for step as the reference's run.py:578-626.  The stage's record
        holds the blocked pather's counts and the host seconds of rescue
        (rescue_s) and extend (extend_s)."""
        rec = self.stage_records.setdefault("paths", {})
        rp = pather.path_readset(bg, rs, self.device, info=rec)
        n = rs.n_reads
        edges, plen, offset = (x[:n] for x in convert.readpaths_to_numpy(rp)[:3])
        t0 = time.perf_counter()
        edges, plen, offset, n_resc = arescue.rescue_unplaced(bg, rs, edges, plen, offset)
        t1 = time.perf_counter()
        if n_resc:
            self.stats.log("paths_rescued", n_resc,
                           "zero-hit reads placed by low-qual substitution seeds", stage="paths")
        edges, plen, offset, n_ext = abads.extend_paths(bg, rs, edges, plen, offset)
        rec.update(rescue_s=t1 - t0, extend_s=time.perf_counter() - t1)
        if n_ext or n_resc:
            t = lambda a: torch.from_numpy(a.astype(np.int64)).to(self.device)
            rp = rp._replace(edges=t(edges), path_len=t(plen), offset=t(offset))
            self.stats.log("paths_extended", n_ext, stage="paths")
        pathzip.save_zipped(self.outdir / "paths.npz", bg, edges, plen, offset,
                            extra={"n_edges": np.int64(bg.n_edges)})
        placed = float((plen > 0).mean()) if n else 0.0
        self.stats.log("placed_perc", placed * 100, "% reads pathed", stage="paths")
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
        np.savez_compressed(self.outdir / "ebcx.npz", values=ebcx.values, offsets=ebcx.offsets,
                            counts=pindex.edge_read_counts(edges, plen, bg.n_edges))
        return rp
