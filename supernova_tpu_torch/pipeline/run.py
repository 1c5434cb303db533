"""The port's Pipeline: the base-graph slice of supernova_tpu's main path.

    ReadSet -> stage_ingest -> stage_count -> stage_graph -> stage_paths
            -> (KmerTable, BaseGraph, ReadPaths)

as supernova_tpu/pipeline/run.py runs it on one device.  Readsets above
one count block take the blocked count and pather; the count stage's
record then holds its block and raw row counts.  stage_count and
stage_graph write kmers.npz, stats/histogram_kmer_count.json and graph.npz
in the reference's formats and log kmers_distinct, n_edges, edge_N50 and
assembly_checksum.  stage_paths stops at the raw pather output: the
qual-tolerant rescue and extend_paths (and with them paths.npz) are not
ported yet; it logs placed_perc.  all_stats.json is rewritten after every
stage.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..align import pather
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
        table = dbuild.trim_table(kcount.count_readset(
            rs, self.device, info=self.stage_records.setdefault("count", {})))
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
        rp = pather.path_readset(bg, rs, self.device)
        plen = rp.path_len[: rs.n_reads].cpu().numpy()
        placed = float((plen > 0).mean()) if rs.n_reads else 0.0
        self.stats.log("placed_perc", placed * 100, "% reads pathed", stage="paths")
        return rp
