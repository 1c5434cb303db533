"""The port's Pipeline: supernova_tpu's Pipeline.run and Pipeline.run_full
on one device.

    ReadSet -> stage_ingest -> stage_count (under the coverage guard)
            -> stage_graph -> stage_paths -> stage_fasta("raw") -> finalize
            -> (BaseGraph, assembly.raw.fasta.gz)

as supernova_tpu/pipeline/run.py's Pipeline.run runs it, each stage under
the port's stage timer.  run_full runs the reference's whole path:

    ingest -> count -> graph -> paths -> patch (dead-end pairs ->
    closures -> the graph rebuilt on the device -> re-path) -> supergraph
    (closures glued into the supergraph D on the device -> cleanup ->
    lines -> molecules) -> scaffold (the star-gap phases or the legacy
    scaffolder, lines of lines, Flipper phasing, the het DP on the device)
    -> FASTA in the raw, megabubbles, pseudohap and pseudohap2 flavors,
    GFA, assembly_state.pkl, the final/a.sup* files, histograms, the
    assembly report and the summary files.

Every stage writes the reference's checkpoint (reads.npz, kmers.npz,
graph.npz, paths.npz, ebcx.npz, closures.npz, graph.patched.npz,
cpaths.npz, dpaths.npz, supergraph.npz, <phase>/a.sup.npz) in its format,
and with resume=True reloads it instead of recomputing (the reference's
outdirs too).  Readsets above one block (on a card, what its free memory
holds: kmer/count.py count_block_positions, align/pather.py
path_block_positions) take the blocked count and pather; the count
stage's record then holds its block size, block, row, partition, spill
and OOM-retry counts, and every stage's record the kernel launches
made in it; the scaffold stage's record holds each phase's wall and the
het DP's pairs, shape and seconds.  finalize() writes summary.json,
summary_cs.csv, stats/summary.txt and alerts.json; all_stats.json is
rewritten after every timed stage.

As the reference's, run_full's timed stages run inside the orchestrator
(pipeline/orchestrate.py): pipestance.json records each stage's status,
attempts and wall, a stage that raises is run once more, and one that
raises again raises StageError after writing _stage_<name>_traceback.txt.
run() and run_slice() time their stages without it, so that, as the
reference's run(), they write no pipestance.json.
"""
from __future__ import annotations

import gc
import logging
import os
import pickle
import shutil
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..align import index as pindex
from ..align import pather, pathzip
from ..align import rescue as arescue
from ..asm import bads as abads
from ..asm import barcode_join as abj
from ..asm import bubbles as abub
from ..asm import capture as acap
from ..asm import clean as aclean
from ..asm import closures as aclos
from ..asm import dups as adups
from ..asm import fixint as afix
from ..asm import gaprika as agk
from ..asm import het as ahet
from ..asm import inversion as ainv
from ..asm import lines as alines
from ..asm import local as alocal
from ..asm import misassembly as amis
from ..asm import molecules as amol
from ..asm import patch as apatch
from ..asm import phasing as aph
from ..asm import place as aplace
from ..asm import pullapart as apull
from ..asm import report as areport
from ..asm import scaffold as asc
from ..asm import splat as aspl
from ..asm import stackaroo as astk
from ..asm import star as astar
from ..asm import supergraph as asg
from ..core.device import resolve_device
from ..core.kmer_codec import W3
from ..core.ragged import Ragged
from ..dbg import build as dbuild
from ..dbg import graph as dgraph
from ..ingest.ingest import subsample_pairs, valid_barcode_fraction
from ..ingest.reads import ReadSet
from ..kmer import count as kcount
from ..ops import kernels
from ..out import efasta as oef
from ..out import fasta as fout
from ..out import gfa as ogfa
from ..out import pseudohap as oph
from ..out import superfiles as osf
from ..parallel.dist import fleet_all
from ..stats import gems as sgems
from ..stats import histograms as hist
from ..stats.logger import StatLogger, n50
from ..stats.trace import stage
from .orchestrate import Orchestrator

log = logging.getLogger("supernova_tpu_torch")

# Dictionary rows above which the mesh pather hash-shards the kmer
# dictionary across the shards instead of replicating it (the reference's
# supernova_tpu/pipeline/run.py:33-38).  Addin: pipeline.run.PATH_VS_DICT_ROWS.
PATH_VS_DICT_ROWS = 64_000_000

# Flat base count above which the ReadSet re-homes onto disk memmaps
# (reads.lazy/), as the reference's (supernova_tpu/pipeline/run.py:40-43).
LAZY_READS_MIN_BASES = 2_000_000_000
# FASTA flavors -> file name; all but raw need run_full's scaffold and
# phase stages (the reference's stage_fasta, run.py:1731-1752)
FASTA_FILES = {"raw": "assembly.raw.fasta.gz", "megabubbles": "assembly.megabubbles.fasta.gz",
               "pseudohap": "assembly.pseudohap.fasta.gz",
               "pseudohap2": "assembly.pseudohap2.fasta.gz", "efasta": "assembly.efasta.gz"}


def _fleet_world() -> int:
    """Processes in the joined fleet (1 when none was joined)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Pipeline:
    def __init__(self, outdir: str | Path, device: str | torch.device, resume: bool = False,
                 downsample: dict | None = None, auto_downsample: bool = True,
                 multi_device: bool | tuple | None = None):
        """device: where the count, build, pather and patch rebuild run (no
        default: "cuda" on the card, "cpu" for the plain twins).
        resume, downsample, auto_downsample: the reference's (run.py:47-98).
        resume reloads each stage's checkpoint; downsample is
        {"target_reads": N} or {"gigabases": G}; auto_downsample subsamples
        to 56x and recounts when the spectrum's coverage estimate exceeds
        90x.

        multi_device, the reference's (run.py:72-92): None shards the count,
        build, pather and closure glue over every visible card when there
        is more than one; True does so on the CPU too (over the reference
        test mesh's 8 shards); False never; a (hosts, chips) tuple selects
        the 2-D mesh with the hierarchical count exchange, its hosts*chips
        shards on the cards in turn (several on one card where there are
        fewer cards).  SUPERNOVA_TPU_TOPOLOGY=HxC sets the tuple; a joined
        fleet (parallel/dist.py) sets (processes, shards per process)."""
        self.device = resolve_device(device)
        if multi_device is None:
            topo = os.environ.get("SUPERNOVA_TPU_TOPOLOGY")
            if topo:
                h, c = topo.lower().split("x")
                multi_device = (int(h), int(c))
            elif _fleet_world() > 1:
                from ..parallel.dist import local_shards

                multi_device = (_fleet_world(), local_shards(self.device))
        self.multi_device = multi_device
        self._shard_tables = None  # (mesh, per-shard tables) for the sharded build
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.stats = StatLogger.load(self.outdir / "all_stats.json")
        self.resume = resume
        self.downsample = downsample
        self.auto_downsample = auto_downsample
        self.stage_records: dict[str, dict] = {}
        self._t_start = time.time()
        self.orch = Orchestrator(self.outdir)

    def _timed(self, name, fn, *a, **kw):
        """One of run_full's stages: _stage inside the orchestrator's
        run_stage (pipestance.json, one retry), as the reference's _timed
        (run.py:99-110)."""
        return self.orch.run_stage(name, lambda: self._stage(name, fn, *a, **kw))

    def _resumes(self, ck: Path, valid: bool = True) -> bool:
        """Whether a stage reloads its checkpoint ck (valid: its own checks
        passed) under resume=True.  In a joined fleet every process decides
        together (fleet_all): the stage's work crosses the processes, so a
        process that reloaded while another recomputed would leave the
        other waiting in a collective."""
        return fleet_all(self.resume and ck.exists() and valid, self.device)

    def _stage(self, name, fn, *a, **kw):
        """Run one stage under the stage timer, note the kernel launches
        made in it (the record's "launches") and persist the stats."""
        rec = self.stage_records.setdefault(name, {})
        before = kernels.launch_counts()
        with stage(name, self.device, self.stats, rec):
            out = fn(*a, **kw)
        rec["launches"] = kernels.launches_since(before)
        self.stats.dump_json(self.outdir / "all_stats.json")
        return out

    def run(self, rs: ReadSet, flavor: str = "raw"):
        """The reference's Pipeline.run, each stage timed -> (BaseGraph,
        path of the FASTA).  Raises RuntimeError on preflight exit alerts."""
        if flavor != "raw":  # refuse before any work
            self._fasta_path(flavor)
            raise ValueError(f"run() writes the raw flavor; {flavor!r} needs the scaffold "
                             "and phase stages: call run_full")
        _, bg, _ = self.run_slice(rs)
        path = self._stage("fasta", self.stage_fasta, bg, flavor)
        self.finalize()
        return bg, path

    def run_slice(self, rs: ReadSet):
        """run()'s stages up to the FASTA -> (KmerTable, BaseGraph,
        ReadPaths), for callers that check the count's table or the
        pather's own ReadPaths (tests/, chip_smoke.py)."""
        rs = self._stage("ingest", self.stage_ingest, rs)
        exits = self.stats.exit_alerts()
        if exits:
            self.finalize()
            raise RuntimeError(f"preflight exit alerts: {exits}")
        table, rs = self._stage("count", self._count_with_cov_guard, rs)
        bg = self._stage("graph", self.stage_graph, table)
        return table, bg, self._stage("paths", self.stage_paths, bg, rs)

    def run_full(self, rs: ReadSet, flavors=("raw", "megabubbles", "pseudohap", "pseudohap2")):
        """The reference's run_full (run.py:1769-1893), step for step: ingest,
        then count, graph, paths, patch, supergraph and scaffold, each timed
        under its name; the FASTA flavors; graph.gfa.gz and
        supergraph.gfa.gz; assembly_state.pkl; the final/a.sup* files; the
        contig, scaffold, edge, phase block and reads-per-barcode
        histograms; the assembly report; the summary files.  With
        resume=True and graph.patched.npz present it skips the paths stage,
        as the reference does (the patch stage reloads the patched graph and
        its paths).  -> (D, lines, scaffolds, phasings, {flavor: path})."""
        for flavor in flavors:
            self._fasta_path(flavor)  # refuse an unknown flavor before any work
        rs = self.stage_ingest(rs)
        exits = self.stats.exit_alerts()
        if exits:
            self.finalize()
            raise RuntimeError(f"preflight exit alerts: {exits}")
        table, rs = self._timed("count", self._count_with_cov_guard, rs)
        bg = self._timed("graph", self.stage_graph, table)
        del table
        if self._resumes(self.outdir / "graph.patched.npz"):
            rp = None  # the patch stage reloads the patched graph and its paths
        else:
            rp = self._timed("paths", self.stage_paths, bg, rs)
        bg, rp = self._timed("patch", self.stage_patch, bg, rp, rs)
        D, lines, dup = self._timed("supergraph", self.stage_supergraph, bg, rp, rs)
        D, lines, scaffolds, phasings = self._timed(
            "scaffold", self.stage_scaffold_phase, D, lines, rp, rs)

        ctx = (D, lines, scaffolds, phasings)
        outputs = {flavor: self.stage_fasta(bg, flavor, ctx=ctx) for flavor in flavors}
        ogfa.write_gfa(bg, self.outdir / "graph.gfa.gz")
        ogfa.write_gfa_super(D, self.outdir / "supergraph.gfa.gz")
        # the final assembly state, enough to write any flavor again
        with open(self.outdir / "assembly_state.pkl", "wb") as f:
            pickle.dump({"D": D, "lines": lines, "scaffolds": scaffolds,
                         "phasings": phasings}, f)
        lbpx = None
        lp = getattr(self, "_line_positions", None)
        if lp:
            lbpx = [(li, bc, p) for li, bcs in lp.items() for bc, ps in bcs.items() for p in ps]
        osf.write_super_files(self.outdir, D, lines, phasings=phasings,
                              dpaths=getattr(self, "_dpaths", None),
                              dlen=getattr(self, "_dlen", None), lbpx=lbpx)
        scaffold_seqs = []
        for sc in scaffolds:
            parts = [oph.line_sequence(D, lines.lines[li], {}) for li in sc.line_ids]
            scaffold_seqs.append(oph.join_parts(parts, sc))

        statsdir = self.outdir / "stats"
        statsdir.mkdir(exist_ok=True)
        contigs = [n for s in scaffold_seqs for n in areport.contig_lengths_from_seq(s)]
        for name, lens in (("contig", contigs), ("scaffold", [len(s) for s in scaffold_seqs]),
                           ("edge", [D.edge_len(d) for d in range(D.n_edges)])):
            h = hist.length_histogram(lens)
            hist.write_hist_json(statsdir / f"histogram_{name}.json",
                                 f"{name} length histogram", h["bins"], h["counts"])
        pb_lens = []
        for li, ph2 in phasings.items():
            pb_lens.extend(aph.phase_block_lengths(D, lines.lines[li], ph2))
        h = hist.length_histogram(np.array(pb_lens or [0]))
        hist.write_hist_json(statsdir / "histogram_phase_block.json", "phase block lengths",
                             h["bins"], h["counts"])
        rb = hist.reads_per_barcode_histogram(rs)
        hist.write_hist_json(statsdir / "histogram_reads_per_barcode.json",
                             "reads per barcode", rb["bins"], rb["counts"])
        areport.report_assembly_stats(self.stats, D, lines, scaffolds, phasings, scaffold_seqs,
                                      adups.dup_fraction(dup), bg.checksum())
        self.finalize()
        return D, lines, scaffolds, phasings, outputs

    def finalize(self):
        self.stats.log(
            "etime_h", (time.time() - self._t_start) / 3600.0,
            "total elapsed hours", cs=True,
        )
        self.stats.dump_json(self.outdir / "all_stats.json")
        (self.outdir / "stats").mkdir(exist_ok=True)
        self.stats.dump_text(self.outdir / "stats" / "summary.txt")
        self.stats.dump_json(self.outdir / "summary.json", cs_only=True)
        self.stats.dump_csv(self.outdir / "summary_cs.csv")
        self.stats.dump_alerts(self.outdir / "alerts.json")

    # ---------------------------------------------------------------- stages

    def stage_ingest(self, rs: ReadSet) -> ReadSet:
        """User downsampling, the reads.npz checkpoint, the re-homing onto
        disk memmaps above LAZY_READS_MIN_BASES and the input stats
        (reference run.py:114-223)."""
        if self.downsample:
            frac = 1.0
            if self.downsample.get("target_reads"):
                frac = self.downsample["target_reads"] / max(rs.n_reads, 1)
            elif self.downsample.get("gigabases"):
                frac = self.downsample["gigabases"] / max(float(len(rs.codes)) / 1e9, 1e-12)
            if frac < 1.0:
                rs = subsample_pairs(rs, frac)
                self.stats.log("downsample_frac", frac, "user downsample fraction",
                               stage="ingest")
        ck = self.outdir / "reads.npz"
        if not ck.exists():
            rs.save(ck)
        # host RSS for the rest of the run bounded by the touched working
        # set, not the read total (the reference's VirtualMasterVec analogue)
        if len(rs.codes) > LAZY_READS_MIN_BASES and not rs.is_lazy:
            lz = self.outdir / "reads.lazy"
            if not (lz / "codes.npy").exists():
                rs.save_lazy(lz)
            rs = ReadSet.load_lazy(lz)
            self.stats.log("reads_lazy", 1, "bases/quals memmap-backed", stage="ingest")
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
        record; the spills go once kmers.npz is written.  On resume,
        kmers.npz (the port's or the reference's) reloads onto the device."""
        ck = self.outdir / "kmers.npz"
        if self._resumes(ck):
            z = np.load(ck)
            w = z["words"]
            return convert.table_from_numpy(kcount.KmerTable(
                W3(w[:, 0], w[:, 1], w[:, 2]), z["count"], z["nbc"], z["left_mask"],
                z["right_mask"], z["n_valid"]), self.device)
        spill_dir = self.outdir / "count_spill"
        ndev = self._mesh_ndev()
        if ndev and not fleet_all(int(rs.offsets[-1]) <= kcount.planned_block_positions(
                rs, self.device, kcount.MIN_FREQ, kcount.MIN_BC, spill_dir), self.device):
            # the reference shards only a one-block readset (sharded +
            # blocked is future work there too); a fleet's processes agree
            log.info("count: readset exceeds one block; using the blocked path")
            ndev = 0
        if ndev:
            table = self._count_sharded(rs, ndev)
        else:
            table = kcount.count_readset(
                rs, self.device, info=self.stage_records.setdefault("count", {}),
                spill_dir=spill_dir)
        table = dbuild.trim_table(table)
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
            ck,
            words=np.stack(host.words, axis=-1),
            count=host.count,
            nbc=host.nbc,
            left_mask=host.left_mask,
            right_mask=host.right_mask,
            n_valid=np.int64(n),
        )
        shutil.rmtree(spill_dir, ignore_errors=True)
        return table

    def _glue_mesh(self):
        """The mesh of the supergraph closure glue in multi-device mode
        (parallel/sharded_nucleate.py), else None."""
        ndev = self._mesh_ndev()
        return self._flat_mesh(ndev) if ndev else None

    def _flat_mesh(self, ndev: int):
        """The one-axis mesh of ndev shards that the pather and the glue run
        on (and the flat count): in a joined fleet the flat mesh over every
        process's shards (the reference's make_mesh spans the fleet), else
        ndev shards of this process."""
        from ..parallel.mesh import flat, make_mesh

        if _fleet_world() > 1:
            from ..parallel.dist import fleet_mesh

            mesh = flat(fleet_mesh(self.device))
            if mesh.size != ndev:
                raise ValueError(f"the fleet holds {mesh.size} shards, not the {ndev} of "
                                 f"multi_device={self.multi_device}")
            return mesh
        return make_mesh(ndev, self.device)

    def _mesh_ndev(self) -> int:
        """Shards to run count/build/paths/glue over (0 = single device).
        The reference's rule, with ">1 local chip on a TPU backend" read as
        ">1 visible card with a CUDA device", so a one-card run stays
        single-device."""
        if isinstance(self.multi_device, tuple):
            h, c = self.multi_device
            return h * c if h * c > 1 else 0
        cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        if self.multi_device is None:
            return cards if cards > 1 else 0
        n = cards if self.device.type == "cuda" else 8
        return n if (self.multi_device and n > 1) else 0

    def _count_sharded(self, rs: ReadSet, ndev: int):
        """Mesh count (parallel/sharded_count.py): reads data-parallel, kmer
        space hash-sharded; keeps the per-shard tables for the sharded
        build.  On a capacity overflow the reference recounts on one device;
        so does this, and the count stage's record says which route ran
        (count_route "mesh" or "mesh_overflow", count_overflow)."""
        from ..parallel import sharded_count as psc
        from ..parallel.mesh import flat, make_mesh2

        rec = self.stage_records.setdefault("count", {})
        fleet = _fleet_world() > 1
        if isinstance(self.multi_device, tuple):
            # 2-D (host, chip) topology: the hierarchical exchange; the
            # shard tables keep working on the flat mesh of the same shards
            if fleet:
                from ..parallel.dist import fleet_mesh

                mesh2 = fleet_mesh(self.device)
            else:
                mesh2 = make_mesh2(*self.multi_device, device=self.device)
            mesh = flat(mesh2)
            inputs, nbl = psc.split_readset(rs, mesh2)
            tables, ovf = psc.sharded_count_hier(mesh2, inputs, capacity=4 * nbl)
            total = ovf[0]  # every shard holds the mesh's total
        else:
            mesh = self._flat_mesh(ndev)
            inputs, nbl = psc.split_readset(rs, mesh)
            tables, ovf = psc.sharded_count(mesh, inputs, capacity=4 * nbl)
            total = mesh.psum(ovf)
        del inputs
        rec.update(count_overflow=int(total), n_shards=ndev)
        if total > 0:
            log.warning("sharded count overflow (%d rows); single-device recount", total)
            rec["count_route"] = "mesh_overflow"
            self._shard_tables = None
            return kcount.count_readset(rs, self.device, info=rec)
        rec["count_route"] = "mesh"
        # in a fleet the shard tables live in several processes, and the
        # build runs over all of them (sharded_build_graph on the flat mesh)
        self._shard_tables = (mesh, tables)
        self.stats.log("n_shards", ndev, "count/build mesh devices", stage="count")
        merged = psc.merge_shard_tables(tables, self.device)
        return kcount.recompute_adjacencies(dbuild.trim_table(merged))

    def _count_with_cov_guard(self, rs: ReadSet):
        """Count, estimate coverage from the spectrum, and (auto mode)
        downsample + recount past the >90x alarm (reference run.py:396-436)
        -> (table, rs)."""
        table = self.stage_count(rs)
        rl = float(np.mean(rs.lengths())) if rs.n_reads else 150.0
        cov, gsize = kcount.estimate_coverage(table, rl)
        if cov:
            self.stats.log("est_coverage", cov, "kmer-spectrum coverage estimate",
                           cs=True, stage="count")
            if gsize:
                self.stats.log("est_genome_size", gsize,
                               "kmer-spectrum genome size estimate", stage="count")
            # the estimate is only trustworthy with a real spectrum
            if self.auto_downsample and cov > 90.0 and int(table.n_valid) >= 50_000:
                frac = 56.0 / cov
                self.stats.log("downsample_frac_auto", frac,
                               "auto downsample to 56x (coverage alarm >90x)", stage="count")
                rs = subsample_pairs(rs, frac)
                (self.outdir / "kmers.npz").unlink(missing_ok=True)
                # free the full-coverage table (and any shard tables) before
                # the recount
                table = None
                self._shard_tables = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                table = self.stage_count(rs)
        return table, rs

    def stage_graph(self, table: kcount.KmerTable) -> dgraph.BaseGraph:
        ck = self.outdir / "graph.npz"
        if self._resumes(ck):
            return dgraph.BaseGraph.load(ck)
        if self._shard_tables is not None:
            # distributed unipath build over the hash-sharded tables
            from ..parallel.sharded_build import sharded_build_graph

            mesh, tables = self._shard_tables
            bg = sharded_build_graph(mesh, tables, self.device)
            self._shard_tables = None
        else:
            bg = dgraph.from_device(dbuild.build_graph(table), table)
        bg.save(ck)
        lens = bg.edges.lengths()
        canonical = np.arange(bg.n_edges) <= bg.inv  # one per rc pair
        self.stats.log("n_edges", bg.n_edges, "unipath edges (fwd+rc)", stage="graph")
        self.stats.log("edge_N50", n50(lens[canonical]), "unipath edge N50 (bases)", cs=True)
        self.stats.log("assembly_checksum", bg.checksum(), "graph checksum", stage="graph")
        return bg

    def stage_paths(self, bg: dgraph.BaseGraph, rs: ReadSet) -> pather.ReadPaths:
        """Pather, rescue, extend, paths.npz, placed_perc and ebcx.npz, step
        for step as the reference's run.py:537-626.  On resume, paths.npz
        is reused when it holds these reads' paths on a graph of as many
        edges (ebcx.npz is rewritten).  The stage's record holds the blocked
        pather's counts and the host seconds of rescue (rescue_s) and
        extend (extend_s)."""
        ck = self.outdir / "paths.npz"
        z = np.load(ck) if self.resume and ck.exists() else None
        # the same reads on a graph of as many edges
        if self._resumes(ck, z is not None and "n_edges" in z and int(z["n_edges"]) == bg.n_edges
                         and len(z["zip_plen"]) == rs.n_reads):
            edges, plen, offset = pathzip.load_zipped(z, bg)
            t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(self.device)
            zero = torch.zeros(rs.n_reads, dtype=torch.int64, device=self.device)
            rp = pather.ReadPaths(t(edges), t(plen), t(offset), zero, zero.to(torch.bool))
            self._write_ebcx(edges, plen, rs, bg)
            return rp
        rec = self.stage_records.setdefault("paths", {})
        ndev = self._mesh_ndev()
        if ndev and not fleet_all(
                int(rs.offsets[-1]) <= pather.path_block_positions(self.device, bg), self.device):
            ndev = 0  # the blocked single-device pather, as the reference's
        if ndev:
            rp = self._path_sharded(bg, rs, ndev)
        else:
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
        pathzip.save_zipped(ck, bg, edges, plen, offset,
                            extra={"n_edges": np.int64(bg.n_edges)})
        placed = float((plen > 0).mean()) if n else 0.0
        self.stats.log("placed_perc", placed * 100, "% reads pathed", stage="paths")
        self._write_ebcx(edges, plen, rs, bg)
        return rp

    def _path_sharded(self, bg: dgraph.BaseGraph, rs: ReadSet, ndev: int) -> pather.ReadPaths:
        """Data-parallel pathing over the mesh (parallel/sharded_path.py),
        per read equal to the single-device pather.  The dictionary is
        replicated on every shard below PATH_VS_DICT_ROWS rows and
        hash-sharded above (no shard holds all of it; lookups go to the
        owner shard).  In a fleet the mesh spans every process's shards, and
        every process gets every read's path."""
        from ..parallel import sharded_path as psp

        mesh = self._flat_mesh(ndev)
        inputs, blocks = psp.split_for_pathing(rs, mesh)
        da = bg.device_arrays(mesh.devices[0])
        value_shard = int(bg.kmer_words.shape[0]) > PATH_VS_DICT_ROWS
        if value_shard:
            shards = psp.shard_dictionary(mesh, da["words"], da["node_edge"], da["node_pos"])
            nbl = mesh.pmax(int(i["pos_read"].shape[0]) for i in inputs)
            parts = psp.sharded_path_vs(mesh, shards, da["from_v"], da["to_v"], da["edge_kmers"],
                                        inputs, capacity=2 * nbl)
        else:
            parts = psp.sharded_path(mesh, da["words"], da["node_edge"], da["node_pos"],
                                     da["from_v"], da["to_v"], da["edge_kmers"], inputs)
        self.stats.log("n_shards_path", ndev, "pathing mesh devices", stage="paths")
        self.stats.log("path_dict_sharded", int(value_shard),
                       "1 = kmer dictionary value-sharded across the mesh", stage="paths")
        return psp.gather_paths(parts, blocks)

    def _write_ebcx(self, edges, plen, rs: ReadSet, bg: dgraph.BaseGraph):
        """ebcx.npz: the barcodes of the reads on each edge, and the reads'
        count an edge."""
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
        np.savez_compressed(self.outdir / "ebcx.npz", values=ebcx.values, offsets=ebcx.offsets,
                            counts=pindex.edge_read_counts(edges, plen, bg.n_edges))

    def _fasta_path(self, flavor: str) -> Path:
        if flavor not in FASTA_FILES:
            raise ValueError(f"unknown flavor {flavor}")
        return self.outdir / FASTA_FILES[flavor]

    def _resume_supergraph(self, bg, rs, ck, dck):
        """START=supergraph re-entry (the reference's run.py:679-746): D and
        the lines from supergraph.npz, the placements from dpaths.npz, the
        closures from cpaths.npz, then the misassembly break and the
        molecules recomputed -> (D, lines, dup), or None when the
        checkpoints belong to other reads or another graph."""
        z = np.load(ck)
        dz = np.load(dck)
        ev = z["epaths_values"]
        if len(dz["dlen"]) != rs.n_reads or (ev.size and int(ev.max()) >= bg.n_edges):
            return None  # different reads or graph: recompute
        from_v = z["from_v"]
        to_v = z["to_v"]
        nv = int(max(from_v.max(), to_v.max())) + 1 if len(from_v) else 0
        D = asg.SuperGraph(epaths=Ragged(ev, z["epaths_offsets"]), dinv=z["dinv"],
                           from_v=from_v, to_v=to_v, n_vertices=nv, bg=bg)
        dpaths, dlen = dz["dpaths"], dz["dlen"]
        if dpaths.size and int(dpaths.max()) >= D.n_edges:
            return None  # dpaths.npz belongs to a different D: recompute
        lines = alines.find_lines(D)
        self._dpaths, self._dlen = dpaths, dlen
        cpk = self.outdir / "cpaths.npz"
        if cpk.exists():
            self._closures = aclos.load_closures(cpk)  # Splat input (a.cpaths)
        if rs.barcoded:
            edges, plen, _off = self._base_paths
            ek = self.outdir / "ebcx.npz"
            ebcx = None
            if ek.exists():
                ze = np.load(ek)
                if len(ze["offsets"]) == bg.n_edges + 1:
                    ebcx = Ragged(ze["values"], ze["offsets"])
            if ebcx is None:
                ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            pos0 = amol.read_line_positions(D, lines, dpaths, dlen, rs.bc,
                                            base_paths=self._base_paths)
            lines = amis.break_lines(lines, D, sup_bcs, line_positions=pos0)
            self._set_molecules(D, lines, dpaths, dlen, rs)
        log.info("supergraph: resumed from checkpoints")
        return D, lines, z["dup"]

    def _set_molecules(self, D, lines, dpaths, dlen, rs):
        """Barcode molecules on the lines (lbpx analogue) and, for
        orientation-aware scaffolding, line -> {bc: [positions]}; returns
        the molecules."""
        positions = amol.read_line_positions(D, lines, dpaths, dlen, rs.bc,
                                             base_paths=self._base_paths)
        self._molecules = amol.infer_molecules(positions)
        lp: dict = {}
        for (b, li), ps in positions.items():
            lp.setdefault(li, {})[b] = ps
        self._line_positions = lp
        return self._molecules

    def stage_supergraph(self, bg: dgraph.BaseGraph, rp: pather.ReadPaths, rs: ReadSet):
        """The reference's stage_supergraph (run.py:748-980), step for step:
        dup marking, bad reads, closures (cpaths.npz), weak-edge trims, D
        glued from the closures (the closure glue on the device above
        DEVICE_GLUE_MIN_POSITIONS closure positions, asm/nucleate.py) or
        compacted from the graph, the cleanup passes, lines and their
        misassembly break, dpaths.npz, the molecules and supergraph.npz ->
        (D, lines, dup).  With resume=True it re-enters from supergraph.npz
        and dpaths.npz when they belong to these reads and this graph.  The
        stage's record and stats get the glue's route (glue_route:
        "device", "device_overflow" or "host"), its overflow counts
        (glue_overflow; the stats hold their sum) and its closure
        positions (glue_positions)."""
        n = rs.n_reads
        edges, plen, offset = (x[:n] for x in convert.readpaths_to_numpy(rp)[:3])
        self._base_paths = (edges, plen, offset)  # for lbpx-resolution positions

        ck = self.outdir / "supergraph.npz"
        dck = self.outdir / "dpaths.npz"
        got = None
        if self.resume and ck.exists() and dck.exists():
            got = self._resume_supergraph(bg, rs, ck, dck)
        if self._resumes(ck, got is not None):
            return got
        log_sg = lambda name, value, *a, **kw: self.stats.log(
            name, value, *a, stage="supergraph", **kw)
        dup = adups.mark_dups(edges, plen, offset, rs.bc)
        log_sg("dup_frac", adups.dup_fraction(dup), "duplicate pair fraction")
        med_ins, proper = adups.insert_size_stats(bg, edges, plen, offset)
        if med_ins is not None:
            log_sg("median_ins_sz", med_ins, "median insert size", cs=True)
            log_sg("proper_pairs_perc", 100.0 * proper, "% placed pairs properly paired",
                   cs=True)
        counts = pindex.edge_read_counts(edges, plen, bg.n_edges)

        # closure paths first (a.cpaths analogue); bad pairs excluded like
        # dups (MakeClosures uses non-dup non-bad pairs, SecretOps.cc:1049)
        bad = abads.mark_bads(bg, rs, edges, plen, offset)
        log_sg("bad_read_frac", float(bad.mean()) if len(bad) else 0.0,
               "reads contradicting the assembly")
        bad_pair = bad[0::2] | bad[1::2]
        cl = aclos.make_closures(bg, edges, plen, dup | bad_pair)
        aclos.save_closures(self.outdir / "cpaths.npz", cl)
        self._closures = cl  # a.cpaths analogue, consumed by Splat
        log_sg("n_closures", len(cl), "closure paths")

        keep = asg.trim_weak_edges(bg, counts)
        # TR trimming ahead of MC: closures riding Lawnmower-trimmed WEAK
        # FORK branches are error evidence — drop them (dead-end tips stay:
        # genuine sequence ends are tips too)
        keep_forks = asg.trim_weak_edges(bg, counts, tips=False)
        if cl and not keep_forks.all():
            n0 = len(cl)
            cl = [c for c in cl if bool(keep_forks[np.asarray(c, np.int64)].all())]
            if n0 != len(cl):
                log_sg("closures_trimmed", n0 - len(cl), "closures dropped on trimmed edges")
        if cl:
            # faithful MC construction: glue closures into D
            glue: dict = {}
            D = asg.closures_to_graph(bg, cl, device=self.device, info=glue,
                                      mesh=self._glue_mesh())
            log_sg("supergraph_mode", "closures")
            if glue:
                self.stage_records.setdefault("supergraph", {}).update(glue)
                log_sg("glue_route", glue["glue_route"], "closure glue route")
                log_sg("glue_overflow", sum(glue["glue_overflow"]),
                       "closure pairs past the device glue's budgets")
                log_sg("glue_positions", glue["glue_positions"], "closure positions glued")
        else:
            D = asg.build_supergraph(bg, keep)
            # flatten lopsided (error-artifact) bubbles and rebuild once
            support = asg.super_edge_support(D, counts)
            keep2, n_flat = abub.flatten_bubbles(bg, keep, D, support)
            if n_flat:
                keep = keep2
                D = asg.build_supergraph(bg, keep)
                log_sg("bubbles_flattened", n_flat, "weak bubble arms removed")
        D.validate()

        # Cleaner passes: hang trimming, weak bubble arms (3:0 rule),
        # inversion-bubble zapping, iterated to a fixpoint; then
        # KillInversionArtifacts (needs barcode support)
        rbc = rs.bc if rs.barcoded else None
        place_fn = lambda Dx: aplace.place_reads(Dx, edges, plen, read_bc=rbc)
        D, n_cleaned = aclean.clean_supergraph(D, place_fn)
        if n_cleaned:
            D.validate()
            log_sg("super_edges_cleaned", n_cleaned, "D-edges removed by cleanup passes")
        dpaths, dlen = place_fn(D)
        dels = ainv.kill_inversion_artifacts(D, dpaths, dlen, rbc)
        if dels:
            D = ainv.delete_edges(D, dels)
            D.validate()
            dpaths, dlen = place_fn(D)
            log_sg("inversion_edges_deleted", len(dels), "inversion-artifact D-edges removed")

        # PullApart (read-pair repeat separation) + Decycle
        D2, n_pulls = apull.pull_apart(D, dpaths, dlen)
        if n_pulls:
            D = D2
            D.validate()
            dpaths, dlen = place_fn(D)
            log_sg("n_pullaparts", n_pulls)
        dc = apull.decycle(D, dpaths, dlen)
        if dc:
            D = ainv.delete_edges(D, dc)
            D.validate()
            dpaths, dlen = place_fn(D)
            log_sg("n_decycled", len(dc))

        # loop capture: abstract remaining loop subgraphs into {-4} cells so
        # lines run straight through them (CaptureLoops, 10X/Capture.cc)
        D2, n_cap = acap.capture_loops(D)
        if n_cap:
            D = D2
            D.validate()
            dpaths, dlen = place_fn(D)
            log_sg("n_loops_captured", n_cap, "loop subgraphs captured into cell gap edges")
        D2m, n_messy = acap.capture_messy_loops(D)
        if n_messy:
            D = D2m
            D.validate()
            dpaths, dlen = place_fn(D)
            log_sg("n_messy_loops_captured", n_messy,
                   "tangles between long lines captured into cells")

        lines = alines.find_lines(D)
        log_sg("n_super_edges", D.n_edges)
        log_sg("n_lines", lines.n_lines)

        # misassembly breaking: split lines at junctions with no spanning
        # barcodes (KillMisassembledCells analogue)
        if rs.barcoded:
            ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            pos0 = amol.read_line_positions(D, lines, dpaths, dlen, rs.bc,
                                            base_paths=self._base_paths)
            lines = amis.break_lines(lines, D, sup_bcs, line_positions=pos0)
            log_sg("n_lines_after_break", lines.n_lines)

        # dpaths already computed above (re-placed after any inversion cleanup)
        self._dpaths, self._dlen = dpaths, dlen
        np.savez_compressed(dck, dpaths=dpaths, dlen=dlen,
                            counts=aplace.dpath_counts(D, dpaths, dlen))

        # barcode molecules on lines (lbpx analogue)
        if rs.barcoded:
            mols = self._set_molecules(D, lines, dpaths, dlen, rs)
            if mols:
                self.stats.log("lw_mean_mol_len", amol.lw_mean_length(mols),
                               "length-weighted mean molecule length", cs=True)
                lm = sgems.estimate_loading_mass_ng(mols)
                if lm is not None:
                    self.stats.log("loading_mass", lm, "estimated input DNA loading mass (ng)")
                h = hist.length_histogram(np.array([m.length for m in mols]), bin_width=500)
                (self.outdir / "stats").mkdir(exist_ok=True)
                hist.write_hist_json(self.outdir / "stats" / "histogram_molecules.json",
                                     "inferred molecule lengths", h["bins"], h["counts"])
        np.savez_compressed(ck, epaths_values=D.epaths.values, epaths_offsets=D.epaths.offsets,
                            dinv=D.dinv, from_v=D.from_v, to_v=D.to_v, keep=keep, dup=dup)
        return D, lines, dup

    # lines at or above this are placed scaffolding citizens: fill content
    # owned by one of them duplicates sequence living elsewhere
    FILL_OWNER_LONG_LINE = 20_000

    def _fill_ownership(self, D, lines):
        """The fill gate's ownership context (asm/fillcheck
        fill_owned_frac; the reference's run.py:289-331): the graph's kmer
        dictionary as sorted uint32 word columns, a flag for each row whose
        owning base edge lies in a line of >= FILL_OWNER_LONG_LINE bases,
        each row's edge and position, and the edges' sequences.  None when
        the graph has no dictionary."""
        bg = D.bg
        kw = getattr(bg, "kmer_words", None)
        ne = getattr(bg, "node_edge", None)
        nk = int(getattr(bg, "n_kmers", 0) or 0)
        if kw is None or ne is None or nk == 0:
            return None
        kw = np.asarray(kw)[:nk]
        llens = lines.lengths(D)
        long_base = np.zeros(bg.n_edges, bool)
        for li, ln in enumerate(lines.lines):
            if llens[li] < self.FILL_OWNER_LONG_LINE:
                continue
            for d in ln.edges():
                row = np.asarray(D.epaths.row(int(d)), np.int64)
                if len(row) and row[0] >= 0:
                    long_base[row] = True
        long_base = long_base | long_base[np.asarray(bg.inv)]
        e_of_row = np.asarray(ne)[0::2][:nk]
        row_long = long_base[np.clip(e_of_row, 0, bg.n_edges - 1)]
        np_rows = np.asarray(bg.node_pos)[0::2][:nk]
        return {
            "words": (
                np.ascontiguousarray(kw[:, 0]),
                np.ascontiguousarray(kw[:, 1]),
                np.ascontiguousarray(kw[:, 2]),
            ),
            "row_long": row_long,
            "row_edge": e_of_row.astype(np.int64),
            "row_pos": np_rows.astype(np.int64),
            "edge_seq": lambda e: bg.edges.row(int(e)),
        }

    def _star_multipass(self, D, lines, rs, ebcx, max_passes: int = 3):
        """Star's passes over the gap-joined D (the reference's
        run.py:982-1039): each pass scores joins against the calibrated
        Jaccard floor, inserts {-2, size} gap edges sized from the barcode
        molecules and re-finds the lines -> (D, lines, joins)."""
        good = asc.good_barcodes(rs.bc)
        total = 0
        for _ in range(max_passes):
            llens, lbp, line_bcs, positions = self._line_evidence(D, lines, rs, ebcx, good)
            canon = list(range(lines.n_lines))
            lhood = astar.line_prox(line_bcs, canon)
            rdead = astar.right_dead_ends(lines, D)
            lp_cal: dict = {}
            for (b, li), ps in positions.items():
                lp_cal.setdefault(li, {})[b] = ps
            # one window for the floor's calibration and the veto's measure
            jwin = min(agk.WINDOW, astar.BRIDGE_VIEW)
            floor = agk.join_jaccard_floor(lp_cal, llens, D, lines, window=jwin)
            joins = astar.star_joins(canon, llens, lines.linv, lbp, lhood, rdead,
                                     jaccard_floor=floor, jaccard_view=jwin)
            joins = astar.filter_joins(joins, lines.linv)
            if not joins:
                break
            by_bl = defaultdict(list)
            for m in amol.infer_molecules(positions):
                by_bl[(m.bc, m.line)].append(m)
            gap_sizes = {(L1, R): amol.estimate_gap(by_bl, L1, int(llens[L1]), R)
                         for L1, R, _ in joins}
            D = astar.insert_star_gaps(D, lines, joins, gap_sizes)
            D.validate()
            lines = alines.find_lines(D)
            total += len(joins)
        return D, lines, total

    def _line_evidence(self, D, lines, rs, ebcx, good):
        """Each line's scaffolding evidence: lengths, end-restricted barcode
        positions (lbp), good-barcode sets and raw positions."""
        llens = lines.lengths(D)
        sup_bcs = asg.super_edge_barcodes(D, ebcx)
        line_bc_edges = []
        for ln in lines.lines:
            bcs = [sup_bcs[int(dd)] for dd in ln.edges()]
            line_bc_edges.append(np.unique(np.concatenate(bcs)) if bcs else np.zeros(0, np.int64))
        line_bcs = asc.line_barcode_sets(lines, line_bc_edges, good)
        positions = amol.read_line_positions(D, lines, self._dpaths, self._dlen, rs.bc,
                                             base_paths=self._base_paths)
        lbp_all = {li: [] for li in range(lines.n_lines)}
        for (bc, li), ps in positions.items():
            lbp_all[li].extend((bc, p) for p in ps)
        lbp = astar.restrict_positions(lbp_all, llens)
        return llens, lbp, line_bcs, positions

    def _barcode_join_passes(self, D, lines, rs, ebcx, max_passes: int = 3):
        """BarcodeJoin passes over D (the reference's run.py:1068-1094):
        splice symmetric barcode-order links between long lines, re-find
        the lines, iterate -> (D, lines, joins)."""
        good = asc.good_barcodes(rs.bc)
        total = 0
        for _ in range(max_passes):
            llens, lbp, line_bcs, _pos = self._line_evidence(D, lines, rs, ebcx, good)
            canon = list(range(lines.n_lines))
            lhood = astar.line_prox(line_bcs, canon)
            cov = astar.line_coverage(llens, lbp)
            D2, n = abj.barcode_join(D, lines, llens, lbp, lhood, cov)
            if not n:
                break
            D = D2
            D.validate()
            lines = alines.find_lines(D)
            total += n
        return D, lines, total

    def _fix_misassemblies(self, D, lines, rs, edges, plen):
        """FixMisassemblies between star and starstar (the reference's
        run.py:1096-1152, without its resplay): low-unique junk, inversion
        bubbles, then the misassembled cells at the base window tier ->
        (D, lines)."""
        n_sp = 0
        n_kill = 0
        dels = aclean.kill_low_unique(D)
        if dels:
            D = ainv.delete_edges(D, dels)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(dels)
        zaps = ainv.zap_inversion_bubbles(D, lines)
        if zaps:
            D = ainv.delete_edges(D, zaps)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(zaps)
        if getattr(self, "_line_positions", None) is None or n_kill or n_sp:
            self._refresh_positions(D, lines, rs)
        lwml = amol.lw_mean_length(self._molecules) if self._molecules else None
        dels2 = amis.kill_misassembled_cells(D, lines, self._line_positions, lw_mol_len=lwml)
        if dels2:
            D = ainv.delete_edges(D, dels2)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(dels2)
        if n_sp or n_kill:
            self.stats.log("fix_misassemblies_edits", n_sp + n_kill,
                           "resplays + edges deleted by FixMisassemblies", stage="scaffold")
        return D, lines

    def _refresh_line_state(self, D, rs, edges, plen):
        """Lines, placements, molecules and line positions after a D edit."""
        lines = alines.find_lines(D)
        self._dpaths, self._dlen = aplace.place_reads(
            D, edges, plen, read_bc=rs.bc if rs.barcoded else None, lines=lines)
        if rs.barcoded:
            self._refresh_positions(D, lines, rs)
        return lines

    def _refresh_positions(self, D, lines, rs):
        self._set_molecules(D, lines, self._dpaths, self._dlen, rs)

    def _save_sup_snapshot(self, name: str, D, extra: dict | None = None) -> None:
        """One scaffold phase's snapshot, <name>/a.sup.npz."""
        d = self.outdir / name
        d.mkdir(exist_ok=True)
        np.savez_compressed(d / "a.sup.npz", epaths_values=D.epaths.values,
                            epaths_offsets=D.epaths.offsets, dinv=D.dinv, from_v=D.from_v,
                            to_v=D.to_v, **(extra or {}))

    def _load_sup_snapshot(self, bg, path, want_reads: int | None = None,
                           want_paths: bool = False):
        """A phase snapshot when it belongs to this base graph (and, when
        it records one, this read count) -> D, or (D, dpaths, dlen) with
        want_paths; else None."""
        if not path.exists():
            return None
        z = np.load(path)
        ev = z["epaths_values"]
        eo = z["epaths_offsets"]
        if ev.size:
            # base-edge ids in range, on the rows that are not gaps (a gap
            # row [-2, gap_len, ...] holds lengths)
            lens = np.diff(eo)
            first = np.full(len(lens), -1, ev.dtype)
            ne = lens > 0
            first[ne] = ev[eo[:-1][ne]]
            real = np.repeat(first >= 0, lens)
            if real.any() and int(ev[real].max()) >= bg.n_edges:
                return None
        if "n_base_edges" in z and int(z["n_base_edges"]) != bg.n_edges:
            return None
        if want_reads is not None and ("n_reads" not in z or int(z["n_reads"]) != want_reads):
            return None
        from_v, to_v = z["from_v"], z["to_v"]
        nv = int(max(from_v.max(), to_v.max())) + 1 if len(from_v) else 0
        D = asg.SuperGraph(epaths=Ragged(ev, z["epaths_offsets"]), dinv=z["dinv"],
                           from_v=from_v, to_v=to_v, n_vertices=nv, bg=bg)
        if want_paths:
            if "dpaths" not in z:
                return None
            return D, z["dpaths"], z["dlen"]
        return D

    # The re-enterable phases between the supergraph and phasing, each
    # snapshotted to <phase>/a.sup.npz; resume=True restores the newest
    # snapshot that matches and runs only the later phases.
    SUP_PHASES = (
        "splay", "star", "fix", "starstar", "presize", "stackaroo",
        "unvoid", "void", "patch", "mis", "invfix", "canon", "gaprika",
        "audit", "fase",
    )

    def _scaffold_star_phases(self, D, lines, rs, edges, plen, ebcx):
        """The star-gap phases (the reference's run.py:1250-1612), each
        snapshotted, re-entered under resume=True from the newest snapshot
        that matches; SN_STOP_AFTER_PHASE=<phase> exits after that phase's
        snapshot.  The stage's record gets each phase's wall (phase_s).
        -> (D, lines), or None when star and starstar made no join (the
        caller takes the legacy scaffolder)."""
        st = {"joins": 0}
        log_sc = lambda name, value, *a: self.stats.log(name, value, *a, stage="scaffold")

        def _refresh(D):
            return self._refresh_line_state(D, rs, edges, plen)

        def ph_splay(D, lines):
            # splay long-line end vertices before the barcode joins
            n_sp = aclean.splay_line_ends(D, lines, lines.lengths(D))
            if n_sp:
                lines = alines.find_lines(D)
                self._refresh_positions(D, lines, rs)
                log_sc("splayed_vertices", n_sp, "long-line end vertices splayed")
            return D, lines

        def ph_star(D, lines):
            D, lines, n_joins = self._star_multipass(D, lines, rs, ebcx)
            st["joins"] += n_joins
            if n_joins:
                log_sc("star_gap_joins", n_joins, "{-2} gap edges inserted by Star passes")
            return D, lines

        def ph_fix(D, lines):
            return self._fix_misassemblies(D, lines, rs, edges, plen)

        def ph_starstar(D, lines):
            D, lines, n_bj = self._barcode_join_passes(D, lines, rs, ebcx)
            st["joins"] += n_bj
            if n_bj:
                log_sc("barcode_joins", n_bj, "line joins made by BarcodeJoin passes")
            return D, lines

        def ph_stackaroo(D, lines):
            # bridgeable {-2} edges upgraded to {-3} sequence
            D, n_filled = astk.stackaroo_gaps(D, rs, self._dpaths, self._dlen,
                                              ownership=self._fill_ownership(D, lines))
            if n_filled:
                D.validate()
                log_sc("gaps_filled_post", n_filled,
                       "gap edges upgraded to sequence by read stacks")
            return D, lines

        def ph_unvoid(D, lines):
            # barcode-local assembly over the {-2} gaps stackaroo left open
            D2u, n_unvoid = alocal.unvoid(D, rs, ebcx, ownership=self._fill_ownership(D, lines))
            if n_unvoid:
                D = D2u
                D.validate()
                lines = _refresh(D)
                log_sc("gaps_unvoided", n_unvoid, "gaps closed by barcode-local assembly")
            return D, lines

        def ph_void(D, lines):
            # voids at line dead-ends closed toward barcode-neighbour lines
            llens_u, _lbp_u, line_bcs_u, _pos_u = self._line_evidence(
                D, lines, rs, ebcx, asc.good_barcodes(rs.bc))
            D2v, n_voids = alocal.unvoid_voids(D, rs, ebcx, lines, line_bcs_u, llens_u,
                                               ownership=self._fill_ownership(D, lines))
            if n_voids:
                D = D2v
                D.validate()
                lines = _refresh(D)
                log_sc("voids_closed", n_voids, "line dead-ends joined by barcode-local assembly")
            return D, lines

        def ph_patch(D, lines):
            # pair-linked {-2} gaps -> {-1}, then the saved closures splatted
            # across them
            D2c, n_conv = aspl.convert_bc_gaps(D, self._dpaths, self._dlen)
            if n_conv:
                D = D2c
                D.validate()
                log_sc("pair_gaps_converted", n_conv, "{-2} gaps with read-pair links -> {-1}")
            cl2 = getattr(self, "_closures", None)
            if cl2 and n_conv:
                D3, n_sp = aspl.splat(D, [np.asarray(c, np.int64) for c in cl2])
                if n_sp:
                    D = D3
                    D.validate()
                    lines = _refresh(D)
                    log_sc("gaps_splatted", n_sp, "pair gaps replaced by closure sequence")
            self._refresh_positions(D, lines, rs)
            return D, lines

        def ph_mis(D, lines):
            # the interior discontinuity scan first (while lines are long),
            # then the misassembled-cell tiers and the position-free variant
            lpx = self._line_positions or {}
            if lpx:
                splits, gap_dels, detaches, finfo = afix.find_interior_breaks(
                    D, lines, lpx, lines.lengths(D))
                log.info("fixint: %s", finfo)
                # splits and detaches keep edge ids; deletions renumber, so
                # they run last
                n_broken = 0
                if splits:
                    D = afix.split_edges(D, splits)
                    n_broken += len(splits)
                if detaches:
                    D = afix.detach_edges(D, detaches)
                    n_broken += len(detaches)
                if gap_dels:
                    dels_g = sorted({g for d in gap_dels for g in (d, int(D.dinv[d]))})
                    D = ainv.delete_edges(D, dels_g)
                    n_broken += len(gap_dels)
                if n_broken:
                    D.validate()
                    lines = _refresh(D)
                    log_sc("interior_breaks", n_broken,
                           "breaks at calibrated bridge-fraction dips "
                           "(gap dels + edge splits + head detaches)")
            lwml = amol.lw_mean_length(self._molecules) if self._molecules else None
            n_killed = 0
            for (req, flk, ign) in amis.ESCALATION_TIERS:
                dels = amis.kill_misassembled_cells(
                    D, lines, self._line_positions, bc_require=req, bc_flank=flk,
                    bc_ignore=ign, lw_mol_len=lwml)
                if not dels:
                    continue
                n_killed += len(dels)
                D = ainv.delete_edges(D, dels)
                D.validate()
                lines = _refresh(D)
            dels_alt = amis.kill_misassembled_cells_alt(D, lines, ebcx)
            if dels_alt:
                n_killed += len(dels_alt)
                D = ainv.delete_edges(D, dels_alt)
                D.validate()
                lines = _refresh(D)
            if n_killed:
                log_sc("misassembled_cells_killed", n_killed,
                       "D-edges deleted at unsupported junctions")
            return D, lines

        def ph_invfix(D, lines):
            # interiors between barcode-only gap pairs that the barcode
            # windows call inverted, flipped
            n_flips = ainv.inv_fix(D, lines, self._line_positions or {})
            if n_flips:
                D.validate()
                lines = _refresh(D)
                log_sc("inversions_fixed", n_flips, "line interiors flipped to their rc by InvFix")
            return D, lines

        def ph_canon(D, lines):
            # 3-4-path cells flattened into parallel edges
            D2c2, n_canon = acap.canonicalize_cells(D, lines)
            if n_canon:
                D = D2c2
                D.validate()
                lines = _refresh(D)
                log_sc("cells_canonicalized", n_canon)
            return D, lines

        def ph_gaprika(D, lines):
            # every {-2} gap re-sized from the assembly's own bridge curve;
            # joins below half its max-gap value are broken
            self._refresh_positions(D, lines, rs)
            for _ in range(2):  # the second pass re-sizes after any breaks
                lp = self._line_positions or {}
                if not lp:
                    break
                D, n_sized, ginfo = agk.gaprika(D, lines, lp, lines.lengths(D))
                if n_sized:
                    D.validate()
                    log_sc("gaps_sized", n_sized,
                           "{-2} gaps re-sized by the calibrated bridge curve")
                log.info("gaprika: %s", {k: v for k, v in ginfo.items() if k != "curve"})
                weak = ginfo.get("weak_edges") or []
                if not weak:
                    break
                dels = sorted({int(d) for d in weak} | {int(D.dinv[d]) for d in weak})
                D = ainv.delete_edges(D, dels)
                D.validate()
                lines = _refresh(D)
                log_sc("weak_gap_joins_broken", len(weak),
                       "{-2} joins deleted for sub-curve barcode linkage")
            return D, lines

        def ph_audit(D, lines):
            # every {-3} fill re-verified against the current placements;
            # failures demoted to calibrated {-2}
            D2, n_dem = astk.audit_seq_gaps(D, rs, self._dpaths, self._dlen,
                                            ownership=self._fill_ownership(D, lines))
            if n_dem:
                D = D2
                D.validate()
                lines = _refresh(D)
                log_sc("seq_gaps_demoted", n_dem,
                       "{-3} fills failing the final pair-content audit -> calibrated {-2}")
            return D, lines

        def ph_fase(D, lines):
            return D, lines  # terminal marker: snapshot only

        fns = {
            "splay": ph_splay, "star": ph_star, "fix": ph_fix, "starstar": ph_starstar,
            "presize": ph_gaprika, "stackaroo": ph_stackaroo, "unvoid": ph_unvoid,
            "void": ph_void, "patch": ph_patch, "mis": ph_mis, "invfix": ph_invfix,
            "canon": ph_canon, "gaprika": ph_gaprika, "audit": ph_audit, "fase": ph_fase,
        }

        start_idx = 0
        if self.resume:
            for i in range(len(self.SUP_PHASES) - 1, -1, -1):
                name = self.SUP_PHASES[i]
                path = self.outdir / name / "a.sup.npz"
                got = self._load_sup_snapshot(D.bg, path, want_reads=rs.n_reads,
                                              want_paths=True)
                if got is None:
                    continue
                D, self._dpaths, self._dlen = got
                lines = alines.find_lines(D)
                self._refresh_positions(D, lines, rs)
                zj = np.load(path)
                st["joins"] = int(zj["joins"]) if "joins" in zj else 1
                start_idx = i + 1
                log.info("scaffold: resumed from the %s snapshot", name)
                break

        phase_s = self.stage_records.setdefault("scaffold", {}).setdefault("phase_s", {})
        for name in self.SUP_PHASES[start_idx:]:
            t0 = time.time()
            D, lines = fns[name](D, lines)
            phase_s[name] = time.time() - t0
            log.info("scaffold phase %s: %.1fs", name, phase_s[name])
            self._save_sup_snapshot(name, D, extra={
                "n_reads": np.int64(rs.n_reads), "n_base_edges": np.int64(D.bg.n_edges),
                "dpaths": self._dpaths, "dlen": self._dlen, "joins": np.int64(st["joins"])})
            if os.environ.get("SN_STOP_AFTER_PHASE") == name:
                log.info("scaffold: SN_STOP_AFTER_PHASE=%s hit, exiting", name)
                raise SystemExit(0)
            if name == "starstar":
                if st["joins"] == 0:
                    return None  # no star evidence: the legacy scaffolder
                log_sc("scaffold_mode", "star-gap")
        return D, lines

    def stage_scaffold_phase(self, D, lines, rp: pather.ReadPaths, rs: ReadSet):
        """The reference's stage_scaffold_phase (run.py:1614-1729), step for
        step: barcoded reads take the star-gap phases, whose scaffolds are
        the lines of the gap-joined D; otherwise (or with no star join) the
        legacy mutual-best scaffolder with Stackaroo over its gaps.  Then
        lines of lines, Flipper phasing and the het estimate, whose DP runs
        on the Pipeline's device (the stage's record: het_pairs, het_shape
        (LA, LB), het_dp_s) -> (D, lines, scaffolds, phasings)."""
        n = rs.n_reads
        edges, plen = (x[:n] for x in convert.readpaths_to_numpy(rp)[:2])
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, D.bg.n_edges)
        lp = getattr(self, "_line_positions", None)
        scaffolds = None
        if rs.barcoded and lp:
            got = self._scaffold_star_phases(D, lines, rs, edges, plen, ebcx)
            if got is not None:
                D, lines = got
                scaffolds = [asc.Scaffold([int(li)], []) for li in alines.canonical_lines(lines)]
        if scaffolds is None:
            # the legacy path: mutual-best barcode-set scaffolding over
            # line chains
            good = asc.good_barcodes(rs.bc)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            line_bc_edges = []
            for ln in lines.lines:
                bcs = [sup_bcs[int(d)] for d in ln.edges()]
                line_bc_edges.append(np.unique(np.concatenate(bcs)) if bcs
                                     else np.zeros(0, np.int64))
            line_bcs = asc.line_barcode_sets(lines, line_bc_edges, good)
            line_lens = lines.lengths(D)
            scaffolds = asc.scaffold_lines(lines, line_bcs, line_lens, line_positions=lp)
            # gap estimates from the barcode molecules
            mols = getattr(self, "_molecules", None)
            if mols:
                by_bl = defaultdict(list)
                for m in mols:
                    by_bl[(m.bc, m.line)].append(m)
                for sc in scaffolds:
                    for i in range(len(sc.line_ids) - 1):
                        la, lb = sc.line_ids[i], sc.line_ids[i + 1]
                        sc.gaps[i] = max(1, amol.estimate_gap(by_bl, la, int(line_lens[la]), lb))
            line_seqs = {li: oph.line_sequence(D, lines.lines[li], {})
                         for sc in scaffolds for li in sc.line_ids}
            n_filled = astk.stackaroo(D, lines, scaffolds, rs, self._dpaths, self._dlen,
                                      line_seqs, ownership=self._fill_ownership(D, lines))
            if n_filled:
                self.stats.log("gaps_filled_post", n_filled,
                               "scaffold gaps closed by read stacks", stage="scaffold")
        self.stats.log("n_scaffolds", len(scaffolds), stage="scaffold")

        # lines of lines: the scaffold-level structure and its N50
        ll = alines.find_line_lines(D, lines)
        lens2 = alines.line_line_lengths(lines.lengths(D), ll)
        canon2 = np.nonzero(np.arange(ll.n_lines) <= ll.linv)[0]
        self.stats.log("n_line_lines", len(canon2), stage="scaffold")
        if len(canon2):
            self.stats.log("line_line_N50", n50(lens2[canon2]), "line-of-lines N50 (bases)",
                           stage="scaffold")

        if getattr(self, "_molecules", None):
            bc_counts = aph.build_edge_molecule_counts(D, lines, self._dpaths, self._dlen, rs.bc)
        else:
            bc_counts = aph.build_edge_bc_counts(D, self._dpaths, self._dlen, rs.bc)
        phasings = {}
        for sc in scaffolds:
            for li in sc.line_ids:
                phasings[li] = aph.phase_line(lines.lines[li], bc_counts, dinv=D.dinv)

        het: dict = {}
        hd = ahet.estimate_hetdist(D, lines, self.device, info=het)
        if het:
            self.stage_records.setdefault("scaffold", {}).update(
                het_pairs=het["pairs"], het_shape=het["shape"], het_dp_s=het["seconds"])
        if hd is not None:
            self.stats.log("hetdist_aligned", hd,
                           "mean distance between het SNPs (arm alignment)", cs=True)
        return D, lines, scaffolds, phasings

    def stage_fasta(self, bg: dgraph.BaseGraph, flavor: str = "raw", ctx=None) -> Path:
        """The reference's stage_fasta (run.py:1731-1752): the raw flavor
        from the graph (one record per rc pair of edges); megabubbles,
        pseudohap, pseudohap2 and efasta from ctx = (D, lines, scaffolds,
        phasings), run_full's scaffold stage's output."""
        out = self._fasta_path(flavor)
        if flavor == "raw":
            fout.write_raw_fasta(bg, out)
            return out
        D, lines, scaffolds, phasings = ctx
        if flavor == "megabubbles":
            oph.write_megabubbles_fasta(D, lines, scaffolds, phasings, out)
        elif flavor == "pseudohap":
            oph.write_pseudohap_fasta(D, lines, scaffolds, phasings, out)
        elif flavor == "efasta":
            oef.write_efasta(D, lines, scaffolds, phasings, out)
        else:
            oph.write_pseudohap2_fasta(D, lines, scaffolds, phasings, out)
        return out

    def stage_patch(self, bg: dgraph.BaseGraph, rp: pather.ReadPaths, rs: ReadSet):
        """The reference's stage_patch (run.py:629-677), step for step:
        mark_dups -> find_edge_pairs -> close_gaps on the host, then the
        graph rebuilt from edges + closures on the device (K1-K4) and the
        reads re-pathed -> (BaseGraph, ReadPaths), the inputs unchanged when
        nothing closes.  On resume it re-enters from graph.patched.npz.  The
        stage's record gets the rebuild's kernel launches
        (rebuild_launches) and the host seconds of the graph.patched.npz
        write (save_s)."""
        ck = self.outdir / "graph.patched.npz"
        if self._resumes(ck):
            bg2 = dgraph.BaseGraph.load(ck)
            return bg2, self.stage_paths(bg2, rs)
        n = rs.n_reads
        edges, plen, offset = (x[:n] for x in convert.readpaths_to_numpy(rp)[:3])
        t0 = time.time()
        dup = adups.mark_dups(edges, plen, offset, rs.bc)
        pairs = apatch.find_edge_pairs(bg, edges, plen, dup)
        t1 = time.time()
        closures = apatch.close_gaps(bg, rs, pairs)
        t2 = time.time()
        self.stats.log("gap_pairs", len(pairs), "dead-end edge pairs", stage="patch")
        self.stats.log("gap_closures", len(closures), "gaps closed", stage="patch")
        self.stats.log("etime_patch_find_s", t1 - t0, "patch: pair discovery wall", stage="patch")
        self.stats.log("etime_patch_close_s", t2 - t1, "patch: closure consensus wall",
                       stage="patch")
        if not closures:
            return bg, rp
        np.savez_compressed(
            self.outdir / "closures.npz",
            values=np.concatenate(closures),
            offsets=np.concatenate([[0], np.cumsum([len(c) for c in closures])]).astype(np.int64),
        )
        before = kernels.launch_counts()
        bg2 = apatch.insert_patches(bg, closures, self.device)
        rec = self.stage_records.setdefault("patch", {})
        rec["rebuild_launches"] = kernels.launches_since(before)
        t_save = time.time()
        bg2.save(ck)
        t3 = time.time()
        rec["save_s"] = t3 - t_save
        self.stats.log("etime_patch_rebuild_s", t3 - t2, "patch: graph rebuild wall",
                       stage="patch")
        rp2 = self.stage_paths(bg2, rs)
        self.stats.log("etime_patch_repath_s", time.time() - t3, "patch: re-path wall",
                       stage="patch")
        return bg2, rp2
