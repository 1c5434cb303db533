"""The port's Pipeline: supernova_tpu's Pipeline.run on one device, and
its patch and supergraph stages.

    ReadSet -> stage_ingest -> stage_count (under the coverage guard)
            -> stage_graph -> stage_paths -> stage_fasta("raw") -> finalize
            -> (BaseGraph, assembly.raw.fasta.gz)

as supernova_tpu/pipeline/run.py's Pipeline.run runs it, each stage under
the port's stage timer; stage_patch (dead-end pairs -> closures -> the
graph rebuilt on the device -> re-path) and stage_supergraph (closures
glued into the supergraph D on the device -> cleanup -> lines ->
molecules) are run_full's next stages and are called by the caller after
run().  Every stage writes the reference's checkpoint (reads.npz,
kmers.npz, graph.npz, paths.npz, ebcx.npz, closures.npz,
graph.patched.npz, cpaths.npz, dpaths.npz, supergraph.npz) in its
format, and with resume=True reloads it instead of recomputing.
Readsets above one count block take the blocked count and pather; the
count stage's record then holds its block, row, partition, spill and
OOM-retry counts, and every stage's record the kernel launches made in
it.  finalize() writes summary.json,
summary_cs.csv, stats/summary.txt and alerts.json; all_stats.json is
rewritten after every stage.
"""
from __future__ import annotations

import gc
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
from ..asm import bubbles as abub
from ..asm import capture as acap
from ..asm import clean as aclean
from ..asm import closures as aclos
from ..asm import dups as adups
from ..asm import inversion as ainv
from ..asm import lines as alines
from ..asm import misassembly as amis
from ..asm import molecules as amol
from ..asm import patch as apatch
from ..asm import place as aplace
from ..asm import pullapart as apull
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
from ..out import fasta as fout
from ..stats import gems as sgems
from ..stats import histograms as hist
from ..stats.logger import StatLogger, n50
from ..stats.trace import stage

log = logging.getLogger("supernova_tpu_torch")

# Flat base count above which the ReadSet re-homes onto disk memmaps
# (reads.lazy/), as the reference's (supernova_tpu/pipeline/run.py:40-43).
LAZY_READS_MIN_BASES = 2_000_000_000
# the reference's other FASTA flavors, which need the scaffold and phase
# stages
LATER_FLAVORS = ("megabubbles", "pseudohap", "pseudohap2", "efasta")


class Pipeline:
    def __init__(self, outdir: str | Path, device: str | torch.device, resume: bool = False,
                 downsample: dict | None = None, auto_downsample: bool = True):
        """device: where the count, build, pather and patch rebuild run (no
        default: "cuda" on the card, "cpu" for the plain twins).
        resume, downsample, auto_downsample: the reference's (run.py:47-98).
        resume reloads each stage's checkpoint; downsample is
        {"target_reads": N} or {"gigabases": G}; auto_downsample subsamples
        to 56x and recounts when the spectrum's coverage estimate exceeds
        90x."""
        self.device = resolve_device(device)
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.stats = StatLogger.load(self.outdir / "all_stats.json")
        self.resume = resume
        self.downsample = downsample
        self.auto_downsample = auto_downsample
        self.stage_records: dict[str, dict] = {}
        self._t_start = time.time()

    def _timed(self, name, fn, *a, **kw):
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
        self._fasta_path(flavor)  # refuse another flavor before any work
        _, bg, _ = self.run_slice(rs)
        path = self._timed("fasta", self.stage_fasta, bg, flavor)
        self.finalize()
        return bg, path

    def run_slice(self, rs: ReadSet):
        """run()'s stages up to the FASTA -> (KmerTable, BaseGraph,
        ReadPaths), for callers that check the count's table or the
        pather's own ReadPaths (tests/, chip_smoke.py)."""
        rs = self._timed("ingest", self.stage_ingest, rs)
        exits = self.stats.exit_alerts()
        if exits:
            self.finalize()
            raise RuntimeError(f"preflight exit alerts: {exits}")
        table, rs = self._timed("count", self._count_with_cov_guard, rs)
        bg = self._timed("graph", self.stage_graph, table)
        return table, bg, self._timed("paths", self.stage_paths, bg, rs)

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
        if self.resume and ck.exists():
            z = np.load(ck)
            w = z["words"]
            return convert.table_from_numpy(kcount.KmerTable(
                W3(w[:, 0], w[:, 1], w[:, 2]), z["count"], z["nbc"], z["left_mask"],
                z["right_mask"], z["n_valid"]), self.device)
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
                # free the full-coverage table before the recount
                table = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                table = self.stage_count(rs)
        return table, rs

    def stage_graph(self, table: kcount.KmerTable) -> dgraph.BaseGraph:
        ck = self.outdir / "graph.npz"
        if self.resume and ck.exists():
            return dgraph.BaseGraph.load(ck)
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
        if self.resume and ck.exists():
            z = np.load(ck)
            # the same reads on a graph of as many edges
            if ("n_edges" in z and int(z["n_edges"]) == bg.n_edges
                    and len(z["zip_plen"]) == rs.n_reads):
                edges, plen, offset = pathzip.load_zipped(z, bg)
                t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(self.device)
                zero = torch.zeros(rs.n_reads, dtype=torch.int64, device=self.device)
                rp = pather.ReadPaths(t(edges), t(plen), t(offset), zero, zero.to(torch.bool))
                self._write_ebcx(edges, plen, rs, bg)
                return rp
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
        pathzip.save_zipped(ck, bg, edges, plen, offset,
                            extra={"n_edges": np.int64(bg.n_edges)})
        placed = float((plen > 0).mean()) if n else 0.0
        self.stats.log("placed_perc", placed * 100, "% reads pathed", stage="paths")
        self._write_ebcx(edges, plen, rs, bg)
        return rp

    def _write_ebcx(self, edges, plen, rs: ReadSet, bg: dgraph.BaseGraph):
        """ebcx.npz: the barcodes of the reads on each edge, and the reads'
        count an edge."""
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
        np.savez_compressed(self.outdir / "ebcx.npz", values=ebcx.values, offsets=ebcx.offsets,
                            counts=pindex.edge_read_counts(edges, plen, bg.n_edges))

    def _fasta_path(self, flavor: str) -> Path:
        if flavor in LATER_FLAVORS:
            raise NotImplementedError(
                f"FASTA flavor {flavor!r} needs the scaffold and phase stages, not yet "
                "ported (ROADMAP A8); this port writes the raw flavor")
        if flavor != "raw":
            raise ValueError(f"unknown flavor {flavor}")
        return self.outdir / f"assembly.{flavor}.fasta.gz"

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
        if self.resume and ck.exists() and dck.exists():
            got = self._resume_supergraph(bg, rs, ck, dck)
            if got is not None:
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
            D = asg.closures_to_graph(bg, cl, device=self.device, info=glue)
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

    def stage_fasta(self, bg: dgraph.BaseGraph, flavor: str = "raw") -> Path:
        """assembly.raw.fasta.gz: one record per rc pair of edges (reference
        run.py:1731-1754, its raw flavor)."""
        out = self._fasta_path(flavor)
        fout.write_raw_fasta(bg, out)
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
        if self.resume and ck.exists():
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
