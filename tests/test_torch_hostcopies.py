"""The port's copies of the JAX package's host modules (ingest, sim, core
dna/ragged/pqvec, stats gems/histograms/logger, the feudal formats,
align rescue/pathzip/index, asm bads/dups/stackster and patch's host half,
out fasta, ingest fastq/tenx/discovery, pipeline preflight, the native FASTQ
decoder, the supergraph stage's asm modules and the native glue core, the
scaffold stage's asm modules and the out modules of run_full, the count's
numpy canonicalization and asm/het.py apart from its device, and the CLI's
host modules: ingest demux, out exports/sam/readqa, asm
evaluate/astats/diagnose/minhash, core/config.py apart from its package
name, pipeline/orchestrate.py apart from its host rank, the FM-index's
host query and the mesh modules' split_incidence/split_votes) against their
originals: the same source apart from the note that names the original,
and the same outputs on the same inputs (tests/test_orchestrate.py's and
tests/test_config.py's cases on either package); and the host graph's
kmer words, uint32 as the reference's, wherever a graph comes from."""
import gzip
import importlib
import inspect
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import supernova_tpu_torch.align.index as p_index
import supernova_tpu_torch.asm.dups as p_dups
import supernova_tpu_torch.asm.het as p_het
import supernova_tpu_torch.asm.patch as p_patch
import supernova_tpu_torch.asm.stackster as p_stackster
import supernova_tpu_torch.ingest.discovery as p_discovery
import supernova_tpu_torch.ingest.fastq as p_fastq
import supernova_tpu_torch.ingest.tenx as p_tenx
import supernova_tpu_torch.native as p_native
import supernova_tpu_torch.out.fasta as p_fasta
import supernova_tpu_torch.pipeline.preflight as p_preflight
import supernova_tpu_torch.align.pathzip as p_pathzip
import supernova_tpu_torch.align.rescue as p_rescue
import supernova_tpu_torch.asm.bads as p_bads
import supernova_tpu_torch.core.pqvec as p_pqvec
import supernova_tpu_torch.core.ragged as p_ragged
import supernova_tpu_torch.dbg.build as p_build
import supernova_tpu_torch.dbg.graph as p_graph
import supernova_tpu_torch.ingest.feudal as p_feudal
import supernova_tpu_torch.kmer.count as p_count
import supernova_tpu_torch.ingest.ingest as p_ingest
import supernova_tpu_torch.pipeline.orchestrate as p_orch
import supernova_tpu_torch.ingest.reads as p_reads
import supernova_tpu_torch.sim.genome as p_sim
import supernova_tpu_torch.stats.gems as p_gems
import supernova_tpu_torch.stats.histograms as p_hist
import supernova_tpu_torch.stats.logger as p_logger
from supernova_tpu.align import index as r_index
from supernova_tpu.align import pather as r_pather
from supernova_tpu.align import pathzip as r_pathzip
from supernova_tpu.align import rescue as r_rescue
from supernova_tpu import native as r_native
from supernova_tpu.asm import bads as r_bads
from supernova_tpu.asm import dups as r_dups
from supernova_tpu.asm import het as r_het
from supernova_tpu.asm import patch as r_patch
from supernova_tpu.asm import stackster as r_stackster
from supernova_tpu.ingest import discovery as r_discovery
from supernova_tpu.ingest import fastq as r_fastq
from supernova_tpu.ingest import tenx as r_tenx
from supernova_tpu.out import fasta as r_fasta
from supernova_tpu.pipeline import orchestrate as r_orch
from supernova_tpu.pipeline import preflight as r_preflight
from supernova_tpu.core import dna as r_dna
from supernova_tpu.core import pqvec as r_pqvec
from supernova_tpu.core import ragged as r_ragged
from supernova_tpu.ingest import feudal as r_feudal
from supernova_tpu.ingest import ingest as r_ingest
from supernova_tpu.ingest import reads as r_reads
from supernova_tpu.dbg import build as r_build
from supernova_tpu.dbg import graph as r_graph
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as r_sim
from supernova_tpu.stats import gems as r_gems
from supernova_tpu.stats import histograms as r_hist
from supernova_tpu.stats import logger as r_logger
from supernova_tpu_torch import convert
from supernova_tpu_torch.core import dna as p_dna

REPO = Path(__file__).resolve().parents[1]
COPIES = ["core/dna.py", "core/ragged.py", "core/pqvec.py", "ingest/reads.py",
          "ingest/ingest.py", "ingest/barcodes.py", "sim/genome.py", "stats/gems.py",
          "stats/histograms.py", "stats/logger.py", "align/rescue.py", "align/pathzip.py",
          "align/index.py", "asm/bads.py", "out/fasta.py", "ingest/fastq.py", "ingest/tenx.py",
          "ingest/discovery.py", "pipeline/preflight.py", "asm/dups.py", "asm/stackster.py",
          "asm/gap.py", "asm/lines.py", "asm/molecules.py", "asm/place.py", "asm/closures.py",
          "asm/bubbles.py", "asm/inversion.py", "asm/clean.py", "asm/pullapart.py",
          "asm/capture.py", "asm/local.py", "asm/links.py", "asm/scaffold.py", "asm/star.py",
          "asm/gaprika.py", "asm/fillcheck.py", "asm/stackaroo.py", "asm/splat.py",
          "asm/fixint.py", "asm/barcode_join.py", "asm/phasing.py", "asm/report.py",
          "out/pseudohap.py", "out/gfa.py", "out/superfiles.py", "out/efasta.py",
          "ingest/demux.py", "out/exports.py", "out/sam.py",
          "out/readqa.py", "asm/evaluate.py", "asm/astats.py", "asm/diagnose.py",
          "asm/minhash.py"]


def without_note(path):
    """(the original's source, the copy's source without the docstring
    paragraph that names the original, which follows a blank line)."""
    orig = (REPO / "supernova_tpu" / path).read_text()
    copy = (REPO / "supernova_tpu_torch" / path).read_text().split("\n")
    start = next(i for i, line in enumerate(copy) if line.startswith("The port's own copy of"))
    note_end = copy.index("", start)
    assert copy[start - 1] == "" and f"supernova_tpu/{path}" in " ".join(copy[start:note_end])
    return orig, "\n".join(copy[:start] + copy[note_end + 1:])


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_source(path):
    """Only the docstring paragraph naming the original was added, after a
    blank line of the docstring."""
    orig, copy = without_note(path)
    assert copy == orig


def host_fns(mod):
    return "\n\n".join(inspect.getsource(f) for f in (mod.host_id, mod.n_hosts))


@pytest.mark.parametrize("path", ["core/config.py", "pipeline/orchestrate.py",
                                  "ingest/feudal.py"])
def test_copy_differs_from_the_original_only_at_its_seam(path):
    """core/config.py apart from _PKG (an addin path names the port's
    constant); pipeline/orchestrate.py apart from host_id and n_hosts (the
    torch.distributed rank and world size); ingest/feudal.py apart from one
    docstring line, whose original names a local checkout's path."""
    orig, copy = without_note(path)
    if path == "ingest/feudal.py":
        lines = orig.split("\n")
        at = next(i for i, line in enumerate(lines) if line.startswith("Formats (reverse-"))
        lines[at] = "Formats (reverse-engineered from the reference's sources, cited per function):"
        seam = (orig, "\n".join(lines))
    elif path == "core/config.py":
        seam = ('_PKG = "supernova_tpu"\n', '_PKG = "supernova_tpu_torch"\n')
    else:
        seam = (host_fns(r_orch), host_fns(p_orch))
        assert "jax" not in seam[1] and "torch.distributed" in seam[1]
    assert orig.count(seam[0]) == 1 and orig.replace(*seam) == copy


def same_sources(a, b, names):
    for name in names:
        assert inspect.getsource(getattr(a, name)) == inspect.getsource(getattr(b, name)), name


def test_native_decoder_is_the_original():
    """The same load_native and decode_fastq_bytes and the same C++ source;
    only the build directory differs (the port's _build/).  The same
    arrays from the same bytes, and the same refusal of a malformed file."""
    same_sources(r_native, p_native, ("load_native", "decode_fastq_bytes"))
    assert (REPO / "supernova_tpu_torch/native/fastq_decode.cpp").read_bytes() == (
        REPO / "supernova_tpu/native/fastq_decode.cpp").read_bytes()
    assert p_native.load_native() is not None
    assert p_native._build_dir() == REPO / "supernova_tpu_torch" / "_build"
    rng = np.random.default_rng(11)
    recs = []
    for i in range(60):
        n = int(rng.integers(0, 200))
        recs.append((f"r{i}", rng.integers(0, 4, n).astype(np.uint8),
                     rng.integers(2, 41, n).astype(np.uint8)))
    data = "".join(f"@{n}\n{r_dna.codes_to_seq(c)}\n+\n{r_fastq.phred_to_qual_str(q)}\n"
                   for n, c, q in recs).encode()
    for a, b in zip(r_native.decode_fastq_bytes(data), p_native.decode_fastq_bytes(data)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for mod in (r_native, p_native):
        with pytest.raises(ValueError):
            mod.decode_fastq_bytes(b"not a fastq\nACGT\n")


def test_nucleate_core_is_the_original():
    """The same load_nucleate and the same glue core source, built into the
    port's _build/."""
    same_sources(r_native, p_native, ("load_nucleate",))
    assert (REPO / "supernova_tpu_torch/native/nucleate_core.cpp").read_bytes() == (
        REPO / "supernova_tpu/native/nucleate_core.cpp").read_bytes()
    assert p_native.load_nucleate() is not None


def module_defs(mod):
    """Names of the functions and classes a module defines."""
    return {n for n, o in vars(mod).items()
            if (inspect.isfunction(o) or inspect.isclass(o)) and o.__module__ == mod.__name__}


@pytest.mark.parametrize("mod,ported", [
    ("supergraph", {"closures_to_graph"}), ("nucleate", {"nucleate_graph"}),
    ("misassembly", {"find_weak_junctions_positional", "break_lines",
                     "kill_misassembled_cells"})])
def test_supergraph_nucleate_misassembly_are_the_original(mod, ported):
    """asm/supergraph.py and asm/nucleate.py apart from the device seam
    (closures_to_graph and nucleate_graph, which take the device), and
    asm/misassembly.py apart from the positional rule's loops and
    kill_misassembled_cells' windows; tests/test_torch_supergraph.py and
    tests/test_torch_scaffold_star.py hold those to the reference."""
    ref = importlib.import_module(f"supernova_tpu.asm.{mod}")
    port = importlib.import_module(f"supernova_tpu_torch.asm.{mod}")
    names = module_defs(ref) - ported
    assert module_defs(port) - ported == names and len(names) >= 3
    same_sources(ref, port, sorted(names))
    consts = {"supergraph": (), "misassembly": (
        "MIN_SPAN_BC", "BC_FLANK", "BC_IGNORE", "BC_REQUIRE", "BC_MIN", "BC_MAX_CELL",
        "ESCALATION_TIERS"), "nucleate": ("MIN_OVER_BASES", "_MAX_LONG_PARTNERS",
                                          "LOOK_MERGE_BASES", "LOOK", "MIN_OVER_FLOOR_BASES",
                                          "VALUE_SHARD")}
    for name in consts[mod]:
        assert getattr(ref, name) == getattr(port, name), name


def test_patch_host_half_is_the_original():
    """asm/patch.py apart from the rebuild (insert_patches, patch_graph and
    patch_readset, which tests/test_torch_patch.py holds to the reference)."""
    same_sources(r_patch, p_patch, ("GapPair", "find_edge_pairs", "_mini_dbg_walk", "close_gaps"))
    for name in ("PATCH_K", "MIN_PAIR_SUPPORT", "MAX_GAP_WALK"):
        assert getattr(r_patch, name) == getattr(p_patch, name)


def test_feudal_packing_is_the_original():
    for name in ("pack_codes", "unpack_codes"):
        assert inspect.getsource(getattr(p_feudal, name)) == inspect.getsource(getattr(r_feudal, name))
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 1003):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        packed = p_feudal.pack_codes(codes)
        assert np.array_equal(packed, r_feudal.pack_codes(codes))
        assert np.array_equal(p_feudal.unpack_codes(packed, n), codes)


def simulate(mod, seed, **kw):
    rng = np.random.default_rng(seed)
    g = mod.random_genome(rng, 6000, n_repeat_chunks=2, repeat_len=200)
    _, hb = mod.diploidize(rng, g, 0.002)
    wl = mod.make_whitelist(rng, 64)
    reads = mod.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=12, molecules_per_barcode=2, molecule_len=2000,
        coverage_per_molecule=1.0, error_rate=0.003, bc_error_rate=0.05, **kw)
    return g, hb, wl, reads


@pytest.mark.parametrize("chromium_model", [False, True])
def test_simulation_and_ingest_match(chromium_model):
    ref = simulate(r_sim, 4, chromium_model=chromium_model)
    port = simulate(p_sim, 4, chromium_model=chromium_model)
    for a, b in zip(ref[:3], port[:3]):
        assert np.array_equal(a, b)
    for f in ("r1", "q1", "r2", "q2", "barcode", "bc_qual", "truth_pos", "truth_hap"):
        assert np.array_equal(np.asarray(getattr(ref[3], f)), np.asarray(getattr(port[3], f))), f
    rs_r = r_ingest.ingest_sim(ref[3], ref[2])
    rs_p = p_ingest.ingest_sim(port[3], port[2])
    assert isinstance(rs_p, p_reads.ReadSet)
    for f in ("codes", "offsets", "quals", "bc", "bci", "barcoded"):
        a, b = getattr(rs_r, f), getattr(rs_p, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), f
    assert r_ingest.valid_barcode_fraction(rs_r) == p_ingest.valid_barcode_fraction(rs_p)


@pytest.fixture(scope="module")
def readsets():
    _, _, wl, reads = simulate(r_sim, 6)
    return r_ingest.ingest_sim(reads, wl), p_ingest.ingest_sim(reads, wl)


def test_readset_save_load_and_flat_build(readsets, tmp_path):
    rs_r, rs_p = readsets
    rs_r.save(tmp_path / "r.npz")
    rs_p.save(tmp_path / "p.npz")
    zr, zp = np.load(tmp_path / "r.npz"), np.load(tmp_path / "p.npz")
    assert zr.files == zp.files
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k]), k
    back = p_reads.ReadSet.load(tmp_path / "r.npz")
    for f in ("codes", "offsets", "quals", "bc", "bci"):
        assert np.array_equal(getattr(back, f), getattr(r_reads.ReadSet.load(tmp_path / "r.npz"), f))
    rng = np.random.default_rng(2)
    bcs = rng.integers(0, 9, rs_r.n_pairs).astype(np.int32)
    flat_r = r_reads.build_readset_flat(rs_r.codes, rs_r.offsets, rs_r.quals, bcs, n_barcodes=8)
    flat_p = p_reads.build_readset_flat(rs_p.codes, rs_p.offsets, rs_p.quals, bcs, n_barcodes=8)
    for f in ("codes", "offsets", "quals", "bc", "bci"):
        assert np.array_equal(getattr(flat_r, f), getattr(flat_p, f)), f
    sub_r = r_ingest.subsample_pairs(rs_r, 0.5, seed=3)
    sub_p = p_ingest.subsample_pairs(rs_p, 0.5, seed=3)
    assert np.array_equal(sub_r.codes, sub_p.codes) and np.array_equal(sub_r.bci, sub_p.bci)


def test_histograms_match(readsets, tmp_path):
    rs_r, _ = readsets
    table = rcount.count_readset(rs_r, min_freq=1)
    port_np = convert.table_to_numpy(convert.table_from_numpy(table, "cpu"))
    ref_spec = r_hist.kmer_spectrum(table)
    spec = p_hist.kmer_spectrum(port_np)
    for k in ("bins", "counts"):
        assert np.array_equal(ref_spec[k], spec[k]), k
    r_hist.write_hist_json(tmp_path / "r.json", "spectrum", ref_spec["bins"], ref_spec["counts"])
    p_hist.write_hist_json(tmp_path / "p.json", "spectrum", spec["bins"], spec["counts"])
    assert (tmp_path / "r.json").read_text() == (tmp_path / "p.json").read_text()
    lens = np.random.default_rng(3).integers(100, 90_000, 500)
    for a, b in ((r_hist.length_histogram(lens), p_hist.length_histogram(lens)),
                 (r_hist.reads_per_barcode_histogram(rs_r),
                  p_hist.reads_per_barcode_histogram(rs_r))):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_stat_logger_and_n50_match(tmp_path):
    lens = np.random.default_rng(4).integers(1, 10_000, 333)
    assert r_logger.n50(lens) == p_logger.n50(lens)
    assert r_logger.n50([]) == p_logger.n50([])
    for mod, name in ((r_logger, "r"), (p_logger, "p")):
        st = mod.StatLogger()
        st.log("nreads", 1234, "number of reads", cs=True, stage="ingest")
        st.log("valid_bc_perc", 12.5, "% reads with valid barcode", cs=True, stage="ingest")
        st.log("kmers_distinct", 10, stage="count")
        st.dump_json(tmp_path / f"{name}.json")
        st.dump_alerts(tmp_path / f"{name}_alerts.json")
        st.dump_csv(tmp_path / f"{name}.csv")
    for suffix in (".json", "_alerts.json", ".csv"):
        assert (tmp_path / f"r{suffix}").read_text() == (tmp_path / f"p{suffix}").read_text()
    assert json.loads((tmp_path / "p_alerts.json").read_text())  # the valid_bc alert fired
    loaded = p_logger.StatLogger.load(tmp_path / "r.json")
    assert loaded.get("nreads") == 1234


def test_gems_and_small_helpers_match(readsets):
    rs_r, _ = readsets
    assert r_gems.estimate_gem_count(rs_r.bci, rs_r.n_barcodes) == p_gems.estimate_gem_count(
        rs_r.bci, rs_r.n_barcodes)
    assert r_gems.mem_per_read_mb(0) is None and p_gems.mem_per_read_mb(0) is None
    # both read MemAvailable, which moves between the two reads: 5% slack
    a, b = r_gems.mem_per_read_mb(3_000_000), p_gems.mem_per_read_mb(3_000_000)
    assert a is not None and abs(a - b) <= 0.05 * a
    codes = np.random.default_rng(5).integers(0, 4, 97).astype(np.uint8)
    assert np.array_equal(r_dna.revcomp(codes), p_dna.revcomp(codes))
    assert r_dna.codes_to_seq(codes) == p_dna.codes_to_seq(codes)
    assert np.array_equal(r_dna.seq_to_codes("ACGTNN"), p_dna.seq_to_codes("ACGTNN"))
    rows = [codes[:5], codes[5:5], codes[5:40]]
    rr, pr = r_ragged.Ragged.from_rows(rows), p_ragged.Ragged.from_rows(rows)
    assert np.array_equal(rr.values, pr.values) and np.array_equal(rr.offsets, pr.offsets)
    quals = rs_r.quals
    book = p_pqvec.build_codebook(quals)
    assert np.array_equal(book, r_pqvec.build_codebook(quals))
    assert np.array_equal(p_pqvec.pack(quals, book), r_pqvec.pack(quals, book))


@pytest.fixture(scope="module")
def placed(readsets):
    """The reference's graph and raw paths of the readset, with every 9th
    placed read unplaced (plen 0) so that the rescue has work."""
    rs, _ = readsets
    table = r_build.trim_table(rcount.count_readset(rs))
    bg = r_graph.from_device(r_build.build_graph(table), table)
    n = rs.n_reads
    edges, plen, offset = (np.array(x)[:n] for x in r_pather.path_readset(bg, rs)[:3])
    plen[::9] = 0
    return rs, bg, edges, plen, offset


def test_rescue_and_extend_outputs_match(placed):
    rs, bg, edges, plen, offset = placed
    fs_r, fs_p = np.zeros(rs.n_reads, np.int32), np.zeros(rs.n_reads, np.int32)
    ref = r_rescue.rescue_unplaced(bg, rs, edges.copy(), plen.copy(), offset.copy(), fs_r)
    port = p_rescue.rescue_unplaced(bg, rs, edges.copy(), plen.copy(), offset.copy(), fs_p)
    assert ref[3] == port[3] > 10 and np.array_equal(fs_r, fs_p)
    for a, b in zip(ref[:3], port[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref = r_bads.extend_paths(bg, rs, *ref[:3])
    port = p_bads.extend_paths(bg, rs, *port[:3])
    assert ref[3] == port[3] > 0
    for a, b in zip(ref[:3], port[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(r_bads.mark_bads(bg, rs, *ref[:3]), p_bads.mark_bads(bg, rs, *port[:3]))
    assert np.array_equal(r_bads.unique_next_edges(bg), p_bads.unique_next_edges(bg))


def test_pathzip_and_index_outputs_match(placed, tmp_path):
    rs, bg, edges, plen, offset = placed
    edges[5, 1] = edges[7, 0]  # a path that is not graph-adjacent: the raw fallback
    plen[5] = max(plen[5], 2)
    for mod, name in ((r_pathzip, "r"), (p_pathzip, "p")):
        mod.save_zipped(tmp_path / f"{name}.npz", bg, edges, plen, offset.astype(np.int64),
                        extra={"n_edges": np.int64(bg.n_edges)})
    zr, zp = np.load(tmp_path / "r.npz"), np.load(tmp_path / "p.npz")
    assert zr.files == zp.files and len(zp["zip_raw_rows"]) >= 1
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k]), k
    for a, b in zip(r_pathzip.load_zipped(zr, bg), p_pathzip.load_zipped(zp, bg)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for fn, args in (("paths_index", (edges, plen, bg.n_edges)),
                     ("edge_barcodes", (edges, plen, rs.bc, bg.n_edges))):
        a, b = getattr(r_index, fn)(*args), getattr(p_index, fn)(*args)
        assert np.array_equal(a.values, b.values) and np.array_equal(a.offsets, b.offsets), fn
    a = r_index.edge_read_counts(edges, plen, bg.n_edges)
    b = p_index.edge_read_counts(edges, plen, bg.n_edges)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    """One simulated 10x readset written as R1/R2 FASTQs by each package."""
    d = tmp_path_factory.mktemp("fastq")
    _, _, wl, reads = simulate(r_sim, 8)
    ref = r_tenx.write_sim_fastqs(reads, d / "ref")
    port = p_tenx.write_sim_fastqs(reads, d / "port")
    return d, wl, ref, port


def fastq_text(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_fastq_round_trip_matches(fastqs):
    """write_sim_fastqs writes the same records; ingest_10x_fastqs reads them
    into the same ReadSet, paired, capped at max_pairs, and interleaved."""
    d, wl, ref, port = fastqs
    for a, b in zip(ref, port):
        assert fastq_text(a) == fastq_text(b)
    wl_r = r_ingest.Whitelist.from_codes(wl)
    wl_p = p_ingest.Whitelist.from_codes(wl)
    cases = [dict(), dict(max_pairs=100)]
    for kw in cases:
        a = r_tenx.ingest_10x_fastqs([ref[0]], [ref[1]], wl_r, **kw)
        b = p_tenx.ingest_10x_fastqs([port[0]], [port[1]], wl_p, **kw)
        assert isinstance(b, p_reads.ReadSet) and b.n_reads > 0
        for f in ("codes", "offsets", "quals", "bc", "bci", "barcoded"):
            x, y = getattr(a, f), getattr(b, f)
            assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y), (kw, f)
    inter = d / "read-RA_si-ACGTACGT_lane-001-chunk-000.fastq.gz"
    with gzip.open(port[0], "rt") as f1, gzip.open(port[1], "rt") as f2, gzip.open(inter, "wt") as o:
        while True:
            rec1, rec2 = [f1.readline() for _ in range(4)], [f2.readline() for _ in range(4)]
            if not rec1[0]:
                break
            o.writelines(rec1 + rec2)
    a = r_tenx.ingest_10x_fastqs([inter], [], wl_r, interleaved=True)
    b = p_tenx.ingest_10x_fastqs([inter], [], wl_p, interleaved=True)
    for f in ("codes", "offsets", "quals", "bc", "bci"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    rows = list(p_fastq.read_fastq(port[1]))[:3]
    assert [r[0] for r in rows] == [r[0] for r in list(r_fastq.read_fastq(ref[1]))[:3]]
    wl_txt = d / "wl.txt"
    wl_txt.write_text("\n".join(r_dna.codes_to_seq(c) + "-1" for c in wl) + "\n")
    assert np.array_equal(r_tenx.load_whitelist(wl_txt).packed, p_tenx.load_whitelist(wl_txt).packed)


def test_discovery_and_preflight_match(fastqs, tmp_path):
    """tests/test_discovery.py's layouts (bcl2fastq, two samples, an
    interleaved RA file, sample-index filter) and preflight's verdicts
    (good input, missing files, a degenerate whitelist, short reads)."""
    _, wl, ref, _ = fastqs
    layouts = {}
    d = tmp_path / "bcl2fastq" / "proj"
    d.mkdir(parents=True)
    shutil.copy(ref[0], d / "mysample_S1_L001_R1_001.fastq.gz")
    shutil.copy(ref[1], d / "mysample_S1_L001_R2_001.fastq.gz")
    layouts["one"] = tmp_path / "bcl2fastq"
    d = tmp_path / "two"
    d.mkdir()
    for s_ in ("a", "b"):
        shutil.copy(ref[0], d / f"{s_}_S1_L001_R1_001.fastq.gz")
        shutil.copy(ref[1], d / f"{s_}_S1_L001_R2_001.fastq.gz")
    layouts["two"] = d
    d = tmp_path / "ra"
    d.mkdir()
    for si in ("ACGTACGT", "ANNNNNNN"):
        shutil.copy(ref[0], d / f"read-RA_si-{si}_lane-001-chunk-000.fastq.gz")
    layouts["ra"] = d
    for name, path in layouts.items():
        assert r_discovery.detect_mode(path) == p_discovery.detect_mode(path), name
        for kw in (dict(), dict(sample="a")):
            try:
                want = r_discovery.discover_input_fastqs(path, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e).split(":")[0]):
                    p_discovery.discover_input_fastqs(path, **kw)
                continue
            assert p_discovery.discover_input_fastqs(path, **kw) == want, (name, kw)
    assert r_discovery.find_bcl_processor(layouts["ra"], sample_index="ACGTACGT") == \
        p_discovery.find_bcl_processor(layouts["ra"], sample_index="ACGTACGT")

    short = tmp_path / "short_R2.fastq.gz"
    r_fastq.write_fastq(short, [(f"r{i}", np.zeros(100, np.uint8), np.full(100, 30, np.uint8))
                                for i in range(5)])
    cases = [([str(ref[0])], [str(ref[1])], len(wl)), ([str(ref[0])], [], len(wl)),
             ([str(tmp_path / "none.fq")], [str(ref[1])], 1), ([str(ref[0])], [str(short)], len(wl))]
    for args in cases:
        a, b = r_preflight.preflight(*args), p_preflight.preflight(*args)
        assert (a.ok, a.errors, a.warnings) == (b.ok, b.errors, b.warnings), args
    assert r_preflight.preflight(*cases[0]).ok and not r_preflight.preflight(*cases[3]).ok


def test_fasta_dups_and_stackster_outputs_match(placed, tmp_path):
    """write_raw_fasta / read_fasta, mark_dups / dup_fraction /
    insert_size_stats, and stackster's consensus on the same inputs."""
    rs, bg, edges, plen, offset = placed
    for mod, name in ((r_fasta, "r"), (p_fasta, "p")):
        mod.write_raw_fasta(bg, tmp_path / f"{name}.fasta.gz")
    assert fastq_text(tmp_path / "r.fasta.gz") == fastq_text(tmp_path / "p.fasta.gz")
    assert p_fasta.read_fasta(tmp_path / "p.fasta.gz") == r_fasta.read_fasta(tmp_path / "r.fasta.gz")
    dup = r_dups.mark_dups(edges, plen, offset, rs.bc)
    assert np.array_equal(dup, p_dups.mark_dups(edges, plen, offset, rs.bc))
    assert r_dups.dup_fraction(dup) == p_dups.dup_fraction(dup)
    assert r_dups.insert_size_stats(bg, edges, plen, offset) == p_dups.insert_size_stats(
        bg, edges, plen, offset)
    rng = np.random.default_rng(9)
    bases = rng.integers(-1, 4, (30, 120)).astype(np.int8)
    quals = rng.integers(0, 41, (30, 120)).astype(np.int16)
    for a, b in zip(r_stackster.consensus(bases, quals), p_stackster.consensus(bases, quals)):
        assert np.array_equal(a, b)


def test_canon_np_is_the_original():
    """_rev16_np and _canon_np (asm/fillcheck.py's canonicalization) are the
    reference's, with the same words out on random uint32 columns."""
    same_sources(rcount, p_count, ("_rev16_np", "_canon_np"))
    rng = np.random.default_rng(12)
    cols = [rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    cols[1][:50] = cols[0][:50]  # ties in the leading words
    for a, b in zip(rcount._canon_np(*cols), p_count._canon_np(*cols)):
        assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)
    w = cols[0]
    assert np.array_equal(rcount._rev16_np(w), p_count._rev16_np(w))


def test_het_is_the_original_apart_from_its_device():
    """asm/het.py: estimate_hetdist's source is the reference's but for its
    signature (device, info) and the align_pairs call that passes them."""
    src_r = inspect.getsource(r_het.estimate_hetdist).split("\n")
    src_p = inspect.getsource(p_het.estimate_hetdist).split("\n")
    assert src_r[0] == "def estimate_hetdist(D, lines, max_bubbles: int = 200) -> float | None:"
    assert src_p[:2] == ["def estimate_hetdist(D, lines, device, max_bubbles: int = 200,",
                         "                     info: dict | None = None) -> float | None:"]
    assert src_p[2:] == [line.replace("align_pairs_np(pairs)",
                                      "align_pairs(pairs, device, info=info)")
                         for line in src_r[1:]]
    assert p_het.MIS == r_het.MIS and p_het.K == r_het.K


def test_graph_kmer_words_are_uint32(placed, tmp_path):
    """The fill gate (asm/fillcheck.py) and the scaffold stage's ownership
    context need the host graph's kmer words as uint32: after build_graph
    (from_device), after a graph.npz reload (the port's and the
    reference's) and after insert_patches."""
    rs, rbg, *_ = placed
    table = p_count.count_readset(rs, "cpu")
    bg = p_graph.from_device(p_build.build_graph(table), table)
    bg.save(tmp_path / "graph.npz")
    rbg.save(tmp_path / "ref_graph.npz")
    closures = [bg.edges.row(0)[:60].copy(), bg.edges.row(1)[:70].copy()]
    graphs = {"build": bg, "reload": p_graph.BaseGraph.load(tmp_path / "graph.npz"),
              "reference reload": p_graph.BaseGraph.load(tmp_path / "ref_graph.npz"),
              "insert_patches": p_patch.insert_patches(bg, closures, "cpu")}
    for name, g in graphs.items():
        assert g.kmer_words.dtype == np.uint32 and g.kmer_words.shape[1] == 3, name
    assert np.array_equal(graphs["build"].kmer_words, rbg.kmer_words)
    # the port's checksum (Python integers) is the reference's (numpy scalars)
    assert graphs["reference reload"].checksum() == rbg.checksum() == bg.checksum()
    g = graphs["insert_patches"]
    assert g.checksum() == r_graph.BaseGraph(**{f: getattr(g, f) for f in (
        "edges", "inv", "from_v", "to_v", "n_vertices", "is_circle")}).checksum()


ORCH = {"supernova_tpu": r_orch, "supernova_tpu_torch": p_orch}


def _chunk_square(ctx, chunk):
    return chunk["x"] ** 2


def orch_dag_order(orc, tmp_path):
    calls = []

    def stage(name, value):
        def fn(ctx, done):
            calls.append(name)
            return value(done)
        return fn
    orch = orc.Orchestrator(tmp_path)
    out = orch.run([orc.StageDef("c", stage("c", lambda d: d["a"] + d["b"]), deps=("a", "b")),
                    orc.StageDef("b", stage("b", lambda d: d["a"] + 1), deps=("a",)),
                    orc.StageDef("a", stage("a", lambda d: 1))], ctx=None)
    assert out == {"a": 1, "b": 2, "c": 3}
    assert calls.index("a") < calls.index("b") < calls.index("c")
    state = json.loads((tmp_path / "pipestance.json").read_text())
    assert state["stages"]["c"]["status"] == "complete"
    assert (state["host"], state["n_hosts"]) == (0, 1)


def orch_chunk_split_join(orc, tmp_path):
    orch = orc.Orchestrator(tmp_path)
    out = orch.run([orc.StageDef("sq", _chunk_square,
                                 split=lambda ctx, done: [{"x": i} for i in range(5)],
                                 join=lambda ctx, results: sum(results))], ctx=None)
    assert out["sq"] == 0 + 1 + 4 + 9 + 16
    assert json.loads((tmp_path / "pipestance.json").read_text())["stages"]["sq"]["chunks"] == 5


def orch_process_pool(orc, tmp_path):
    orch = orc.Orchestrator(tmp_path, processes=2)
    out = orch.run([orc.StageDef("sq", _chunk_square,
                                 split=lambda ctx, done: [{"x": i} for i in range(4)])], ctx=None)
    assert sorted(out["sq"]) == [0, 1, 4, 9]


def orch_retry_then_success(orc, tmp_path):
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError("transient")
        return "ok"
    orch = orc.Orchestrator(tmp_path)
    assert orch.run_stage("flaky", flaky, max_retries=2) == "ok"
    assert len(attempts) == 3 and orch.stage_state("flaky").attempts == 3


def orch_failure_exhausts_retries(orc, tmp_path):
    def broken():
        raise ValueError("nope")
    orch = orc.Orchestrator(tmp_path)
    with pytest.raises(orc.StageError, match="stage broken: ValueError"):
        orch.run_stage("broken", broken, max_retries=1)
    st = json.loads((tmp_path / "pipestance.json").read_text())["stages"]["broken"]
    assert st["status"] == "failed" and st["attempts"] == 2
    assert (tmp_path / "_stage_broken_traceback.txt").read_text().count("--- attempt") == 2


def orch_restore_skips_completed(orc, tmp_path):
    assert orc.Orchestrator(tmp_path).run_stage("s", lambda: 41) == 41
    orch = orc.Orchestrator(tmp_path)  # the same pipestance: restore wins

    def boom():
        raise AssertionError("must not rerun")
    assert orch.run_stage("s", boom, restore=lambda: 42) == 42
    assert orch.run_stage("s", lambda: 43) == 43  # without restore it reruns
    assert orch.stage_state("s").attempts == 2


def orch_unknown_dep(orc, tmp_path):
    with pytest.raises(ValueError, match="unknown dep"):
        orc.Orchestrator(tmp_path).run([orc.StageDef("x", lambda c, d: 0, deps=("ghost",))],
                                       ctx=None)


@pytest.mark.parametrize("pkg", sorted(ORCH))
@pytest.mark.parametrize("case", [orch_dag_order, orch_chunk_split_join, orch_process_pool,
                                  orch_retry_then_success, orch_failure_exhausts_retries,
                                  orch_restore_skips_completed, orch_unknown_dep],
                         ids=lambda f: f.__name__)
def test_orchestrate_cases(case, pkg, tmp_path):
    """tests/test_orchestrate.py's cases on either package's orchestrator."""
    case(ORCH[pkg], tmp_path)


def test_orchestrator_hosts_are_torch_distributed_ranks(tmp_path):
    """host_id and n_hosts read torch.distributed: two gloo processes each
    record their rank and the world size in pipestance.json and compute
    their round-robin share of a chunked stage (the reference's multi-host
    split); with no process group, 0 and 1."""
    code = """
import json, sys
import torch.distributed as dist
from supernova_tpu_torch.pipeline import orchestrate as orc
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert (orc.host_id(), orc.n_hosts()) == (0, 1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
res = orc.Orchestrator(f"{out}/{rank}").run(
    [orc.StageDef("sq", lambda ctx, c: c * c, split=lambda ctx, done: list(range(5)))], None)
dist.barrier()
dist.destroy_process_group()
print(json.dumps(res["sq"]), "jax" in sys.modules or "supernova_tpu" in sys.modules)
"""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert out.strip() == f"{json.dumps([[0, 4, 16], [1, 9]][rank])} False"
        state = json.loads((tmp_path / str(rank) / "pipestance.json").read_text())
        assert (state["host"], state["n_hosts"]) == (rank, 2)
        assert state["stages"]["sq"] == {"status": "complete", "attempts": 1, "chunks": 5,
                                         "error": "", "wall_s": state["stages"]["sq"]["wall_s"]}


def config_apply_and_restore(pkg):
    cfg = importlib.import_module(f"{pkg}.core.config")
    nucleate = importlib.import_module(f"{pkg}.asm.nucleate")
    old = nucleate.MIN_OVER_BASES
    prev = cfg.apply_addins({"asm.nucleate.MIN_OVER_BASES": "150"})
    assert nucleate.MIN_OVER_BASES == 150 and prev == {"asm.nucleate.MIN_OVER_BASES": old}
    cfg.restore_addins(prev)
    assert nucleate.MIN_OVER_BASES == old


def config_coercion_and_validation(pkg):
    cfg = importlib.import_module(f"{pkg}.core.config")
    scaffold = importlib.import_module(f"{pkg}.asm.scaffold")
    prev = cfg.apply_addins({f"{pkg}.asm.scaffold.ADVANTAGE": "3.5"})
    assert scaffold.ADVANTAGE == 3.5
    cfg.restore_addins(prev)
    with pytest.raises(AttributeError):
        cfg.apply_addins({"asm.scaffold.NO_SUCH_CONST": "1"})
    with pytest.raises(ValueError):
        cfg.apply_addins({"asm.scaffold.shared_count": "1"})  # not UPPER_CASE
    with pytest.raises(ValueError):
        cfg.parse_addin_args(["missing_equals"])


def config_addin_affects_behavior(pkg):
    """kmer.count.MIN_FREQ is read at call time: a stricter filter keeps
    fewer kmers."""
    cfg = importlib.import_module(f"{pkg}.core.config")
    sim = importlib.import_module(f"{pkg}.sim.genome")
    kc = importlib.import_module(f"{pkg}.kmer.count")
    ingest = importlib.import_module(f"{pkg}.ingest.ingest")
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 4000)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 64)
    reads = sim.simulate_linked_reads(rng, (g, hb), wl, n_barcodes=30, molecules_per_barcode=2,
                                      molecule_len=2000, coverage_per_molecule=2.5)
    rs = ingest.ingest_sim(reads, wl)
    count = (lambda: kc.count_readset(rs)) if pkg == "supernova_tpu" else (
        lambda: kc.count_readset(rs, "cpu"))
    base = int(count().n_valid)
    prev = cfg.apply_addins({"kmer.count.MIN_FREQ": "9"})
    try:
        strict = int(count().n_valid)
    finally:
        cfg.restore_addins(prev)
    assert strict < base


def config_addin_reaches_its_own_package(pkg):
    """`--addin asm.star.MIN_ADVANTAGE=40` sets that package's constant and
    leaves the other package's alone."""
    cfg = importlib.import_module(f"{pkg}.core.config")
    other = "supernova_tpu_torch" if pkg == "supernova_tpu" else "supernova_tpu"
    star, other_star = (importlib.import_module(f"{p}.asm.star") for p in (pkg, other))
    prev = cfg.apply_addins(cfg.parse_addin_args(["asm.star.MIN_ADVANTAGE=40"]))
    try:
        assert star.MIN_ADVANTAGE == 40.0 and other_star.MIN_ADVANTAGE == 60.0
    finally:
        cfg.restore_addins(prev)
    assert star.MIN_ADVANTAGE == 60.0


@pytest.mark.parametrize("pkg", sorted(ORCH))
@pytest.mark.parametrize("case", [config_apply_and_restore, config_coercion_and_validation,
                                  config_addin_affects_behavior,
                                  config_addin_reaches_its_own_package],
                         ids=lambda f: f.__name__)
def test_config_cases(case, pkg):
    """tests/test_config.py's cases on either package's addin registry."""
    case(pkg)


HOST_HALVES = {
    "align.fmindex": ("FMIndex.occ", "FMIndex.backward_search", "FMIndex.count",
                      "FMIndex.locate"),
    "parallel.sharded_scaffold": ("split_incidence",),
    "parallel.sharded_phase": ("split_votes",),
}


def attr_path(mod, dotted):
    for name in dotted.split("."):
        mod = getattr(mod, name)
    return mod


@pytest.mark.parametrize("mod", sorted(HOST_HALVES))
def test_fmindex_and_mesh_host_halves_are_the_original(mod):
    """The FM-index's host query and the mesh modules' host prep are the
    reference's source, with the same outputs: the query on indexes built
    by either package (tests/test_torch_fmindex.py holds the builds equal),
    the shards on the same rows."""
    ref = importlib.import_module(f"supernova_tpu.{mod}")
    port = importlib.import_module(f"supernova_tpu_torch.{mod}")
    for name in HOST_HALVES[mod]:
        assert inspect.getsource(attr_path(ref, name)) == inspect.getsource(attr_path(port, name))
    rng = np.random.default_rng(21)
    if mod == "align.fmindex":
        edges = [rng.integers(0, 4, int(rng.integers(40, 200)), dtype=np.uint8) for _ in range(9)]
        fr, fp = ref.FMIndex.from_edges(edges), port.FMIndex.from_edges(edges, device="cpu")
        for _ in range(40):
            e = edges[int(rng.integers(len(edges)))]
            s = int(rng.integers(0, len(e) - 12))
            pat = e[s : s + int(rng.integers(1, 12))]
            assert fr.count(pat) == fp.count(pat)
            assert np.array_equal(fr.locate(pat), fp.locate(pat))
            r = rng.integers(0, len(fr.bwt) + 1, 7)
            assert np.array_equal(fr.occ(r, pat[0]), fp.occ(r, pat[0]))
        return
    split = HOST_HALVES[mod][0]
    for n, n_dev in ((0, 3), (1, 1), (700, 8), (3000, 3)):
        a, b = rng.integers(0, 2**31 - 1, (2, n)).astype(np.int32)
        for x, y in zip(getattr(ref, split)(a, b, n_dev), getattr(port, split)(a, b, n_dev)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
