"""The port's copies of the JAX package's host modules (ingest, sim, core
dna/ragged/pqvec, stats gems/histograms/logger, the feudal 2-bit packing)
against their originals: the same source apart from the note that names
the original, and the same outputs on the same inputs."""
import inspect
import json
from pathlib import Path

import numpy as np
import pytest

import supernova_tpu_torch.core.pqvec as p_pqvec
import supernova_tpu_torch.core.ragged as p_ragged
import supernova_tpu_torch.ingest.feudal as p_feudal
import supernova_tpu_torch.ingest.ingest as p_ingest
import supernova_tpu_torch.ingest.reads as p_reads
import supernova_tpu_torch.sim.genome as p_sim
import supernova_tpu_torch.stats.gems as p_gems
import supernova_tpu_torch.stats.histograms as p_hist
import supernova_tpu_torch.stats.logger as p_logger
from supernova_tpu.core import dna as r_dna
from supernova_tpu.core import pqvec as r_pqvec
from supernova_tpu.core import ragged as r_ragged
from supernova_tpu.ingest import feudal as r_feudal
from supernova_tpu.ingest import ingest as r_ingest
from supernova_tpu.ingest import reads as r_reads
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
          "stats/histograms.py", "stats/logger.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_source(path):
    """Only the docstring paragraph naming the original was added."""
    orig = (REPO / "supernova_tpu" / path).read_text().split("\n")
    copy = (REPO / "supernova_tpu_torch" / path).read_text().split("\n")
    note_end = copy.index("", 2)
    assert "The port's own copy of" in " ".join(copy[2:note_end])
    assert copy[:1] + copy[note_end:] == orig


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
