"""The port's Pipeline.run against the reference's, on the CPU: the same
readset, made from a numpy seed, through supernova_tpu's Pipeline.run and
supernova_tpu_torch's Pipeline(device="cpu").run.  Every comparison is
exact: the decompressed assembly.raw.fasta.gz bytes, the arrays of
kmers.npz, graph.npz and paths.npz, the reads of reads.npz, and the values
of summary.json apart from the timing keys (etime_*, mem_*).  Also the
exit-alert refusal, resume from either package's outdir, the lazy
(disk-memmap) readset, user downsampling and the coverage guard."""
import gzip
import json
import shutil

import numpy as np
import pytest
import torch

from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as rcount
from supernova_tpu.pipeline import run as rrun
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch.align import pather as ppather
from supernova_tpu_torch.dbg import build as pbuild
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.pipeline import run as prun

from tests.test_torch_slice import assert_npz_equal

TIMING = ("etime_", "mem_")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker (as in
    tests/test_torch_partitioned.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def e2e_reads(rng):
    """The genome and readset of tests/test_pipeline_e2e.py's raw-assembly
    test (5 kb, 40 barcodes)."""
    g = sim.random_genome(rng, 5000, n_repeat_chunks=1, repeat_len=200)
    _, hb = sim.diploidize(rng, g, het_rate=0.0005)
    wl = sim.make_whitelist(rng, 128)
    return sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=40, molecules_per_barcode=3, molecule_len=2500,
        coverage_per_molecule=2.0, error_rate=0.002, bc_error_rate=0.01,
    ), wl


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    reads, wl = e2e_reads(np.random.default_rng(0))
    rs = ingest_sim(reads, wl)
    ref_out, port_out = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref_bg, ref_fa = rrun.Pipeline(ref_out).run(rs)
    pl = prun.Pipeline(port_out, device="cpu")
    bg, fa = pl.run(rs)
    return rs, (ref_out, ref_bg, ref_fa), (port_out, pl, bg, fa)


def fasta_bytes(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def summary(out):
    return {k: v for k, v in json.loads((out / "summary.json").read_text()).items()
            if not k.startswith(TIMING)}


def test_raw_fasta_matches_reference(runs):
    _, (_, _, ref_fa), (port_out, _, _, fa) = runs
    assert fa == port_out / "assembly.raw.fasta.gz"
    got = fasta_bytes(fa)
    assert got == fasta_bytes(ref_fa) and got.count(b">") > 1


@pytest.mark.parametrize("name", ["kmers.npz", "graph.npz", "paths.npz", "reads.npz"])
def test_checkpoint_matches_reference(runs, name):
    _, (ref_out, *_), (port_out, *_) = runs
    assert_npz_equal(ref_out / name, port_out / name)


def test_summary_matches_reference(runs):
    """summary.json, summary_cs.csv's keys, alerts.json and the stats text:
    the same values apart from timing."""
    _, (ref_out, *_), (port_out, pl, *_) = runs
    ref, got = summary(ref_out), summary(port_out)
    assert got == ref and {"nreads", "edge_N50", "est_coverage"} <= set(got)
    assert json.loads((port_out / "summary.json").read_text()).keys() == json.loads(
        (ref_out / "summary.json").read_text()).keys()
    assert (port_out / "alerts.json").read_text() == (ref_out / "alerts.json").read_text()
    for name in ("summary_cs.csv", "stats/summary.txt", "stats/histogram_kmer_count.json"):
        assert (port_out / name).exists(), name
    for st in ("ingest", "count", "graph", "paths", "fasta"):
        assert pl.stage_records[st]["wall_s"] > 0 and "launches" in pl.stage_records[st]


def test_exit_alert_refuses_like_the_reference(tmp_path):
    """tests/test_pipeline_e2e.py's exit-alert case: 100-base reads."""
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 800)
    wl = sim.make_whitelist(rng, 16)
    reads = sim.simulate_linked_reads(
        rng, (g, g), wl, n_barcodes=4, molecules_per_barcode=1, molecule_len=600,
        read_len=100, coverage_per_molecule=1.0, insert_size=220,
    )
    rs = ingest_sim(reads, wl)
    msgs = []
    for pl in (rrun.Pipeline(tmp_path / "ref"), prun.Pipeline(tmp_path / "port", device="cpu")):
        with pytest.raises(RuntimeError, match="preflight exit alerts") as e:
            pl.run(rs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert (tmp_path / "port" / "alerts.json").read_text() == (
        tmp_path / "ref" / "alerts.json").read_text()
    assert not (tmp_path / "port" / "kmers.npz").exists()


def test_other_flavors_are_refused_before_any_work(tmp_path):
    """run() writes the raw flavor, as the reference's does; the others come
    from run_full's scaffold and phase stages."""
    pl = prun.Pipeline(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="run_full"):
        pl.run(None, flavor="pseudohap")
    with pytest.raises(ValueError, match="unknown flavor"):
        pl.run(None, flavor="fastb")
    with pytest.raises(ValueError, match="unknown flavor"):
        pl.stage_fasta(None, "fastb")


def refuse(*a, **kw):
    raise AssertionError("recomputed a stage that resume should reload")


def test_resume_from_the_reference_outdir(runs, tmp_path, monkeypatch):
    """A port run resumed from the reference's outdir reloads kmers.npz,
    graph.npz and paths.npz (no count, build or pather) and writes the
    reference's FASTA."""
    rs, (ref_out, _, ref_fa), _ = runs
    for name in ("port", "ref"):
        shutil.copytree(ref_out, tmp_path / name)
        (tmp_path / name / "assembly.raw.fasta.gz").unlink()
    _, ref_fa2 = rrun.Pipeline(tmp_path / "ref", resume=True).run(rs)
    for mod, name in ((kcount, "count_readset"), (pbuild, "build_graph"),
                      (ppather, "path_readset")):
        monkeypatch.setattr(mod, name, refuse)
    _, fa = prun.Pipeline(tmp_path / "port", device="cpu", resume=True).run(rs)
    assert fasta_bytes(fa) == fasta_bytes(ref_fa) == fasta_bytes(ref_fa2)
    # a resumed run re-logs only what it recomputes, in both packages
    assert summary(tmp_path / "port") == summary(tmp_path / "ref")
    assert_npz_equal(tmp_path / "ref" / "ebcx.npz", tmp_path / "port" / "ebcx.npz")


def test_resume_after_the_graph_stage_does_not_count(runs, tmp_path, monkeypatch):
    """A port run killed after its graph stage (no paths.npz, no FASTA)
    resumes without counting or building and gives the same FASTA and
    paths.npz."""
    rs, _, (port_out, _, _, fa) = runs
    out = tmp_path / "killed"
    shutil.copytree(port_out, out)
    for name in ("paths.npz", "ebcx.npz", "assembly.raw.fasta.gz", "summary.json"):
        (out / name).unlink()
    monkeypatch.setattr(kcount, "count_readset", refuse)
    monkeypatch.setattr(pbuild, "build_graph", refuse)
    pl = prun.Pipeline(out, device="cpu", resume=True)
    _, fa2 = pl.run(rs)
    assert fasta_bytes(fa2) == fasta_bytes(fa)
    assert_npz_equal(port_out / "paths.npz", out / "paths.npz")
    assert_npz_equal(port_out / "ebcx.npz", out / "ebcx.npz")


def test_lazy_readset_gives_the_same_fasta(tmp_path, monkeypatch):
    """The reference's lazy-readset test (tests/test_pipeline_e2e.py) with
    LAZY_READS_MIN_BASES = 0 in both packages, through run(): both re-home
    the reads onto reads.lazy/ and write the same FASTA."""
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 6000, n_repeat_chunks=1, repeat_len=150)
    _, hb = sim.diploidize(rng, g, het_rate=0.001)
    wl = sim.make_whitelist(rng, 128)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=50, molecules_per_barcode=2, molecule_len=3000,
        coverage_per_molecule=2.0, error_rate=0.001,
    )
    monkeypatch.setattr(rrun, "LAZY_READS_MIN_BASES", 0)
    monkeypatch.setattr(prun, "LAZY_READS_MIN_BASES", 0)
    _, ref_fa = rrun.Pipeline(tmp_path / "ref").run(ingest_sim(reads, wl))
    pl = prun.Pipeline(tmp_path / "port", device="cpu")
    _, fa = pl.run(ingest_sim(reads, wl))
    assert (tmp_path / "port" / "reads.lazy" / "codes.npy").exists()
    assert pl.stats.get("reads_lazy") == 1
    assert fasta_bytes(fa) == fasta_bytes(ref_fa)
    assert_npz_equal(tmp_path / "ref" / "paths.npz", tmp_path / "port" / "paths.npz")


@pytest.mark.parametrize("downsample", [{"target_reads": 1000}, {"gigabases": 0.0001}])
def test_user_downsampling_keeps_the_reference_reads(runs, tmp_path, downsample):
    rs = runs[0]
    ref = rrun.Pipeline(tmp_path / "ref", downsample=downsample)
    port = prun.Pipeline(tmp_path / "port", device="cpu", downsample=downsample)
    a, b = ref.stage_ingest(rs), port.stage_ingest(rs)
    assert b.n_reads < rs.n_reads
    for f in ("codes", "offsets", "quals", "bc", "bci"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert port.stats.get("downsample_frac") == ref.stats.get("downsample_frac")
    assert_npz_equal(tmp_path / "ref" / "reads.npz", tmp_path / "port" / "reads.npz")


def test_coverage_guard_downsamples_like_the_reference(tmp_path, monkeypatch):
    """estimate_coverage says 120x in both packages: both subsample to 56x
    and recount to the same table (the guard needs >= 50,000 kmers)."""
    rng = np.random.default_rng(3)
    g = sim.random_genome(rng, 60_000)
    wl = sim.make_whitelist(rng, 64)
    reads = sim.simulate_linked_reads(
        rng, (g, g), wl, n_barcodes=40, molecules_per_barcode=3, molecule_len=12_000,
        coverage_per_molecule=1.0, error_rate=0.0,
    )
    rs = ingest_sim(reads, wl)
    high = lambda table, rl=150.0: (120.0, 60_000)
    monkeypatch.setattr(rcount, "estimate_coverage", high)
    monkeypatch.setattr(kcount, "estimate_coverage", high)
    ref = rrun.Pipeline(tmp_path / "ref")
    port = prun.Pipeline(tmp_path / "port", device="cpu")
    _, rs_r = ref._count_with_cov_guard(rs)
    table, rs_p = port._count_with_cov_guard(rs)
    assert int(table.n_valid) > 0 and rs_p.n_reads < rs.n_reads
    assert port.stats.get("downsample_frac_auto") == ref.stats.get("downsample_frac_auto") == 56 / 120
    for f in ("codes", "offsets", "bc"):
        assert np.array_equal(getattr(rs_r, f), getattr(rs_p, f)), f
    assert_npz_equal(tmp_path / "ref" / "kmers.npz", tmp_path / "port" / "kmers.npz")
