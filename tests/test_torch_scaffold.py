"""The port's Pipeline.run_full against the reference's on the CPU, on the
e2e genome (tests/test_pipeline_e2e.py's 5 kb diploid genome, 40
barcodes): the same readset through supernova_tpu's Pipeline.run_full and
supernova_tpu_torch's Pipeline(device="cpu").run_full.  Exact equality of
the decompressed bytes of the four FASTA flavors (and efasta, through
stage_fasta), graph.gfa.gz and supergraph.gfa.gz; summary.json and
all_stats.json apart from the timing keys (and the port's glue keys); every
stats/histogram_*.json; the final/a.sup* files' arrays; the contents of
assembly_state.pkl; and the returned (D, lines, scaffolds, phasings).
tests/test_torch_scaffold_star.py does the same on the star-gap fixture,
with the scaffold phases' snapshots and resume."""
import dataclasses
import gzip
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.pipeline import run as rrun
from supernova_tpu_torch.pipeline import datasets
from supernova_tpu_torch.pipeline import run as prun

from tests.test_torch_run import TIMING, e2e_reads
from tests.test_torch_slice import assert_npz_equal

# the port-only stats of its supergraph stage (tests/test_torch_supergraph.py)
GLUE_KEYS = ("glue_route", "glue_overflow", "glue_positions")
OUTPUTS = ("assembly.raw.fasta.gz", "assembly.megabubbles.fasta.gz",
           "assembly.pseudohap.fasta.gz", "assembly.pseudohap2.fasta.gz", "graph.gfa.gz",
           "supergraph.gfa.gz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gz_bytes(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def to_plain(x):
    """An object graph as nested tuples of plain values, naming classes by
    their name only (the two packages' classes share names): arrays by dtype
    and values, dataclasses and objects by their fields (a graph's device
    tensors and functions left out)."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return ("dict", tuple(sorted((to_plain(k), to_plain(v)) for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(to_plain(v) for v in x))
    if dataclasses.is_dataclass(x) or hasattr(x, "__dict__"):
        fields = {k: v for k, v in vars(x).items()
                  if k != "_device_arrays" and not callable(v)}
        return (type(x).__name__, tuple((k, to_plain(v)) for k, v in sorted(fields.items())))
    return x


def stats_of(out, name):
    return {k: v for k, v in json.loads((Path(out) / name).read_text()).items()
            if not k.startswith(TIMING)}


def assert_outputs_equal(ref_out, port_out, glue=True, resumed=False):
    """run_full's files in two outdirs: the FASTA and GFA bytes,
    summary.json and all_stats.json apart from timing (the port's
    all_stats.json also holds its glue keys when `glue`), the histograms,
    the final/a.sup* arrays and assembly_state.pkl's contents.  With
    `resumed`, port_out is a resumed run of ref_out's: both packages re-log
    only what a resumed run recomputes, so its stats are a subset of the
    whole run's, with the same values."""
    ref_out, port_out = Path(ref_out), Path(port_out)
    for name in OUTPUTS:
        got = gz_bytes(port_out / name)
        assert got == gz_bytes(ref_out / name) and got.count(b">") + got.count(b"S\t") > 0, name
    for name in ("summary.json", "all_stats.json"):
        want, got = stats_of(ref_out, name), stats_of(port_out, name)
        extra = set(GLUE_KEYS) if glue and name == "all_stats.json" else set()
        if resumed:
            want = {k: v for k, v in want.items() if k in got}
        assert {k: got[k] for k in want} == want and set(got) - set(want) == extra, name
    assert json.loads((port_out / "summary.json").read_text()).keys() <= json.loads(
        (ref_out / "summary.json").read_text()).keys()
    hists = sorted(p.name for p in (ref_out / "stats").glob("histogram_*.json"))
    assert hists == sorted(p.name for p in (port_out / "stats").glob("histogram_*.json"))
    assert len(hists) == 7  # kmer count, molecules and run_full's five
    for name in hists:
        assert (port_out / "stats" / name).read_text() == (ref_out / "stats" / name).read_text()
    finals = sorted(p.name for p in (ref_out / "final").glob("*.npz"))
    assert finals == sorted(p.name for p in (port_out / "final").glob("*.npz")) and finals
    for name in finals:
        assert_npz_equal(ref_out / "final" / name, port_out / "final" / name)
    with open(ref_out / "assembly_state.pkl", "rb") as f:
        want = pickle.load(f)
    with open(port_out / "assembly_state.pkl", "rb") as f:
        got = pickle.load(f)
    assert type(got["D"]).__module__ == "supernova_tpu_torch.asm.supergraph"
    assert to_plain(got) == to_plain(want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    reads, wl = e2e_reads(np.random.default_rng(0))
    rs = ingest_sim(reads, wl)
    ref_out, port_out = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref = rrun.Pipeline(ref_out)
    ref_res = ref.run_full(rs)
    port = prun.Pipeline(port_out, device="cpu")
    port_res = port.run_full(rs)
    return rs, (ref_out, ref, ref_res), (port_out, port, port_res)


def test_recipe_is_the_tests_genome():
    """datasets.e2e_reads (the port's simulator) makes tests/test_torch_run.py's
    reads, which chip_smoke.py runs through run_full on the card."""
    want, wl_r = e2e_reads(np.random.default_rng(0))
    got, wl_p = datasets.e2e_reads(np.random.default_rng(0))
    assert np.array_equal(wl_r, wl_p)
    for f in ("r1", "q1", "r2", "q2", "barcode", "bc_qual", "truth_pos", "truth_hap"):
        assert np.array_equal(np.asarray(getattr(want, f)), np.asarray(getattr(got, f))), f


def test_outputs_match_reference(runs):
    _, (ref_out, *_), (port_out, *_) = runs
    assert_outputs_equal(ref_out, port_out)


def test_returned_assembly_matches_reference(runs):
    """(D, lines, scaffolds, phasings) and the flavors' paths."""
    _, (ref_out, _, ref_res), (port_out, _, port_res) = runs
    assert to_plain(port_res[:4]) == to_plain(ref_res[:4])
    assert {k: v.relative_to(port_out) for k, v in port_res[4].items()} == {
        k: v.relative_to(ref_out) for k, v in ref_res[4].items()}
    assert list(port_res[4]) == ["raw", "megabubbles", "pseudohap", "pseudohap2"]


def test_efasta_matches_reference(runs, tmp_path):
    """The fifth flavor, which run_full does not write by default, from the
    same assembly through each package's stage_fasta."""
    _, (_, ref, ref_res), (_, port, port_res) = runs
    ref.outdir, port.outdir = tmp_path / "ref", tmp_path / "port"
    ref.outdir.mkdir()
    port.outdir.mkdir()
    a = ref.stage_fasta(ref_res[0].bg, "efasta", ctx=ref_res[:4])
    b = port.stage_fasta(port_res[0].bg, "efasta", ctx=port_res[:4])
    assert b.name == a.name == "assembly.efasta.gz"
    assert gz_bytes(b) == gz_bytes(a) and gz_bytes(b).count(b">") > 0


def test_scaffold_stage_record(runs):
    """The stage record holds the het DP's pairs, shape and seconds (not in
    all_stats.json), and every run_full stage is timed under the
    reference's names; the e2e genome has bubbles to align."""
    _, _, (port_out, port, _) = runs
    rec = port.stage_records["scaffold"]
    assert rec["het_pairs"] >= 1 and len(rec["het_shape"]) == 2 and rec["het_dp_s"] > 0
    assert port.stats.get("hetdist_aligned") > 0
    assert set(port.stage_records) == {"count", "graph", "paths", "patch", "supergraph",
                                       "scaffold"}
    assert not {"het_pairs", "phase_s"} & set(json.loads((port_out / "all_stats.json").read_text()))


def test_run_full_refuses_an_unknown_flavor_before_any_work(tmp_path):
    pl = prun.Pipeline(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="unknown flavor"):
        pl.run_full(None, flavors=("raw", "fastb"))
    assert not (tmp_path / "reads.npz").exists()


def test_stat_keys_match_reference(runs):
    """Fault C6: run_full's all_stats.json has the reference's stat keys,
    its stage timer's too (etime_<stage>_h, mem_peak_host_<stage>_gb),
    values aside; off CUDA the port logs no mem_peak_<stage>_gb, whose
    reference value on the CPU is the bytes of live JAX arrays.  The port's
    own additions are the closure glue's route stats."""
    from tests.test_torch_supergraph import GLUE_KEYS

    _, (ref_out, _, _), (port_out, port, _) = runs
    want = set(json.loads((ref_out / "all_stats.json").read_text()))
    got = set(json.loads((port_out / "all_stats.json").read_text()))
    device_peaks = {k for k in want if k.startswith("mem_peak_") and
                    not k.startswith("mem_peak_host_")}
    assert device_peaks and got == (want - device_peaks) | set(GLUE_KEYS)
    for name, rec in port.stage_records.items():
        assert f"mem_peak_host_{name}_gb" in got and f"etime_{name}_h" in got
        assert rec["host_peak_gb"] > 0 and rec["peak_gb"] is None
