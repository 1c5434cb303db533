"""stats/rung.py through evaluate on the CPU, held to the JAX package's own
`simulate`, `run --flavors raw,pseudohap` and `evaluate` of the same
arguments (scripts/val10mb.sh's three commands at a small size), each side
in fresh processes and both sides at once.  At these arguments (150 kb, 3
repeat chunks, 60 barcodes, seed 11) the reference takes the star-gap
route: all fifteen scaffold phases run.  Held equal: summary.json less its
etime_* keys, alerts.json, evaluate's dict, both FASTA files and
scaffold_mode, and every key of stats/rung_record.py's record of either
outdir.  The rung imports no jax and nothing of supernova_tpu."""
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from supernova_tpu.stats import logger as rlogger
from supernova_tpu_torch.stats import logger as plogger
from supernova_tpu_torch.stats import rung
from supernova_tpu_torch.stats import rung_record as rr

REPO = Path(__file__).resolve().parents[1]
ARGS = dict(genome_size=150_000, repeats=3, barcodes=60, whitelist_size=256, seed=11)
FLAGS = [x for k, v in ARGS.items() for x in (f"--{k.replace('_', '-')}", str(v))]
PHASES = ("splay", "star", "fix", "starstar", "presize", "stackaroo", "unvoid", "void",
          "patch", "mis", "invfix", "canon", "gaprika", "audit", "fase")
KERNELS = {"kmer_extract", "compact", "run_reduce", "sort", "scan_max"}


def reference_run(root: Path, env: dict) -> dict:
    """The JAX package's simulate, run and evaluate in root/ref, a fresh
    process each -> evaluate's dict."""
    sim, run = root / "ref" / "sim", root / "ref" / "run"
    py = [sys.executable, "-m", "supernova_tpu"]
    for argv in ([*py, "simulate", "--out", str(sim), *FLAGS],
                 [*py, "run", "--r1", str(sim / "sample_R1.fastq.gz"),
                  "--r2", str(sim / "sample_R2.fastq.gz"),
                  "--whitelist", str(sim / "whitelist.txt"),
                  "--out", str(run), "--flavors", "raw,pseudohap", "--resume"]):
        out = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=root, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
    out = subprocess.run([*py, "evaluate", "--fasta", str(run / "assembly.pseudohap.fasta.gz"),
                          "--truth", str(sim / "truth_hap_a.npy"), str(sim / "truth_hap_b.npy")],
                         capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    (root / "ref" / "eval.json").write_text(out.stdout)
    return rr.load_eval(root / "ref" / "eval.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rung (one intra-op thread) and the reference side, started
    together -> (root, the rung's JSON lines, the reference's evaluate)."""
    root = tmp_path_factory.mktemp("rung_full")
    argv = ["--out", str(root / "port"), *FLAGS, "--through", "evaluate", "--device", "cpu"]
    code = ("import json, sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from supernova_tpu_torch.stats import rung\n"
            f"rc = rung.main({argv!r})\n"
            "print(json.dumps({'rc': rc, 'foreign': sorted(m for m in sys.modules\n"
            "      if m.split('.')[0] in ('jax', 'jaxlib', 'supernova_tpu'))}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    with open(root / "rung.out", "w") as out, open(root / "rung.err", "w") as err:
        port = subprocess.Popen([sys.executable, "-c", code], stdout=out, stderr=err, env=env,
                                cwd=root)
        try:
            ref_eval = reference_run(root, env)
        finally:
            rc = port.wait(timeout=600)
    assert rc == 0, (root / "rung.err").read_text()[-2000:]
    lines = [json.loads(x) for x in (root / "rung.out").read_text().splitlines()]
    return root, lines, ref_eval


def test_rung_through_evaluate_steps_and_fields(runs):
    """Every step's line in order, the new steps' fields, every stage's
    kernel launches; no jax or supernova_tpu module imported."""
    _, lines, _ = runs
    assert lines[-1] == {"rc": 0, "foreign": []}
    by = {x["step"]: x for x in lines[:-1]}
    assert [x["step"] for x in lines[:-1]] == [
        "simulate", "fastq ingest", "ingest", "count", "graph", "paths", "patch",
        "supergraph", "scaffold", "fasta", "evaluate", "compare"]
    for step in ("ingest", "count", "graph", "paths", "patch", "supergraph", "scaffold", "fasta"):
        assert set(by[step]["launches"]) == KERNELS, step
        assert by[step]["host_RssAnon_peak_gb"] <= by[step]["host_VmRSS_peak_gb"]
        assert by[step]["disk_free_gb_after"] > 0
    assert by["count"]["kmers"] > 100_000 and by["patch"]["rebuild_kmers"] > 0
    assert by["supergraph"]["glue_route"] == "host" and by["supergraph"]["glue_overflow"] == 0
    assert by["supergraph"]["glue_positions"] > 0
    sc = by["scaffold"]
    assert sc["scaffold_mode"] == "star-gap" and sc["star_gap_joins"] + sc["barcode_joins"] > 0
    assert tuple(sc["phase_s"]) == PHASES and sc["n_scaffolds"] > 0
    assert sc["het_pairs"] > 0 and sc["het_dp_s"] >= 0
    for fl in ("raw", "pseudohap"):
        assert by["fasta"][fl]["records"] > 0 and by["fasta"][fl]["bases"] > 100_000
    assert by["evaluate"]["anchored_frac"] > 0.9 and by["evaluate"]["process_max_rss_gb"] > 0
    assert by["compare"]["compare"] == {}  # no recorded rung at these arguments


def _text(path: Path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def test_rung_outputs_equal_the_reference(runs):
    """summary.json less etime_*, alerts.json, evaluate's dict, both FASTA
    files and scaffold_mode: the JAX package's own, key for key."""
    root, _, ref_eval = runs
    port, ref = root / "port" / "run", root / "ref" / "run"
    load = lambda p: json.loads(p.read_text())
    timing = lambda d: {k: v for k, v in d.items() if not k.startswith("etime_")}
    assert timing(load(port / "summary.json")) == timing(load(ref / "summary.json"))
    assert load(port / "alerts.json") == load(ref / "alerts.json")
    assert rr.load_eval(root / "port" / "eval.json") == ref_eval
    for fl in ("raw", "pseudohap"):
        assert _text(port / f"assembly.{fl}.fasta.gz") == _text(ref / f"assembly.{fl}.fasta.gz")
    mode = load(ref / "all_stats.json")["scaffold_mode"]
    assert mode == load(port / "all_stats.json")["scaffold_mode"] == "star-gap"


def test_rung_record_of_both_outdirs_compares_equal(runs):
    """rung_record's record of the rung's outdir against the reference's:
    every key equal; a changed key differs and a missing one is not run."""
    root, lines, ref_eval = runs
    pairs = lines[0]["pairs"]
    want = rr.flatten(rr.assembly_record(root / "ref" / "run", ref_eval, pairs=pairs))
    got = rr.flatten(rr.assembly_record(root / "port" / "run",
                                        rr.load_eval(root / "port" / "eval.json"), pairs=pairs))
    assert {k: v["result"] for k, v in rr.compare(want, got).items()} == dict.fromkeys(
        want, "equal")
    assert {"summary.assembly_checksum", "alerts", "eval.misassemblies", "fasta.pseudohap",
            "histogram_scaffold", "joins.star_gap_joins", "scaffold_mode"} <= set(want)
    assert not any(k.startswith(("summary.etime_", "all_stats.mem_peak_")) for k in want)
    got["eval.misassemblies"] += 1
    del got["histogram_scaffold"]
    res = rr.compare(want, got)
    assert res["eval.misassemblies"]["result"] == "differs"
    assert res["histogram_scaffold"] == dict(reference=rr.short(want["histogram_scaffold"]),
                                             ours=None, result="not run")
    assert res["histogram_scaffold"]["reference"].startswith("sha256:")


def test_the_10mb_record_is_the_reference_run():
    """REFERENCE's 10 Mb rung holds the JAX package's CPU run of
    scripts/val10mb.sh's arguments: its record file, commit and commands,
    taken through every stage and evaluate."""
    ref = rung.REFERENCE[(10_000_000, 200, 4000, 16384, 11)]
    assert "scripts/val10mb.sh" in ref["source"] and ref["record"] in ref["source"]
    rec = rr.load_record(ref["record"])
    assert len(rec["commit"]) == 40 and len(rec["commands"]) == 3
    assert all("--seed 11" in c or "evaluate" in c or "run" in c for c in rec["commands"])
    flat = rr.flatten(rec)
    assert {"pairs", "kmers", "scaffold_mode", "assembly_checksum", "alerts",
            "fasta.raw", "fasta.pseudohap", "eval.anchored_frac"} <= set(flat)
    assert not any(k.startswith(rr.HOST_PREFIXES) or k in rr.HOST_KEYS
                   for d in (rec["summary"], rec["all_stats"]) for k in d)


@pytest.mark.parametrize("logger", [rlogger, plogger], ids=["reference", "port"])
def test_a_resumed_logger_forgets_the_summary_keys(logger, tmp_path):
    """A known reference defect, kept: StatLogger.load rebuilds its entries
    from all_stats.json without their cs flags, so a resumed run's
    summary.json lacks every summary key that only an earlier run logged
    (artifacts/val10mb_r5's summary.json lacks edge_N50, lw_mean_mol_len,
    median_ins_sz and proper_pairs_perc for this cause).  The rung runs
    every stage in one command for it."""
    st = logger.StatLogger()
    st.log("edge_N50", 1299, "unipath edge N50", cs=True)
    st.log("n_edges", 58950)
    st.dump_json(tmp_path / "all_stats.json")
    st.dump_json(tmp_path / "summary.json", cs_only=True)
    assert json.loads((tmp_path / "summary.json").read_text()) == {"edge_N50": 1299}
    again = logger.StatLogger.load(tmp_path / "all_stats.json")
    again.log("nreads", 3151160, "number of reads", cs=True)
    again.dump_json(tmp_path / "summary.json", cs_only=True)
    assert json.loads((tmp_path / "summary.json").read_text()) == {"nreads": 3151160}
    assert again.get("edge_N50") == 1299
