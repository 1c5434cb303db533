"""The port's command line (supernova_tpu_torch/cli.py) against the
reference's (supernova_tpu/cli.py), on the CPU: both `cli.main`s in this
process on tests/test_cli.py's simulation (6 kb genome, 40 barcodes).

`simulate` writes the same FASTQ records (decompressed: the gzip header
holds the write time), whitelist and truth arrays.  `run` (the port with
--device cpu) gives the same four FASTA flavors, summary.json and printed
summary (timing keys aside), pipestance.json (walls aside), .mri.tgz
member names and exit code; so do `--resume` (on a copy of the
reference's outdir, with an addin), a stage that raises once, and a stage
that always raises (exit 185, both packages monkeypatched the same way).
Every tool subcommand prints the same stdout and writes the same files on
the same run dir.  The port refuses --device cuda without a card and a
reference's assembly_state.pkl in mkoutput, importing no supernova_tpu
module."""
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from supernova_tpu import cli as rcli
from supernova_tpu.asm import star as rstar
from supernova_tpu.pipeline import run as rrun
from supernova_tpu_torch import cli as pcli
from supernova_tpu_torch.asm import star as pstar
from supernova_tpu_torch.pipeline import run as prun

REPO = Path(__file__).resolve().parents[1]
TIMING = ("etime_", "mem_")
# tests/test_cli.py's simulation
SIM = ["--genome-size", "6000", "--barcodes", "40", "--whitelist-size", "128", "--repeats", "1"]
FASTAS = [f"assembly.{f}.fasta.gz" for f in ("raw", "megabubbles", "pseudohap", "pseudohap2")]
PKGS = {"ref": (rcli, []), "port": (pcli, ["--device", "cpu"])}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def call(mod, argv):
    """mod.main(argv) -> (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def run_argv(sim, out):
    return ["run", "--r1", sim / "sample_R1.fastq.gz", "--r2", sim / "sample_R2.fastq.gz",
            "--whitelist", sim / "whitelist.txt", "--out", out]


def run_both(sim, root, extra=()):
    """`run` through both CLIs into root/ref and root/port -> {pkg: (rc,
    stdout, stderr)}."""
    return {pkg: call(mod, run_argv(sim, root / pkg) + list(extra) + flags)
            for pkg, (mod, flags) in PKGS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    sims = {pkg: call(mod, ["simulate", "--out", root / f"sim_{pkg}", *SIM])
            for pkg, (mod, _) in PKGS.items()}
    return root, sims, run_both(root / "sim_ref", root)


def content(path):
    """A file's content for comparison: gzip members decompressed, npz
    archives as arrays, tar bundles as member names (their timestamps and
    the host report inside differ)."""
    path = Path(path)
    if path.name.endswith(".tgz"):
        return sorted(tarfile.open(path).getnames())
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            return f.read()
    if path.suffix == ".npz":
        z = np.load(path)
        return {k: (z[k].dtype.str, z[k].tolist()) for k in z.files}
    return path.read_bytes()


def summary(out):
    return {k: v for k, v in json.loads((out / "summary.json").read_text()).items()
            if not k.startswith(TIMING)}


def pipestance(out):
    st = json.loads((out / "pipestance.json").read_text())
    return (st["host"], st["n_hosts"],
            {k: (v["status"], v["attempts"], v["chunks"]) for k, v in st["stages"].items()})


def test_simulate_matches_reference(runs):
    root, sims, _ = runs
    assert sims["ref"][0] == sims["port"][0] == 0
    assert (json.loads(sims["ref"][1].replace(str(root / "sim_ref"), "SIM"))
            == json.loads(sims["port"][1].replace(str(root / "sim_port"), "SIM")))
    names = sorted(p.name for p in (root / "sim_ref").iterdir())
    assert names == sorted(p.name for p in (root / "sim_port").iterdir()) and len(names) == 5
    for name in names:
        assert content(root / "sim_ref" / name) == content(root / "sim_port" / name), name


def test_run_matches_reference(runs):
    root, _, got = runs
    assert got["ref"][0] == got["port"][0] == 0
    for name in FASTAS:
        assert content(root / "ref" / name) == content(root / "port" / name), name
    assert summary(root / "ref") == summary(root / "port")
    assert summary(root / "port")["nreads"] > 0
    printed = {pkg: {k: v for k, v in json.loads(got[pkg][1]).items()
                     if not k.startswith(TIMING)} for pkg in got}
    assert printed["ref"] == printed["port"] == summary(root / "port")


def test_pipestance_and_bundle_match_reference(runs):
    root, _, _ = runs
    want = pipestance(root / "ref")
    assert pipestance(root / "port") == want
    assert list(want[2]) == ["count", "graph", "paths", "patch", "supergraph", "scaffold"]
    assert {s for s, _, _ in want[2].values()} == {"complete"}
    assert content(root / "port" / "port.mri.tgz") == content(root / "ref" / "ref.mri.tgz")
    assert "pipestance.json" in content(root / "port" / "port.mri.tgz")


def test_resume_on_reference_outdir(runs, tmp_path, monkeypatch):
    """--resume of both CLIs on copies of the reference's outdir, with the
    same addin: the same outputs, and attempts that add up over the
    reference's pipestance.json (the paths stage skipped on the patched
    graph).  The addin reaches each package's own constant."""
    root, _, _ = runs
    for mod in (rstar, pstar):
        monkeypatch.setattr(mod, "MIN_ADVANTAGE", mod.MIN_ADVANTAGE)
    got = {}
    for pkg, (mod, flags) in PKGS.items():
        shutil.copytree(root / "ref", tmp_path / pkg)
        got[pkg] = call(mod, ["run", "--resume", "--out", tmp_path / pkg,
                              "--addin", "asm.star.MIN_ADVANTAGE=40", *flags])
        assert got[pkg][0] == 0 and "addin: asm.star.MIN_ADVANTAGE = 40" in got[pkg][2]
    assert rstar.MIN_ADVANTAGE == pstar.MIN_ADVANTAGE == 40.0
    for name in FASTAS:
        assert content(tmp_path / "ref" / name) == content(tmp_path / "port" / name), name
    assert summary(tmp_path / "ref") == summary(tmp_path / "port")
    want = pipestance(tmp_path / "ref")
    assert pipestance(tmp_path / "port") == want
    assert {k: a for k, (_, a, _) in want[2].items()} == {
        "count": 2, "graph": 2, "paths": 1, "patch": 2, "supergraph": 2, "scaffold": 2}


def fail_first_call(real):
    calls = []

    def stage(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("injected transient failure")
        return real(self, *a, **kw)
    return stage


def test_stage_retried_once(runs, tmp_path, monkeypatch):
    """The graph stage raises on its first call: the orchestrator runs it
    again (attempts 2, the first attempt's traceback on file) and the run
    writes the same bytes as without the failure."""
    root, _, _ = runs
    for cls in (rrun.Pipeline, prun.Pipeline):
        monkeypatch.setattr(cls, "stage_graph", fail_first_call(cls.stage_graph))
    got = run_both(root / "sim_ref", tmp_path)
    for pkg in PKGS:
        assert got[pkg][0] == 0
        st = pipestance(tmp_path / pkg)[2]
        assert st["graph"] == ("complete", 2, 0) and st["count"] == ("complete", 1, 0)
        tb = (tmp_path / pkg / "_stage_graph_traceback.txt").read_text()
        assert tb.count("--- attempt") == 1 and "OSError: injected transient failure" in tb
        for name in FASTAS:
            assert content(tmp_path / pkg / name) == content(root / "ref" / name), (pkg, name)
    assert pipestance(tmp_path / "port") == pipestance(tmp_path / "ref")
    assert content(tmp_path / "port" / "port.mri.tgz") == content(tmp_path / "ref" / "ref.mri.tgz")


@pytest.mark.parametrize("exc", [RuntimeError, torch.cuda.OutOfMemoryError, MemoryError])
def test_stage_failure_exits_185(runs, tmp_path, monkeypatch, exc):
    """The count stage raises every time (an OOM that escaped the count's
    own halving retry among them): one retry, StageError, exit 185, the
    traceback of both attempts and the diagnostics bundle; no FASTA."""
    root, _, _ = runs

    def broken(self, rs):
        raise exc("injected failure")
    for cls in (rrun.Pipeline, prun.Pipeline):
        monkeypatch.setattr(cls, "_count_with_cov_guard", broken)
    got = run_both(root / "sim_ref", tmp_path)
    for pkg in PKGS:
        rc, out, err = got[pkg]
        assert rc == 185 and out == "" and "ERROR: stage count:" in err
        assert pipestance(tmp_path / pkg)[2] == {"count": ("failed", 2, 0)}
        tb = (tmp_path / pkg / "_stage_count_traceback.txt").read_text()
        assert tb.count("--- attempt") == 2 and "injected failure" in tb
        assert (tmp_path / pkg / f"{pkg}.mri.tgz").exists()
        assert not list((tmp_path / pkg).glob("*.fasta.gz"))
    assert pipestance(tmp_path / "port") == pipestance(tmp_path / "ref")
    errors = {pkg: [line for line in got[pkg][2].splitlines() if line.startswith("ERROR:")]
              for pkg in PKGS}
    assert errors["port"] == errors["ref"] == [
        f"ERROR: stage count: {exc.__name__}: injected failure"]


def test_cuda_device_without_a_card_writes_nothing(runs, tmp_path, monkeypatch):
    root, _, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (run_argv(root / "sim_ref", tmp_path / "a"),
                 run_argv(root / "sim_ref", tmp_path / "b") + ["--device", "cuda"],
                 ["--device", "cuda:0"] + run_argv(root / "sim_ref", tmp_path / "c")):
        rc, out, err = call(pcli, argv)
        assert rc == 1 and out == "" and "torch.cuda.is_available() is False" in err
    assert not list(tmp_path.rglob("*.fasta.gz")) and not list(tmp_path.rglob("pipestance.json"))


def fresh_port(code):
    """Run `code` in a new interpreter with the repo on the path -> the
    completed process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)


def test_mkoutput_refuses_a_reference_pickle(runs, tmp_path):
    """The reference's assembly_state.pkl names supernova_tpu classes: the
    port's mkoutput exits 1 before importing any of them (a fresh process:
    this one has the JAX package loaded)."""
    root, _, _ = runs
    code = f"""
import sys
from supernova_tpu_torch import cli
rc = cli.main(["mkoutput", "--dir", {str(root / "ref")!r}, "--out", {str(tmp_path)!r}])
print(rc, sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "supernova_tpu")))
"""
    res = fresh_port(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[-2] == "1 []"
    assert "written by the JAX package" in res.stderr
    assert not list(tmp_path.iterdir())


def test_sitecheck_reports_torch(runs):
    got = {pkg: call(mod, ["sitecheck"]) for pkg, (mod, _) in PKGS.items()}
    ref, port = (json.loads(got[pkg][1]) for pkg in ("ref", "port"))
    assert got["port"][0] == 0 and not any("jax" in k for k in port)
    assert port["torch_version"] == torch.__version__
    assert port["cuda_version"] == torch.version.cuda
    assert len(port["cuda_devices"]) == torch.cuda.device_count()
    assert port["nvcc_on_path"] == shutil.which("nvcc")
    for key in ("host", "platform", "python", "cpus", "mem_total", "numpy_version",
                "open_fd_limit"):
        assert port[key] == ref[key], key


def write_index_fastq(sim, path):
    """An I1 FASTQ record-parallel with the simulation's read pairs: two
    sample indexes and a rare noise index."""
    with gzip.open(sim / "sample_R1.fastq.gz", "rt") as f:
        n = sum(1 for _ in f) // 4
    with gzip.open(path, "wt") as f:
        for i in range(n):
            si = ("ACGTACGT", "TTTTCCCC")[i % 2] if i % 50 else "GGGGGGGG"
            f.write(f"@read{i}\n{si}\n+\n{'I' * len(si)}\n")


# tool -> argv(run dir, output dir, simulation dir); every tool runs on the
# reference's run dir (tarmri on a copy of it, mkoutput on each package's
# own).  graph-stats and scaf-graph read graph.npz beside the ebcx.npz of
# the patched graph, whose edges differ, and raise in both packages (an
# IndexError, a ValueError); their "-patched" cases run them on a copy of
# the run dir with the patched graph as graph.npz.
UNPATCHED = {"graph-stats": "IndexError", "scaf-graph": "ValueError"}
TOOLS = {
    "stats": lambda d, o, s: ["stats", "--graph", d / "graph.npz"],
    "graph-fasta": lambda d, o, s: ["graph-fasta", "--dir", d, "--out", o / "edges.fa.gz",
                                    "--patched"],
    "graph-stats": lambda d, o, s: ["graph-stats", "--dir", d, "--out", o / "edges.tsv"],
    "scaf-graph": lambda d, o, s: ["scaf-graph", "--dir", d, "--out", o / "scaf.csv",
                                   "--min-ctg", "100"],
    "bcmat": lambda d, o, s: ["bcmat", "--dir", d, "--out", o / "bc.mm"],
    "sam": lambda d, o, s: ["sam", "--dir", d, "--out", o / "reads.sam.gz"],
    "readqa": lambda d, o, s: ["readqa", "--dir", d, "--out", o / "qa",
                               "--whitelist", s / "whitelist.txt"],
    "evaluate": lambda d, o, s: ["evaluate", "--fasta", d / "assembly.pseudohap.fasta.gz",
                                 "--truth", s / "truth_hap_a.npy", s / "truth_hap_b.npy"],
    "diagnose": lambda d, o, s: ["diagnose", "--fasta", d / "assembly.pseudohap.fasta.gz",
                                 "--truth", s / "truth_hap_a.npy", s / "truth_hap_b.npy",
                                 "--dir", d, "--min-len", "200"],
    "readcount": lambda d, o, s: ["readcount", "--reads", d / "reads.npz"],
    "export-ref": lambda d, o, s: ["export-ref", "--dir", d, "--out-head", o / "ref" / "frag",
                                   "--graph"],
    "import-ref": lambda d, o, s: ["import-ref", "--fastb", s / "frag.fastb",
                                   "--qualp", s / "frag.qualp", "--bci", s / "frag.bci",
                                   "--out", o / "imported"],
    "demux": lambda d, o, s: ["demux", "--si", s / "I1.fastq.gz",
                              "--reads", f"R1={s / 'sample_R1.fastq.gz'}",
                              f"R2={s / 'sample_R2.fastq.gz'}", "--out", o / "demux"],
    "tarmri": lambda d, o, s: ["tarmri", "--dir", o / "run", "--ecode", "3"],
    "mkoutput": lambda d, o, s: ["mkoutput", "--dir", d, "--out", o / "mk",
                                 "--flavors", "raw,megabubbles,pseudohap,pseudohap2,efasta"],
    "mkfastq": lambda d, o, s: ["mkfastq", "--run", s],
}


@pytest.mark.parametrize("tool", sorted([*TOOLS, *(f"{t}-patched" for t in UNPATCHED)]))
def test_tool_matches_reference(runs, tmp_path, tool):
    """Both CLIs' `tool` on the same inputs: the same exit code, the same
    stdout (output paths aside) and the same files."""
    root, _, _ = runs
    sim = root / "sim_ref"
    ref_dir = root / "ref"
    if tool.endswith("-patched"):
        ref_dir = tmp_path / "patched"
        ref_dir.mkdir()
        for name in ("graph.npz", "ebcx.npz"):
            shutil.copy(root / "ref" / name.replace("graph", "graph.patched"), ref_dir / name)
    elif tool == "import-ref":
        sim = tmp_path / "exported"
        assert call(rcli, ["export-ref", "--dir", root / "ref", "--out-head", sim / "frag"])[0] == 0
    elif tool == "demux":
        sim = tmp_path / "in"
        shutil.copytree(root / "sim_ref", sim)
        write_index_fastq(sim, sim / "I1.fastq.gz")
    got = {}
    for pkg, (mod, _) in PKGS.items():
        out = tmp_path / pkg
        out.mkdir()
        if tool == "tarmri":
            shutil.copytree(root / "ref", out / "run")
        run_dir = root / pkg if tool == "mkoutput" else ref_dir
        try:
            rc, stdout, _ = call(mod, TOOLS[tool.removesuffix("-patched")](run_dir, out, sim))
        except Exception as e:  # noqa: BLE001 - the same failure in both
            rc, stdout = (type(e).__name__, str(e)), ""
        stdout = stdout.replace(str(out), "OUT").replace(str(run_dir), "RUN")
        files = {str(p.relative_to(out)): content(p) for p in sorted(out.rglob("*"))
                 if p.is_file()}
        if tool == "tarmri":  # the bundle's host report differs, and so its size
            stdout = json.loads(stdout)
            assert stdout.pop("bytes") > 0
            for name in ("_cmdline", "_sitecheck"):
                del files[f"run/{name}"]
            files["run/_filelist"] = [line for line in files["run/_filelist"].split(b"\n")
                                      if not line.endswith((b"_cmdline", b"_sitecheck"))]
        got[pkg] = (rc, stdout, files)
    assert got["port"] == got["ref"]
    rc, stdout, files = got["port"]
    failed = ("mkfastq", *UNPATCHED)
    assert rc == {"mkfastq": 1}.get(tool, 0) or rc[0] == UNPATCHED[tool]
    assert stdout or tool in failed
    assert files or tool in ("stats", "evaluate", "diagnose", "readcount", *failed)
