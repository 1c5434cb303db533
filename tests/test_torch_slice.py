"""The port's base-graph slice end to end: supernova_tpu_torch's Pipeline
(ingest -> count -> graph -> paths) against the reference's stage
functions, called as supernova_tpu/pipeline/run.py calls them on one
device (count_readset -> trim_table -> build_graph + from_device ->
path_readset -> rescue_unplaced -> extend_paths -> paths.npz, ebcx.npz),
on the 8 kb genome of the verify recipe.  Exact equality of kmers.npz,
graph.npz, paths.npz and ebcx.npz array by array, of ReadPaths[:n_reads]
and of the stats.

The reference Pipeline itself is not constructed: its __init__ turns on
the persistent compile cache that tests/conftest.py keeps off."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from supernova_tpu.align import index as rindex
from supernova_tpu.align import pather as rpather
from supernova_tpu.align import pathzip as rpathzip
from supernova_tpu.align import rescue as rrescue
from supernova_tpu.asm import bads as rbads
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as sim
from supernova_tpu.stats import histograms as hist
from supernova_tpu.stats.logger import n50
from supernova_tpu_torch import convert
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.pipeline.run import Pipeline

REPO = Path(__file__).resolve().parents[1]


def skill_readset():
    rng = np.random.default_rng(7)
    g = sim.random_genome(rng, 8000)
    _, hb = sim.diploidize(rng, g, 0.002)
    wl = sim.make_whitelist(rng, 256)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=80, molecules_per_barcode=2,
        molecule_len=4000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    )
    return ingest_sim(reads, wl)


def reference_stage_paths(rbg, rs, outdir):
    """The reference's stage_paths (supernova_tpu/pipeline/run.py:578-626)
    on one device, step for step: pather, rescue, extend, paths.npz,
    placed_perc, ebcx.npz -> (ReadPaths, {stat: value} in logging order)."""
    import jax.numpy as jnp

    rp = rpather.path_readset(rbg, rs)
    n = rs.n_reads
    edges, plen, offset = (np.asarray(x)[:n] for x in rp[:3])
    edges, plen, offset, n_resc = rrescue.rescue_unplaced(rbg, rs, edges, plen, offset)
    stats = {}
    if n_resc:
        stats["paths_rescued"] = n_resc
    edges, plen, offset, n_ext = rbads.extend_paths(rbg, rs, edges, plen, offset)
    if n_ext or n_resc:
        rp = rp._replace(edges=jnp.asarray(edges), path_len=jnp.asarray(plen),
                         offset=jnp.asarray(offset))
        stats["paths_extended"] = n_ext
    rpathzip.save_zipped(outdir / "paths.npz", rbg, edges, plen, offset,
                         extra={"n_edges": np.int64(rbg.n_edges)})
    stats["placed_perc"] = float((plen > 0).mean()) * 100 if n else 0.0
    ebcx = rindex.edge_barcodes(edges, plen, rs.bc, rbg.n_edges)
    np.savez_compressed(outdir / "ebcx.npz", values=ebcx.values, offsets=ebcx.offsets,
                        counts=rindex.edge_read_counts(edges, plen, rbg.n_edges))
    return rp, stats


def assert_npz_equal(want, got):
    """Two .npz files hold the same arrays, names, dtypes and values."""
    zw, zg = np.load(want), np.load(got)
    assert sorted(zw.files) == sorted(zg.files)
    for k in zw.files:
        assert zw[k].dtype == zg[k].dtype and np.array_equal(zw[k], zg[k]), (got, k)


def assert_stage_paths_match(pl, out, rp, rrp, rstats, ref_out, n):
    """The port's stage_paths output (ReadPaths, paths.npz, ebcx.npz, stats
    in the reference's order) equals reference_stage_paths'."""
    p = convert.readpaths_to_numpy(rp)
    for f, a, b in zip(p._fields, rrp, p):
        assert np.array_equal(np.asarray(a)[:n], b[:n]), f
    for name in ("paths.npz", "ebcx.npz"):
        assert_npz_equal(ref_out / name, out / name)
    for k, v in rstats.items():
        assert pl.stats.get(k) == v, k
    names = [k for k in json.loads((out / "all_stats.json").read_text())
             if k in ("paths_rescued", "paths_extended", "placed_perc")]
    assert names == list(rstats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = skill_readset()
    rt = rbuild.trim_table(rcount.count_readset(rs))
    rbg = rgraph.from_device(rbuild.build_graph(rt), rt)
    ref_out = tmp_path_factory.mktemp("ref")
    rrp, rstats = reference_stage_paths(rbg, rs, ref_out)
    out = tmp_path_factory.mktemp("slice")
    kernels.reset_launch_counts()
    pl = Pipeline(out, device="cpu")
    table, bg, rp = pl.run_slice(rs)
    return rs, (rt, rbg, rrp, rstats, ref_out), (pl, table, bg, rp), out


def test_kmers_npz_matches_reference(runs):
    rs, (rt, *_), _, out = runs
    z = np.load(out / "kmers.npz")
    ref = dict(
        words=np.stack([np.asarray(w) for w in rt.words], axis=-1),
        count=np.asarray(rt.count), nbc=np.asarray(rt.nbc),
        left_mask=np.asarray(rt.left_mask), right_mask=np.asarray(rt.right_mask),
        n_valid=np.int64(int(rt.n_valid)),
    )
    assert sorted(z.files) == sorted(ref)
    for k, a in ref.items():
        assert z[k].dtype == a.dtype and np.array_equal(z[k], a), k
    spec = hist.kmer_spectrum(rt)
    got = json.loads((out / "stats" / "histogram_kmer_count.json").read_text())
    assert got["counts"] == list(map(int, spec["counts"]))
    assert got["bins"] == list(map(int, spec["bins"]))


def test_graph_npz_matches_reference(runs, tmp_path):
    _, (_, rbg, *_), _, out = runs
    rbg.save(tmp_path / "ref.npz")
    zr, zp = np.load(tmp_path / "ref.npz"), np.load(out / "graph.npz")
    assert zr.files == zp.files
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k]), k


def test_read_paths_match_reference(runs):
    """ReadPaths after rescue and extend, paths.npz and ebcx.npz."""
    rs, (_, _, rrp, rstats, ref_out), (pl, _, _, rp), out = runs
    assert_stage_paths_match(pl, out, rp, rrp, rstats, ref_out, rs.n_reads)
    assert rstats.get("paths_extended", 0) > 0


def test_stats_match_reference(runs):
    rs, (rt, rbg, _, rstats, _), (pl, _, _, _), out = runs
    lens = rbg.edges.lengths()
    canonical = np.arange(rbg.n_edges) <= rbg.inv
    expect = {
        "kmers_distinct": int(rt.n_valid),
        "n_edges": rbg.n_edges,
        "edge_N50": n50(lens[canonical]),
        "assembly_checksum": rbg.checksum(),
        "nreads": rs.n_reads,
        **rstats,
    }
    saved = json.loads((out / "all_stats.json").read_text())
    for k, v in expect.items():
        assert pl.stats.get(k) == v, k
        assert json.dumps(saved).count(f'"{k}"') >= 1, k
    for st in ("ingest", "count", "graph", "paths"):
        assert pl.stats.get(f"etime_{st}_h") > 0
        assert pl.stage_records[st]["wall_s"] > 0
    assert pl.stage_records["paths"]["rescue_s"] >= 0 and pl.stage_records["paths"]["extend_s"] > 0


def test_cpu_run_launches_no_kernel(runs):
    assert kernels.launch_counts() == {"kmer_extract": 0, "compact": 0, "run_reduce": 0, "sort": 0,
                                       "scan_max": 0}


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(tmp_path, device="cuda")


def test_port_never_imports_jax():
    """Importing the port, running a count, single-block and blocked, and
    then 10x FASTQs through preflight, ingest, Pipeline.run, stage_patch
    and stage_supergraph, the closure glue on the device route, run_full
    (scaffold phases, phasing, the het DP, every FASTA flavor), a mesh
    count and a mesh path on CPU shards, bc_link_triples, a 2-shard
    sharded_vote_matrix, an FM-index, and the command line's simulate
    and `run --device cpu` leaves jax and every
    supernova_tpu module out of sys.modules (needs its own process: conftest
    imports jax and the JAX package); nor does `python -m
    supernova_tpu_torch --help` import one (-X importtime lists every
    import)."""
    code = """
import contextlib
import io
import sys
import tempfile
import numpy as np
from supernova_tpu_torch.sim import genome as sim
from supernova_tpu_torch.ingest.reads import build_readset
import supernova_tpu_torch.asm.stackster
import supernova_tpu_torch.asm.nucleate as nucleate
import supernova_tpu_torch.asm.supergraph
import supernova_tpu_torch.parallel.device_nucleate
import supernova_tpu_torch.ingest.discovery
import supernova_tpu_torch.pipeline.run
import supernova_tpu_torch.pipeline.datasets
import supernova_tpu_torch.stats.profile_slice
import supernova_tpu_torch.stats.profile_supergraph
import supernova_tpu_torch.convert
from supernova_tpu_torch.ingest.barcodes import Whitelist
from supernova_tpu_torch.ingest.tenx import ingest_10x_fastqs, write_sim_fastqs
from supernova_tpu_torch.kmer.count import count_readset, count_readset_blocked
from supernova_tpu_torch.native import load_native
from supernova_tpu_torch.pipeline.preflight import preflight
from supernova_tpu_torch.pipeline.run import Pipeline
rng = np.random.default_rng(0)
g = sim.random_genome(rng, 700)
reads = [g[s:s + 150].copy() for s in range(0, 480, 30)]
quals = [np.full(150, 37, np.uint8) for _ in reads]
rs = build_readset(reads, quals, np.zeros(len(reads) // 2, np.int32), n_barcodes=0, barcoded=False)
t = count_readset(rs, "cpu", min_freq=1)
assert int(t.n_valid) > 0
info = {}
tb = count_readset_blocked(rs, "cpu", min_freq=1, max_positions=600, info=info)
assert int(tb.n_valid) == int(t.n_valid) and info["blocks"] >= 3
g = sim.random_genome(rng, 5000, n_repeat_chunks=1, repeat_len=200)
_, hb = sim.diploidize(rng, g, het_rate=0.0005)
wlc = sim.make_whitelist(rng, 128)
reads = sim.simulate_linked_reads(rng, (g, hb), wlc, n_barcodes=40, molecules_per_barcode=3,
                                  molecule_len=2500, coverage_per_molecule=2.0)
with tempfile.TemporaryDirectory() as d:
    r1, r2 = write_sim_fastqs(reads, d + "/fq")
    assert preflight([str(r1)], [str(r2)], len(wlc)).ok and load_native() is not None
    rs = ingest_10x_fastqs([r1], [r2], Whitelist.from_codes(wlc))
    bg, fasta = Pipeline(d + "/asm", device="cpu").run(rs)
    pl = Pipeline(d + "/asm", device="cpu", resume=True)
    bg, rp = pl.stage_patch(bg, pl.stage_paths(bg, rs), rs)
    assert fasta.exists() and pl.stats.get("gap_pairs") is not None
    D, lines, dup = pl.stage_supergraph(bg, rp, rs)
    assert pl.stats.get("supergraph_mode") == "closures" and lines.n_lines > 0
    info = {}
    nucleate.nucleate_graph(bg, pl._closures, None, device_glue=True, device="cpu", info=info)
    assert info["glue_route"] == "device"
    D, lines, scaffolds, phasings, outs = Pipeline(d + "/full", device="cpu").run_full(rs)
    assert set(outs) == {"raw", "megabubbles", "pseudohap", "pseudohap2"}
    assert all(p.exists() for p in outs.values()) and scaffolds and phasings
    from supernova_tpu_torch.parallel import mesh as pmesh, sharded_count as psc
    from supernova_tpu_torch.parallel import sharded_path as psp
    m = pmesh.make_mesh2(2, 2, device="cpu")
    inputs, nbl = psc.split_readset(rs, m)
    tables, ovf = psc.sharded_count_hier(m, inputs, capacity=4 * nbl)
    assert sum(ovf) == 0 and sum(int(t.n_valid) for t in tables) > 0
    m = pmesh.make_mesh(4, "cpu")
    inputs, blocks = psp.split_for_pathing(rs, m)
    da = bg.device_arrays("cpu")
    rp4 = psp.gather_paths(psp.sharded_path(m, da["words"], da["node_edge"], da["node_pos"],
                                            da["from_v"], da["to_v"], da["edge_kmers"], inputs),
                           blocks)
    assert rp4.path_len.shape[0] == rs.n_reads and int((rp4.path_len > 0).sum()) > 0
    from supernova_tpu_torch.align import fmindex
    from supernova_tpu_torch.parallel import sharded_phase, sharded_scaffold
    i1, i2, sh, nv = sharded_scaffold.bc_link_triples(np.array([1, 1, 2, 2]), np.array([0, 1, 0, 1]),
                                                      device="cpu")
    assert (i1.tolist(), i2.tolist(), sh.tolist()) == ([0], [1], [2])
    S = sharded_phase.sharded_vote_matrix(pmesh.make_mesh(2, "cpu"), np.array([0, 0]),
                                          np.array([1, -1]), *sharded_phase.split_votes(
                                              np.array([0, 1, 0]), np.array([0, 0, 1]), 2), 1, 2)
    assert S.tolist() == [[0, 1]]
    fm = fmindex.FMIndex.from_edges([np.array([0, 1, 2, 0, 1], np.uint8)], device="cpu")
    assert fm.count(np.array([0, 1], np.uint8)) == 2
    from supernova_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["simulate", "--out", d + "/sim", "--genome-size", "6000", "--barcodes",
                         "40", "--whitelist-size", "128", "--repeats", "1"]) == 0
        assert cli.main(["run", "--r1", d + "/sim/sample_R1.fastq.gz", "--r2",
                         d + "/sim/sample_R2.fastq.gz", "--whitelist", d + "/sim/whitelist.txt",
                         "--out", d + "/cli", "--device", "cpu"]) == 0
print("jax" in sys.modules, sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "supernova_tpu")))
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False []"
    res = subprocess.run([sys.executable, "-X", "importtime", "-m", "supernova_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0 and "usage: supernova_tpu_torch" in res.stdout, res.stderr
    imported = [line.split("|")[-1].strip() for line in res.stderr.splitlines()
                if line.startswith("import time:")]
    assert "supernova_tpu_torch.cli" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "supernova_tpu")]
