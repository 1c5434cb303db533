"""The port's base-graph slice end to end: supernova_tpu_torch's Pipeline
(ingest -> count -> graph -> paths) against the reference's stage
functions, called as supernova_tpu/pipeline/run.py calls them on one
device (count_readset -> trim_table -> build_graph + from_device ->
path_readset), on the 8 kb genome of the verify recipe.  Exact equality of
kmers.npz and graph.npz array by array and of ReadPaths[:n_reads].

The reference Pipeline itself is not constructed: its __init__ turns on
the persistent compile cache that tests/conftest.py keeps off."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = skill_readset()
    rt = rbuild.trim_table(rcount.count_readset(rs))
    rbg = rgraph.from_device(rbuild.build_graph(rt), rt)
    rrp = rpather.path_readset(rbg, rs)
    out = tmp_path_factory.mktemp("slice")
    kernels.reset_launch_counts()
    pl = Pipeline(out, device="cpu")
    table, bg, rp = pl.run(rs)
    return rs, (rt, rbg, rrp), (pl, table, bg, rp), out


def test_kmers_npz_matches_reference(runs):
    rs, (rt, _, _), _, out = runs
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
    _, (_, rbg, _), _, out = runs
    rbg.save(tmp_path / "ref.npz")
    zr, zp = np.load(tmp_path / "ref.npz"), np.load(out / "graph.npz")
    assert zr.files == zp.files
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k]), k


def test_read_paths_match_reference(runs):
    rs, (_, _, rrp), (_, _, _, rp), _ = runs
    p = convert.readpaths_to_numpy(rp)
    n = rs.n_reads
    for f, a, b in zip(p._fields, rrp, p):
        assert np.array_equal(np.asarray(a)[:n], b[:n]), f


def test_stats_match_reference(runs):
    rs, (rt, rbg, rrp), (pl, _, _, _), out = runs
    lens = rbg.edges.lengths()
    canonical = np.arange(rbg.n_edges) <= rbg.inv
    plen = np.asarray(rrp.path_len)[: rs.n_reads]
    expect = {
        "kmers_distinct": int(rt.n_valid),
        "n_edges": rbg.n_edges,
        "edge_N50": n50(lens[canonical]),
        "assembly_checksum": rbg.checksum(),
        "placed_perc": float((plen > 0).mean()) * 100,
        "nreads": rs.n_reads,
    }
    saved = json.loads((out / "all_stats.json").read_text())
    for k, v in expect.items():
        assert pl.stats.get(k) == v, k
        assert json.dumps(saved).count(f'"{k}"') >= 1, k
    for st in ("ingest", "count", "graph", "paths"):
        assert pl.stats.get(f"etime_{st}_h") > 0
        assert pl.stage_records[st]["wall_s"] > 0


def test_cpu_run_launches_no_kernel(runs):
    assert kernels.launch_counts() == {"kmer_extract": 0, "compact": 0, "run_reduce": 0, "sort": 0}


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(tmp_path, device="cuda")


def test_port_never_imports_jax():
    """Importing the port and running a count, single-block and blocked,
    leaves jax and every supernova_tpu module out of sys.modules (needs its
    own process: conftest imports jax and the JAX package)."""
    code = """
import sys
import numpy as np
from supernova_tpu_torch.sim import genome as sim
from supernova_tpu_torch.ingest.reads import build_readset
import supernova_tpu_torch.pipeline.run
import supernova_tpu_torch.pipeline.datasets
import supernova_tpu_torch.stats.profile_slice
import supernova_tpu_torch.convert
from supernova_tpu_torch.kmer.count import count_readset, count_readset_blocked
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
print("jax" in sys.modules, sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "supernova_tpu")))
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False []"
