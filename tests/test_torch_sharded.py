"""The port's multi-shard layer against the reference's, on the CPU: the
same numpy inputs as tests/test_sharded_{count,build,path,nucleate}.py go
through the JAX package's sharded functions on its 8-virtual-device mesh
and through supernova_tpu_torch.parallel on a mesh of CPU shards.  Every
output is integer, and every comparison is exact: the per-shard count
tables (flat and hierarchical), the merged table, the BaseGraph of the
sharded build, ReadPaths of the replicated and the value-sharded pather,
the glue's partition, and a Pipeline(multi_device=(1, 4)) run against the
single-device run (outputs and summary.json)."""
import gzip
import json
import shutil

import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
from supernova_tpu.core.kmer_codec import soa_to_np
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as rcount
from supernova_tpu.parallel import mesh as rmesh
from supernova_tpu.parallel import sharded_count as rsc
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.core import kmer_codec as pkc
from supernova_tpu_torch.dbg import build as pbuild
from supernova_tpu_torch.dbg import graph as pgraph
from supernova_tpu_torch.ingest import reads as preads
from supernova_tpu_torch.kmer import count as pcount
from supernova_tpu_torch.parallel import mesh as pmesh
from supernova_tpu_torch.parallel import sharded_build as psb
from supernova_tpu_torch.parallel import sharded_count as psc
from supernova_tpu_torch.parallel import sharded_path as psp
from supernova_tpu_torch.pipeline import run as prun

from tests.test_dbg import perfect_readset

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def count_readset(rng, size=4000, repeat_len=200, molecule_len=2000):
    """tests/test_sharded_count.py's readset."""
    g = sim.random_genome(rng, size, n_repeat_chunks=2, repeat_len=repeat_len)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 64)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=16, molecules_per_barcode=2,
        molecule_len=molecule_len, coverage_per_molecule=1.5, error_rate=0.002,
    )
    return ingest_sim(reads, wl)


def port_readset(rs):
    return preads.ReadSet(codes=rs.codes, offsets=rs.offsets, quals=rs.quals, bc=rs.bc,
                          bci=rs.bci, barcoded=rs.barcoded)


def shard_rows(tables_stacked, n_dev):
    """The reference's stacked shard tables -> per shard (words, count, nbc,
    left_mask, right_mask) over its valid rows."""
    nv = np.asarray(tables_stacked.n_valid)
    cap = np.asarray(tables_stacked.count).shape[0] // n_dev
    w = soa_to_np(tables_stacked.words).reshape(n_dev, cap, 3)
    cols = [np.asarray(getattr(tables_stacked, f)).reshape(n_dev, cap)
            for f in ("count", "nbc", "left_mask", "right_mask")]
    return [(w[s, : nv[s]], *(c[s, : nv[s]] for c in cols)) for s in range(n_dev)]


def port_shard_rows(tables):
    out = []
    for t in tables:
        h = convert.table_to_numpy(t)
        n = h.n_valid
        out.append((np.stack(h.words, -1)[:n], h.count[:n], h.nbc[:n],
                    h.left_mask[:n], h.right_mask[:n]))
    return out


def assert_shards_equal(got, want):
    assert len(got) == len(want) and sum(len(g[0]) for g in got) > 0
    for s, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            assert np.array_equal(a, np.asarray(b).astype(a.dtype)), f"shard {s} leaf {j}"


def test_kmer_shard_hash_matches_reference(rng):
    words = rng.integers(0, 1 << 32, size=(4096, 3), dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0, 0], [0xFFFFFFFF] * 3, [1, 2, 3], [0x80000000, 0x7FFFFFFF, 5]
    import jax.numpy as jnp

    want = np.asarray(rsc.kmer_shard_hash(rcount.kc.W3(*(jnp.asarray(words[:, j])
                                                         for j in range(3)))))
    got = psc.kmer_shard_hash(pkc.np_to_soa(words, "cpu")).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("sizes", [[3, 0, 5], [0, 0, 0], [7, 1, 0]])
def test_exchange_moves_uneven_rows_and_gives_back(sizes):
    """mesh.exchange: rows land on their key's shard in sender order, the
    capacity cut counts its drops, and give_back restores each sender's
    order (rows that stayed home read the fill)."""
    mesh = pmesh.make_mesh(3, "cpu")
    g = torch.Generator().manual_seed(sum(sizes))
    cols = [torch.randint(0, 1000, (n, 2), generator=g) for n in sizes]
    keys = [torch.randint(0, 4, (n,), generator=g) for n in sizes]  # 3 = stays home
    recv, ctx, dropped = mesh.exchange(cols, keys, 3)
    for d in range(3):
        want = torch.cat([c[k == d] for c, k in zip(cols, keys)])
        assert torch.equal(recv[d], want) and dropped[d] == 0
    back = mesh.give_back([r * 10 for r in recv], ctx, -1)
    for c, k, b in zip(cols, keys, back):
        assert torch.equal(b, torch.where((k < 3)[:, None], c * 10, -1))
    cut, _, dropped = mesh.exchange(cols, keys, 3, capacity=1)
    for d in range(3):
        assert cut[d].shape[0] == min(recv[d].shape[0], 1)
        assert dropped[d] == max(recv[d].shape[0] - 1, 0)


def test_sharded_count_matches_reference(rng):
    rs = count_readset(rng)
    codes, pr, glp, bcp, nbl, rl, url = rsc.split_readset(rs, N_DEV, base_bucket=4096,
                                                          read_bucket=128)
    want, ovf = rsc.sharded_count(rmesh.make_mesh(N_DEV), codes, pr, glp, bcp, n_dev=N_DEV,
                                  capacity=4 * nbl, uniform_rl=url)
    assert int(np.asarray(ovf).sum()) == 0

    mesh = pmesh.make_mesh(N_DEV, "cpu")
    inputs, pnbl = psc.split_readset(port_readset(rs), mesh)
    tables, povf = psc.sharded_count(mesh, inputs, capacity=4 * pnbl)
    assert sum(povf) == 0
    assert_shards_equal(port_shard_rows(tables), shard_rows(want, N_DEV))

    merged = convert.table_to_numpy(psc.merge_shard_tables(tables, "cpu"))
    rmerged = rsc.merge_shard_tables(want)
    n = merged.n_valid
    assert n == int(rmerged.n_valid) and len(merged.count) == len(np.asarray(rmerged.count))
    assert np.array_equal(np.stack(merged.words, -1), soa_to_np(rmerged.words))
    for f in ("count", "nbc", "left_mask", "right_mask"):
        assert np.array_equal(getattr(merged, f), np.asarray(getattr(rmerged, f))), f


@pytest.mark.parametrize("hc", [(4, 2), (2, 4)])
def test_hier_sharded_count_matches_reference(rng, hc):
    rs = count_readset(rng, 3000, repeat_len=150, molecule_len=1500)
    codes, pr, glp, bcp, nbl, rl, url = rsc.split_readset(rs, N_DEV, base_bucket=4096,
                                                          read_bucket=128)
    want, ovf = rsc.sharded_count_hier(rmesh.make_mesh2(*hc), codes, pr, glp, bcp,
                                       n_hosts=hc[0], chips_per_host=hc[1],
                                       capacity=4 * nbl, uniform_rl=url)
    assert int(np.asarray(ovf).sum()) == 0

    mesh = pmesh.make_mesh2(*hc, device="cpu")
    inputs, pnbl = psc.split_readset(port_readset(rs), mesh)
    tables, povf = psc.sharded_count_hier(mesh, inputs, capacity=4 * pnbl)
    assert sum(povf) == 0
    assert_shards_equal(port_shard_rows(tables), shard_rows(want, N_DEV))


def test_sharded_build_matches_single(rng):
    """Every BaseGraph array of the sharded build equals the single-device
    build's (the table at trim_table's row count), and its checksum the
    reference's single-device build's."""
    rs = count_readset(rng)
    prs = port_readset(rs)
    table = pcount.count_readset(prs, "cpu")
    single = pgraph.from_device(pbuild.build_graph(pbuild.trim_table(table)),
                                pbuild.trim_table(table))
    mesh = pmesh.make_mesh(N_DEV, "cpu")
    inputs, nbl = psc.split_readset(prs, mesh)
    tables, ovf = psc.sharded_count(mesh, inputs, capacity=4 * nbl)
    assert sum(ovf) == 0
    bg = psb.sharded_build_graph(mesh, tables)
    bg.validate()
    for f in ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos"):
        a, b = getattr(bg, f), getattr(single, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(bg.edges.values, single.edges.values)
    assert np.array_equal(bg.edges.offsets, single.edges.offsets)
    assert (bg.n_vertices, bg.n_kmers) == (single.n_vertices, single.n_kmers)

    rtable = rbuild.trim_table(rcount.count_readset(rs), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(rtable), rtable)
    assert bg.checksum() == rbg.checksum() and bg.n_edges == rbg.n_edges


@pytest.fixture(scope="module")
def path_case():
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 4000, n_repeat_chunks=2, repeat_len=150)
    rs = perfect_readset(g)
    table = rbuild.trim_table(rcount.count_readset(rs, min_freq=2), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    want = rpather.path_readset(rbg, rs)
    prs = port_readset(rs)
    ptable = pcount.count_readset(prs, "cpu", min_freq=2)
    bg = pgraph.from_device(pbuild.build_graph(ptable), ptable)
    return prs, bg, want


def assert_paths(got, want, n):
    for f in ("edges", "path_len", "offset", "first_skip"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))[:n]), f


@pytest.mark.parametrize("n_dev", [4, N_DEV])
def test_sharded_path_matches_reference(path_case, n_dev):
    rs, bg, want = path_case
    mesh = pmesh.make_mesh(n_dev, "cpu")
    da = bg.device_arrays("cpu")
    inputs, blocks = psp.split_for_pathing(rs, mesh)
    parts = psp.sharded_path(mesh, da["words"], da["node_edge"], da["node_pos"], da["from_v"],
                             da["to_v"], da["edge_kmers"], inputs)
    assert_paths(psp.gather_paths(parts, blocks), want, rs.n_reads)


def test_value_sharded_path_matches_reference(path_case):
    """The value-sharded pather against the reference's sharded_path_vs on
    its 8-device mesh and path_readset; every shard's dictionary rows equal
    the reference's shard_dictionary's, and no shard holds all of it."""
    import jax.numpy as jnp

    from supernova_tpu.core.kmer_codec import K, np_to_soa
    from supernova_tpu.parallel import sharded_path as rsp

    rs, bg, want = path_case
    rwords, rne, rnp, rL = rsp.shard_dictionary(np_to_soa(bg.kmer_words), bg.node_edge,
                                                bg.node_pos, N_DEV)
    codes, off, pr, rlen, rnbl, rrl, idx_blocks = rsp.split_for_pathing(rs, N_DEV)
    ref = rsp.sharded_path_vs(
        rmesh.make_mesh(N_DEV), rwords, jnp.asarray(rne), jnp.asarray(rnp),
        jnp.asarray(bg.from_v.astype(np.int32)), jnp.asarray(bg.to_v.astype(np.int32)),
        jnp.asarray((bg.edges.lengths() - (K - 1)).astype(np.int32)), jnp.asarray(codes),
        jnp.asarray(off), jnp.asarray(pr), jnp.asarray(rlen), n_dev=N_DEV, shard_rows=rL,
        capacity=2 * rnbl)
    ref = type(ref)(*(np.concatenate([np.asarray(x).reshape((N_DEV, rrl) + x.shape[1:])[d][
        : len(idx_blocks[d])] for d in range(N_DEV)]) for x in ref))

    mesh = pmesh.make_mesh(N_DEV, "cpu")
    da = bg.device_arrays("cpu")
    shards = psp.shard_dictionary(mesh, da["words"], da["node_edge"], da["node_pos"])
    rw = np.stack([np.asarray(w).reshape(N_DEV, rL) for w in rwords], -1)
    for s, (w, ne, npo) in enumerate(shards):
        k = w.a.shape[0] - 1  # one sentinel row after the shard's rows
        assert np.array_equal(np.stack([x[:k].numpy() for x in w], -1), rw[s, :k])
        assert np.array_equal(ne[: 2 * k].numpy(), np.asarray(rne).reshape(N_DEV, -1)[s, : 2 * k])
        assert np.array_equal(npo[: 2 * k].numpy(), np.asarray(rnp).reshape(N_DEV, -1)[s, : 2 * k])
    per_shard = [int(w.a.shape[0]) - 1 for w, _, _ in shards]
    assert sum(per_shard) == int(bg.n_kmers) and max(per_shard) < int(bg.n_kmers)
    inputs, blocks = psp.split_for_pathing(rs, mesh)
    nbl = max(int(i["pos_read"].shape[0]) for i in inputs)
    got = psp.gather_paths(psp.sharded_path_vs(mesh, shards, da["from_v"], da["to_v"],
                                               da["edge_kmers"], inputs, capacity=2 * nbl), blocks)
    assert_paths(got, ref, rs.n_reads)
    assert_paths(got, want, rs.n_reads)


def partition(labels):
    """Canonical form of a partition: each class as the tuple of its members."""
    from collections import defaultdict

    d = defaultdict(list)
    for i, lab in enumerate(labels):
        d[int(lab)].append(i)
    return sorted(tuple(v) for v in d.values())


@pytest.mark.parametrize("value_shard", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_sharded_glue_matches_reference(value_shard, adaptive):
    """Seed 2 of tests/test_sharded_nucleate.py: the port's mesh glue on 8
    CPU shards gives the reference device glue's partition, zero overflow."""
    from supernova_tpu.asm.nucleate import MIN_OVER_BASES, sanitize_closures
    from supernova_tpu.parallel.device_nucleate import glue_closures_device
    from supernova_tpu_torch.parallel import sharded_nucleate as psn

    from tests.test_nucleate_property import _graph, _random_walks

    rng = np.random.default_rng(2)
    g, bg = _graph(rng, 4000, repeats=2, rep_len=150)
    cls = sanitize_closures(bg, _random_walks(rng, bg, 40))
    over = MIN_OVER_BASES if adaptive else 100
    want = glue_closures_device(bg, cls, over, adaptive=adaptive)
    assert want is not None
    pbg = pgraph.BaseGraph.load(_saved(bg))
    got, ovf = psn.glue_closures_sharded(pmesh.make_mesh(N_DEV, "cpu"), pbg, cls, over,
                                         adaptive=adaptive, value_shard=value_shard)
    assert ovf == 0
    assert partition(got) == partition(want) and len(set(got.tolist())) < len(got)


def _saved(bg):
    """The reference's BaseGraph written to a temporary graph.npz (the port
    reads the reference's files)."""
    import tempfile

    path = tempfile.mkdtemp() + "/graph.npz"
    bg.save(path)
    return path


# ------------------------------------------------------------- the Pipeline

MESH_STATS = {"n_shards", "n_shards_path", "path_dict_sharded"}
TIMING = ("etime_", "mem_")


def stats_of(out, drop=()):
    return {k: v for k, v in json.loads((out / "all_stats.json").read_text()).items()
            if not k.startswith(TIMING) and k not in drop}


def fasta_bytes(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def e2e_rs():
    from tests.test_torch_run import e2e_reads

    return ingest_sim(*e2e_reads(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def mesh_runs(e2e_rs, tmp_path_factory):
    """The e2e genome through run(), stage_patch and stage_supergraph on one
    CPU device and on a (1, 4) mesh of CPU shards."""
    runs = {}
    for tag, md in (("single", False), ("mesh", (1, 4))):
        out = tmp_path_factory.mktemp(tag)
        pl = prun.Pipeline(out, device="cpu", multi_device=md)
        bg, fa = pl.run(e2e_rs)
        shutil.copy(out / "paths.npz", out / "paths.base.npz")  # before the re-path
        bg, rp = pl.stage_patch(bg, pl.stage_paths(bg, e2e_rs), e2e_rs)
        D, lines, _ = pl._stage("supergraph", pl.stage_supergraph, bg, rp, e2e_rs)
        runs[tag] = (out, pl, fa, D)
    return runs


def test_multi_device_run_matches_single(mesh_runs):
    """Pipeline(multi_device=(1, 4)): the same FASTA, npz files and
    summary.json as the single-device run; the count, build and pather took
    the mesh (n_shards and n_shards_path 4), with no overflow recount."""
    from tests.test_torch_slice import assert_npz_equal

    (out1, pl1, fa1, _), (out4, pl4, fa4, _) = mesh_runs["single"], mesh_runs["mesh"]
    assert fasta_bytes(fa4) == fasta_bytes(fa1) and fasta_bytes(fa1).count(b">") > 1
    for name in ("kmers.npz", "graph.npz", "paths.npz", "ebcx.npz", "graph.patched.npz",
                 "supergraph.npz", "dpaths.npz", "cpaths.npz"):
        assert_npz_equal(out1 / name, out4 / name)
    s1 = json.loads((out1 / "summary.json").read_text())
    s4 = json.loads((out4 / "summary.json").read_text())
    assert {k: v for k, v in s4.items() if not k.startswith(TIMING)} == {
        k: v for k, v in s1.items() if not k.startswith(TIMING)}
    st1, st4 = stats_of(out1, {"glue_route"}), stats_of(out4, {"glue_route"})
    assert {k: st4[k] for k in st1} == st1 and set(st4) - set(st1) == MESH_STATS
    assert (pl4.stats.get("n_shards"), pl4.stats.get("n_shards_path"),
            pl4.stats.get("path_dict_sharded")) == (4, 4, 0)
    rec = pl4.stage_records["count"]
    assert rec["count_route"] == "mesh" and rec["count_overflow"] == 0 and rec["n_shards"] == 4
    assert "count_route" not in pl1.stage_records["count"]


def test_multi_device_supergraph_glues_on_the_mesh(mesh_runs):
    """stage_supergraph on the mesh takes the mesh glue: the single-device
    run's D (supergraph.npz above), route "mesh" in the record and stats."""
    from tests.test_torch_supergraph import _d_tuple

    (_, pl1, _, D1), (_, pl4, _, D4) = mesh_runs["single"], mesh_runs["mesh"]
    assert _d_tuple(D4) == _d_tuple(D1)
    assert pl4.stage_records["supergraph"]["glue_route"] == pl4.stats.get("glue_route") == "mesh"
    assert pl1.stage_records["supergraph"]["glue_route"] == "host"


@pytest.mark.parametrize("topology", ["1x4", "2x2"])
def test_value_sharded_dictionary_and_topology(e2e_rs, mesh_runs, tmp_path, monkeypatch, topology):
    """SUPERNOVA_TPU_TOPOLOGY picks the mesh (2x2: the hierarchical count),
    and PATH_VS_DICT_ROWS forced to 0 hash-shards the pather's dictionary:
    the same kmers.npz, graph.npz and paths.npz."""
    from tests.test_torch_slice import assert_npz_equal

    out1 = mesh_runs["single"][0]
    monkeypatch.setenv("SUPERNOVA_TPU_TOPOLOGY", topology)
    monkeypatch.setattr(prun, "PATH_VS_DICT_ROWS", 0)
    pl = prun.Pipeline(tmp_path, device="cpu")
    assert pl.multi_device == tuple(int(x) for x in topology.split("x"))
    pl.run_slice(e2e_rs)
    for name in ("kmers.npz", "graph.npz"):
        assert_npz_equal(out1 / name, tmp_path / name)
    assert_npz_equal(out1 / "paths.base.npz", tmp_path / "paths.npz")
    assert (pl.stats.get("n_shards"), pl.stats.get("path_dict_sharded")) == (4, 1)


def test_count_overflow_recounts_on_one_device(e2e_rs, mesh_runs, tmp_path, monkeypatch):
    """A capacity too small for the shards' rows: the reference's
    single-device recount runs, gives the same table, and the count
    stage's record says so; the graph is the single-device build's."""
    from tests.test_torch_slice import assert_npz_equal

    calls = []
    real = psc.sharded_count

    def small(mesh, inputs, capacity, **kw):
        calls.append(capacity)
        return real(mesh, inputs, 64, **kw)

    monkeypatch.setattr(psc, "sharded_count", small)
    monkeypatch.setattr(psb, "sharded_build_graph",
                        lambda *a, **kw: pytest.fail("the sharded build ran after an overflow"))
    pl = prun.Pipeline(tmp_path, device="cpu", multi_device=True)
    pl.run_slice(e2e_rs)
    rec = pl.stage_records["count"]
    assert calls and rec["count_route"] == "mesh_overflow" and rec["count_overflow"] > 0
    assert pl.stats.get("n_shards") is None
    for name in ("kmers.npz", "graph.npz"):
        assert_npz_equal(mesh_runs["single"][0] / name, tmp_path / name)


def test_dist_helpers_in_one_process():
    """to_global splits rows over the shards (or replicates them),
    from_global / host_fetch concatenate the shards back, ensure_global
    passes a sharded value through, local_rows names each shard."""
    from supernova_tpu_torch.parallel import dist

    mesh = pmesh.make_mesh2(2, 2, device="cpu")
    arr = np.arange(12)
    x = dist.to_global(mesh, (pmesh.HOST_AXIS, pmesh.CHIP_AXIS), arr)
    assert [p.tolist() for p in x] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert dist.ensure_global(mesh, pmesh.AXIS, x) is x
    assert np.array_equal(dist.from_global(x), arr) and np.array_equal(dist.host_fetch(x), arr)
    rep = dist.to_global(mesh, None, arr)
    assert all(np.array_equal(p.numpy(), arr) for p in rep)
    rows, idx = dist.local_rows(x)
    assert idx == [0, 1, 2, 3] and np.array_equal(np.concatenate(rows), arr)
    assert not dist.init_from_env("cpu")  # no SUPERNOVA_NUM_PROCESSES: one process
