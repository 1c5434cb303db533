"""Port parity: supernova_tpu_torch.dbg (build + graph) against the JAX
reference on the CPU, exact equality.  Each graph starts from the
REFERENCE's KmerTable carried across by supernova_tpu_torch.convert, so the
build is checked in isolation from the count."""
import numpy as np
import pytest
import torch

from supernova_tpu.core.kmer_codec import K
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.dbg import build as dbuild
from supernova_tpu_torch.dbg import graph as dgraph

from tests.test_dbg import perfect_readset

GRAPH_ARRAYS = ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos")


def genome(kind):
    rng = np.random.default_rng({"repeat": 3, "circle": 4, "clean": 5}[kind])
    if kind == "repeat":
        return sim.random_genome(rng, 4000, n_repeat_chunks=3, repeat_len=300)
    if kind == "circle":  # reads wrap around a circular genome
        g = sim.random_genome(rng, 600)
        return np.concatenate([g, g[: K - 1 + 150]])
    return sim.random_genome(rng, 1200)


@pytest.fixture(scope="module", params=["repeat", "circle", "clean"])
def case(request):
    rs = perfect_readset(genome(request.param))
    table = rbuild.trim_table(rcount.count_readset(rs, min_freq=2), pad_multiple=256)
    return request.param, table


def assert_graphs_equal(ref, port):
    assert ref.n_edges == port.n_edges
    assert ref.n_vertices == port.n_vertices
    assert ref.n_kmers == port.n_kmers
    for f in GRAPH_ARRAYS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(ref.edges.values, port.edges.values)
    assert np.array_equal(ref.edges.offsets, port.edges.offsets)
    assert ref.edges.values.dtype == port.edges.values.dtype


def test_build_graph_matches_reference(case):
    kind, table = case
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    pt = convert.table_from_numpy(table, "cpu")
    pbg = dgraph.from_device(dbuild.build_graph(pt), pt)
    assert_graphs_equal(rbg, pbg)
    assert rbg.checksum() == pbg.checksum()
    if kind == "circle":
        assert pbg.is_circle.any()
    else:
        pbg.validate()
    if kind == "repeat":
        assert pbg.n_edges > 2


def test_links_match_reference(case):
    _, table = case
    rl = rbuild.build_links(table)
    pl = dbuild.build_links(convert.table_from_numpy(table, "cpu"))
    for f in ("next", "prev", "head", "dist"):
        assert np.array_equal(np.asarray(getattr(rl, f)), getattr(pl, f).numpy()), f
    assert np.array_equal(
        np.asarray(rbuild._indeg8(table)), dbuild._indeg8(convert.table_from_numpy(table, "cpu")).numpy()
    )


@pytest.mark.parametrize("chunk", [257, 500])
def test_links_chunked_match_unchunked_and_reference(case, chunk):
    """The successor resolve in chunks of oriented nodes (several chunks,
    the last one short) gives the one-join links and the reference's."""
    _, table = case
    pt = convert.table_from_numpy(table, "cpu")
    n2 = 2 * pt.words.a.shape[0]
    assert n2 > 2 * chunk and n2 % chunk
    rl = rbuild.build_links(table)
    whole = dbuild.build_links(pt, chunk=n2)
    chunked = dbuild.build_links(pt, chunk=chunk)
    for f in ("next", "prev", "head", "dist"):
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f
        assert np.array_equal(np.asarray(getattr(rl, f)), getattr(chunked, f).numpy()), f


def test_link_chunk_rows(monkeypatch):
    """One join of all 2m oriented nodes whenever table + nodes fit the
    free memory at LINK_BYTES_PER_ROW, else what fits (at least 2^20); the
    CPU sets no limit."""
    m = 5_000_000
    assert dbuild.link_chunk_rows(torch.device("cpu"), m) == 2 * m
    cuda = torch.device("cuda")
    per = dbuild.LINK_BYTES_PER_ROW
    for free, want in ((3 * m * per, 2 * m), (10 * m * per, 2 * m),
                       (2 * m * per, m), (m * per, 1 << 20)):
        monkeypatch.setattr(dbuild.kcount, "free_device_bytes", lambda device: free)
        assert dbuild.link_chunk_rows(cuda, m) == want, free


def test_trim_table_and_geom_bucket(case):
    _, table = case
    pt = convert.table_from_numpy(table, "cpu")
    for pad in (256, 1024):
        r = rbuild.trim_table(table, pad_multiple=pad)
        p = convert.table_to_numpy(dbuild.trim_table(pt, pad_multiple=pad))
        assert int(r.n_valid) == p.n_valid
        for i in range(3):
            assert np.array_equal(np.asarray(r.words[i]), p.words[i])
        for f in ("count", "nbc", "left_mask", "right_mask"):
            assert np.array_equal(np.asarray(getattr(r, f)), getattr(p, f)), f
    for n in (1, 1000, 1025, 123_456, 10**7):
        assert dbuild.geom_bucket(n) == rbuild.geom_bucket(n)
        assert dbuild.geom_bucket(n, 512) == rbuild.geom_bucket(n, 512)


def test_graph_npz_byte_compatible(case, tmp_path):
    """The port saves what the reference loads, and loads what it saves."""
    _, table = case
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    rbg.save(tmp_path / "ref.npz")
    pt = convert.table_from_numpy(table, "cpu")
    pbg = dgraph.from_device(dbuild.build_graph(pt), pt)
    pbg.save(tmp_path / "port.npz")
    assert_graphs_equal(rgraph.BaseGraph.load(tmp_path / "port.npz"), pbg)
    assert_graphs_equal(rbg, dgraph.BaseGraph.load(tmp_path / "ref.npz"))
    zr, zp = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert zr.files == zp.files
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k]), k


def test_device_arrays_are_tensors(case):
    _, table = case
    pt = convert.table_from_numpy(table, "cpu")
    pbg = dgraph.from_device(dbuild.build_graph(pt), pt)
    da = pbg.device_arrays("cpu")
    assert da is pbg.device_arrays(torch.device("cpu"))
    assert all(isinstance(v, torch.Tensor) for k, v in da.items() if k != "words")
    assert np.array_equal(da["edge_kmers"].numpy(), pbg.edges.lengths() - (K - 1))
