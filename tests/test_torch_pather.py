"""Port parity: supernova_tpu_torch.align.pather against the JAX reference
on the CPU, exact equality, on a genome with repeats and 0.2% read errors.
The port paths against the REFERENCE's graph (loaded from its graph.npz),
so the pather is checked in isolation."""
import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.dbg import graph as dgraph
from supernova_tpu_torch.kmer import count as kcount

from tests.test_torch_count import mixed_length_readset


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(9)
    g = sim.random_genome(rng, 5000, n_repeat_chunks=3, repeat_len=250)
    _, hb = sim.diploidize(rng, g, 0.002)
    wl = sim.make_whitelist(rng, 32)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=12, molecules_per_barcode=2,
        molecule_len=2000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    )
    rs = ingest_sim(reads, wl)
    table = rbuild.trim_table(rcount.count_readset(rs), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    path = tmp_path_factory.mktemp("pather") / "graph.npz"
    rbg.save(path)
    return rs, rbg, dgraph.BaseGraph.load(path)


def assert_paths_equal(ref, port, n=None):
    p = convert.readpaths_to_numpy(port)
    for f, a, b in zip(p._fields, ref, p):
        a = np.asarray(a)[:n]
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b[:n]), f


def test_path_readset_matches_reference(world):
    rs, rbg, pbg = world
    ref = rpather.path_readset(rbg, rs)
    port = pather.path_readset(pbg, rs, "cpu")
    assert port.edges.shape == tuple(np.asarray(ref.edges).shape)
    assert_paths_equal(ref, port)
    plen = port.path_len[: rs.n_reads].numpy()
    assert (plen > 0).mean() > 0.9
    assert (plen > 1).sum() > 10  # junction checks exercised


def test_fused_impl_matches_reference(world):
    """path_reads_fused_impl on the per-position inputs of prepare_reads:
    the port's cummax+gather propagation against the reference's scan."""
    rs, rbg, pbg = world
    ri = rcount.prepare_reads(rs)
    pi = kcount.prepare_reads(rs, "cpu")
    rda, pda = rbg.device_arrays(), pbg.device_arrays("cpu")
    keys = ("words", "node_edge", "node_pos", "from_v", "to_v", "edge_kmers")
    nbp, rp = ri["pos_read"].shape[0], ri["read_offsets"].shape[0] - 1
    ref = rpather.path_reads_fused_impl(
        *(rda[k] for k in keys), ri["codes_ext"], ri["rlen_pos"], nbp, rp,
        rpather.MAX_PATH, ri["uniform_rl"],
    )
    port = pather.path_reads_fused_impl(
        *(pda[k] for k in keys), pi["codes_ext"], pi["rlen_pos"], nbp, rp,
        pather.MAX_PATH, pi["uniform_rl"],
    )
    assert_paths_equal(ref, port)


@pytest.mark.parametrize("max_path", [1, 2, 12])
def test_select_best_run_and_overflow(world, max_path):
    """Short slot budgets force overflow and truncated runs."""
    rs, rbg, pbg = world
    ref = rpather.path_readset(rbg, rs, max_path=max_path)
    port = pather.path_readset(pbg, rs, "cpu", max_path=max_path)
    assert_paths_equal(ref, port, rs.n_reads)
    if max_path == 1:
        assert port.overflow.any()


def test_unported_readsets_raise(world, monkeypatch):
    """Mixed-length readsets need the general pather, in one block or
    above it (the uniform blocked pather: tests/test_torch_blocked.py)."""
    rs, _, pbg = world
    with pytest.raises(NotImplementedError, match="general pather"):
        pather.path_readset(pbg, mixed_length_readset(), "cpu")
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 1000)
    with pytest.raises(NotImplementedError, match="general pather"):
        pather.path_readset(pbg, mixed_length_readset(), "cpu")
    assert isinstance(pbg.device_arrays("cpu")["node_edge"], torch.Tensor)
