"""Mixed-length readsets in supernova_tpu_torch (a real 10x run's R1 is
R1_SKIP = 23 bases shorter than its R2): the general pather against the
reference's path_reads_impl, with and without the tail cut, and against
the port's fused pather on uniform reads; the position-in-read gather
against the reference's cummax with empty reads present; prepare_reads'
padding; a spill of the other mode cleared; the pather's OOM-halving
retry.  On the CPU, exact equality."""
import json
from functools import partial

import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.kmer import count as rcount
from supernova_tpu_torch import convert
from supernova_tpu_torch.align import pather
from supernova_tpu_torch.dbg import graph as dgraph
from supernova_tpu_torch.ingest.reads import ReadSet
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.pipeline.datasets import R1_SKIP, r1_trimmed

from tests.test_torch_blocked import MAX_POS, blocked_readset
from tests.test_torch_count import assert_tables_equal

GRAPH_KEYS = ("words", "node_edge", "node_pos", "from_v", "to_v", "edge_kmers")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread a test worker (see
    tests/test_torch_partitioned.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The blocked test readset (uniform), its R1_SKIP cut, and the
    reference's graph of the cut as both packages' BaseGraph."""
    rs = blocked_readset()
    mixed = r1_trimmed(rs)
    table = rbuild.trim_table(rcount.count_readset(mixed), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    path = tmp_path_factory.mktemp("mixed") / "graph.npz"
    rbg.save(path)
    return rs, mixed, rbg, dgraph.BaseGraph.load(path)


def with_empty_reads(rs, n=300):
    """The first n reads of rs with every 7th read empty and every 5th cut
    to 30 bases (shorter than K)."""
    keep = np.diff(rs.offsets)[:n].copy()
    keep[::7] = 0
    keep[3::5] = np.minimum(keep[3::5], 30)
    starts = rs.offsets[:n]
    idx = np.concatenate([np.arange(s, s + k) for s, k in zip(starts, keep)])
    return ReadSet(codes=rs.codes[idx], offsets=np.concatenate([[0], np.cumsum(keep)]),
                   quals=rs.quals[idx], bc=rs.bc[:n], bci=np.array([0, 0, n]), barcoded=True)


def assert_paths_equal(ref, port):
    p = convert.readpaths_to_numpy(port)
    for f, a, b in zip(p._fields, ref, p):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


def general_paths(rbg, pbg, rs, uniform):
    """The reference's and the port's path_reads_impl on prepare_reads(rs);
    uniform=False drops the tail cut even for uniform reads.  Without the
    tail cut the reference runs it under its jitted path_reads (one compile
    instead of one a primitive); with it, path_reads would take the fused
    pather, so path_reads_impl runs eagerly."""
    ri, pi = rcount.prepare_reads(rs), kcount.prepare_reads(rs, "cpu")
    rda, pda = rbg.device_arrays(), pbg.device_arrays("cpu")
    rl_r, rl_p = (ri["uniform_rl"], pi["uniform_rl"]) if uniform else (None, None)
    keys = ("codes_ext", "read_offsets", "pos_read", "rlen_pos")
    if uniform:
        ref = rpather.path_reads_impl(
            partial(rpather._resolve_local, rda["words"], rda["node_edge"], rda["node_pos"]),
            rda["from_v"], rda["to_v"], rda["edge_kmers"], *(ri[k] for k in keys),
            max_path=rpather.MAX_PATH, uniform_rl=rl_r)
    else:
        ref = rpather.path_reads(*(rda[k] for k in GRAPH_KEYS), *(ri[k] for k in keys),
                                 max_path=rpather.MAX_PATH, uniform_rl=None)
    port = pather.path_reads_impl(*(pda[k] for k in GRAPH_KEYS), *(pi[k] for k in keys),
                                  pather.MAX_PATH, rl_p)
    return ref, port


@pytest.mark.parametrize("kind", ["mixed", "uniform", "uniform, no tail cut", "empty reads"])
def test_path_reads_impl_matches_reference(world, kind):
    rs, mixed, rbg, pbg = world
    inp = {"mixed": mixed, "empty reads": with_empty_reads(mixed)}.get(kind, rs)
    ref, port = general_paths(rbg, pbg, inp, uniform=kind == "uniform")
    assert_paths_equal(ref, port)
    plen = port.path_len[: inp.n_reads]
    assert (plen > 0).float().mean() > (0.6 if kind == "empty reads" else 0.9)
    assert (plen > 1).sum() > 10  # junction checks exercised


def test_general_pather_equals_fused_on_uniform_reads(world):
    """The reference's test_fused_matches_general, on the port: the general
    pather, with and without the tail cut, equals the fused one."""
    rs, _, _, pbg = world
    pi = kcount.prepare_reads(rs, "cpu")
    da = pbg.device_arrays("cpu")
    nbp, rp = pi["pos_read"].shape[0], pi["read_offsets"].shape[0] - 1
    fused = pather.path_reads_fused_impl(*(da[k] for k in GRAPH_KEYS), pi["codes_ext"],
                                         pi["rlen_pos"], nbp, rp, pather.MAX_PATH,
                                         pi["uniform_rl"])
    assert (fused.path_len[: rs.n_reads] > 0).float().mean() > 0.9
    for rl in (pi["uniform_rl"], None):
        general = pather.path_reads_impl(
            *(da[k] for k in GRAPH_KEYS), pi["codes_ext"], pi["read_offsets"], pi["pos_read"],
            pi["rlen_pos"], pather.MAX_PATH, rl)
        for f, a, b in zip(pather.ReadPaths._fields, fused, general):
            assert torch.equal(a, b), (rl, f)


def test_position_in_read_gather_equals_cummax(world):
    """p - read_offsets[pos_read] (the port) equals the reference's cummax
    from each read's first position, with empty and short reads and the
    padding read present."""
    rs = with_empty_reads(world[1])
    assert (np.diff(rs.offsets) == 0).sum() > 10
    pi = kcount.prepare_reads(rs, "cpu")
    pos_read, offs = pi["pos_read"], pi["read_offsets"]
    nb = pos_read.shape[0]
    assert nb > int(rs.offsets[-1])  # padding positions
    p = torch.arange(nb)
    first = torch.ones(nb, dtype=torch.bool)
    first[1:] = pos_read[1:] != pos_read[:-1]
    cummax = p - torch.cummax(torch.where(first, p, 0), 0).values
    assert torch.equal(p - offs.long()[pos_read.long()], cummax)


@pytest.mark.parametrize("pads", [(None, None), (MAX_POS + 5, 900), (1, 1)])
@pytest.mark.parametrize("kind", ["mixed", "uniform", "empty reads"])
def test_prepare_reads_padding_matches_reference(world, kind, pads):
    """The arrays the card gets equal the reference's prepare_reads at the
    same padding, on a block of the blocked pather."""
    rs, mixed, _, _ = world
    src = {"mixed": mixed, "uniform": rs, "empty reads": with_empty_reads(mixed)}[kind]
    block = kcount.split_readset_blocks(src, MAX_POS)[-1]
    pos, rd = pads
    ri = rcount.prepare_reads(block, pad_to_positions=pos, pad_to_reads=rd)
    pi = kcount.prepare_reads(block, "cpu", pad_to_positions=pos, pad_to_reads=rd)
    assert ri.keys() == pi.keys() - {"good_lengths"} and ri["uniform_rl"] == pi["uniform_rl"]
    assert np.array_equal(pi["good_lengths"], rcount.good_lengths_np(block.quals, block.offsets))
    for k in ri:
        if k != "uniform_rl":
            a = np.asarray(ri[k])
            assert a.dtype == pi[k].numpy().dtype and np.array_equal(a, pi[k].numpy()), k
    if rd:
        assert pi["read_offsets"].shape[0] - 1 >= rd + 1


@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_stale_spill_with_other_meta_is_cleared(world, tmp_path, kind):
    """A spill directory whose meta matches but for a key the count does
    not write (`packed`, which spills of an earlier input path carried) is
    cleared: every block is counted again, the meta is rewritten, and the
    table is the reference's."""
    rs, mixed, _, _ = world
    src = mixed if kind == "mixed" else rs
    d = tmp_path / "spill"
    kcount.count_readset_blocked(src, "cpu", max_positions=MAX_POS, spill_dir=d)
    meta = json.loads((d / "meta.json").read_text())
    assert "packed" not in meta
    (d / "meta.json").write_text(json.dumps(dict(meta, packed=kind == "uniform")))
    info = {}
    table = kcount.count_readset_blocked(src, "cpu", max_positions=MAX_POS, spill_dir=d,
                                         info=info)
    assert info["blocks"] >= 3 and info["resumed_blocks"] == 0
    assert info["spilled_blocks"] == info["blocks"]
    assert json.loads((d / "meta.json").read_text()) == meta
    assert_tables_equal(rcount.count_readset_blocked(src, max_positions=MAX_POS), table)


def fake_blocked(sizes, fail, real):
    """A path_readset_blocked that records each attempt's block size and
    raises fail(attempt) where that is an exception."""
    def blocked(bg, rs_, device, max_path, max_positions=None, info=None):
        sizes.append(max_positions)
        err = fail(len(sizes))
        if err is not None:
            raise err
        return real(bg, rs_, device, max_path, max_positions=max_positions, info=info)
    return blocked


@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_pather_oom_halving_retry(world, monkeypatch, kind):
    """Two device OOMs: the block size halves twice, each failed attempt is
    freed, and the paths equal the one-block pather's over [:n_reads]."""
    rs, mixed, _, pbg = world
    src = mixed if kind == "mixed" else rs
    want = pather.path_readset(pbg, src, "cpu")
    sizes, freed = [], []
    monkeypatch.setattr(pather, "path_readset_blocked", fake_blocked(
        sizes, lambda k: torch.cuda.OutOfMemoryError("CUDA out of memory") if k < 3 else None,
        pather.path_readset_blocked))
    monkeypatch.setattr(kcount, "_free_failed_attempt", freed.append)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 25_000)
    info = {}
    got = pather.path_readset(pbg, src, "cpu", info=info)
    assert sizes == [200_000, 100_000, 50_000]
    assert info["oom_retries"] == 2 and info["block_positions"] == 50_000 and info["blocks"] >= 6
    assert len(freed) == 2 and all(isinstance(e, torch.cuda.OutOfMemoryError) for e in freed)
    for f, a, b in zip(pather.ReadPaths._fields, want, got):
        assert b.shape[0] == src.n_reads and torch.equal(a[: src.n_reads], b), f


def test_pather_oom_below_min_block_reraises(world, monkeypatch):
    _, mixed, _, pbg = world
    sizes = []
    monkeypatch.setattr(pather, "path_readset_blocked", fake_blocked(
        sizes, lambda k: torch.cuda.OutOfMemoryError("CUDA out of memory"), None))
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 100_000)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        pather.path_readset(pbg, mixed, "cpu")
    assert sizes == [200_000, 100_000]


@pytest.mark.parametrize("err", [ValueError("some other failure"),
                                 RuntimeError("CUDA error: an illegal memory access")])
def test_pather_non_oom_error_reraises(world, monkeypatch, err):
    _, mixed, _, pbg = world
    sizes = []
    monkeypatch.setattr(pather, "path_readset_blocked", fake_blocked(sizes, lambda k: err, None))
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    with pytest.raises(type(err), match=str(err)):
        pather.path_readset(pbg, mixed, "cpu")
    assert sizes == [200_000]


def test_r1_trimmed_cuts_every_r1(world):
    rs, mixed, _, _ = world
    assert mixed.n_reads == rs.n_reads
    assert np.array_equal(mixed.bc, rs.bc) and np.array_equal(mixed.bci, rs.bci)
    lens = np.diff(mixed.offsets)
    assert (lens[0::2] == 150 - R1_SKIP).all() and (lens[1::2] == 150).all()
    for i in (0, 1, rs.n_reads - 2, rs.n_reads - 1):
        cut = R1_SKIP if i % 2 == 0 else 0
        assert np.array_equal(mixed.read(i), rs.read(i)[cut:])
        assert np.array_equal(mixed.qual(i), rs.qual(i)[cut:])
