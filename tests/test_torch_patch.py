"""The port's patch stage against the reference's, on the CPU, on the
fixture of tests/test_patch.py (a coverage hole that splits a 3 kb genome,
spanning mate pairs and one hole-covering read): the same gap pairs and
closures, the same patched BaseGraph from insert_patches (rebuilt through
the port's count and build), the same closures.npz, graph.patched.npz and
re-pathed paths.npz from both Pipeline.stage_patch, and the re-entry from
graph.patched.npz.  Also the count's min_read_len, which the rebuild sets
to K so that single-kmer edges survive.  Every comparison is exact."""
import numpy as np
import pytest
import torch

from supernova_tpu.align import pather as rpather
from supernova_tpu.asm import patch as rpatch
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu_torch.ingest.reads import build_readset
from supernova_tpu.kmer import count as rcount
from supernova_tpu.pipeline import run as rrun
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.align import pather as ppather
from supernova_tpu_torch.asm import patch as ppatch
from supernova_tpu_torch.core.kmer_codec import K
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.pipeline import run as prun

from tests.test_torch_cuda import hole_readset
from tests.test_torch_partitioned import assert_matches_reference
from tests.test_torch_slice import assert_npz_equal

GRAPH_FIELDS = ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture():
    """The readset, the reference's graph and raw paths, its gap pairs and
    closures."""
    rs = hole_readset(np.random.default_rng(0))
    table = rbuild.trim_table(rcount.count_readset(rs, min_freq=2), pad_multiple=256)
    bg = rgraph.from_device(rbuild.build_graph(table), table)
    rp = rpather.path_readset(bg, rs)
    n = rs.n_reads
    edges, plen, offset = (np.asarray(x)[:n] for x in rp[:3])
    pairs = rpatch.find_edge_pairs(bg, edges, plen, dup=None)
    closures = rpatch.close_gaps(bg, rs, pairs)
    assert pairs and closures
    return rs, bg, rp, (edges, plen, offset), pairs, closures


def port_readpaths(rp):
    """The reference's ReadPaths as the port's int64 tensors on the CPU."""
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt))
    return ppather.ReadPaths(*(t(x, np.int64) for x in rp[:4]), t(rp.overflow, bool))


def assert_same_graph(want, got):
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(want.edges.values, got.edges.values)
    assert np.array_equal(want.edges.offsets, got.edges.offsets)
    assert want.n_vertices == got.n_vertices


def test_pairs_and_closures_match(fixture):
    rs, bg, _, (edges, plen, offset), pairs, closures = fixture
    got = ppatch.find_edge_pairs(bg, edges, plen, dup=None)
    fields = lambda gp: (gp.e1, gp.e2, gp.support, gp.read_ids)
    assert [fields(gp) for gp in got] == [fields(gp) for gp in pairs]
    got_c = ppatch.close_gaps(bg, rs, got)
    assert len(got_c) == len(closures)
    for a, b in zip(closures, got_c):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_insert_patches_rebuilds_the_reference_graph(fixture):
    """The rebuild's count (unbarcoded reads of 0 to ~3,000 bases,
    min_freq=1, min_read_len=K) and build through the port, on the CPU."""
    _, bg, _, _, _, closures = fixture
    want = rpatch.insert_patches(bg, closures)
    got = ppatch.insert_patches(bg, closures, "cpu")
    assert_same_graph(want, got)
    assert got.edges.lengths().max() > bg.edges.lengths().max()
    assert ppatch.insert_patches(bg, [], "cpu") is bg


def test_patch_readset_is_the_reference_rebuild_input(fixture):
    _, bg, _, _, _, closures = fixture
    prs = ppatch.patch_readset(bg, closures)
    lens = prs.lengths()
    assert not prs.barcoded and lens.min() == 0 and prs.n_reads % 2 == 0
    table = kcount.count_readset(prs, "cpu", min_freq=1, min_read_len=K)
    assert_matches_reference(rcount.count_readset(prs, min_freq=1, min_read_len=K),
                             convert.table_to_numpy(table))


def test_stage_patch_writes_the_reference_files(fixture, tmp_path, monkeypatch):
    """Both packages' stage_patch on the same graph, reads and raw paths:
    the same closures.npz, graph.patched.npz, re-pathed paths.npz and
    stats; a resumed port stage re-enters from graph.patched.npz."""
    rs, bg, rp, *_ = fixture
    ref = rrun.Pipeline(tmp_path / "ref")
    bg_r, _ = ref.stage_patch(bg, rp, rs)
    port = prun.Pipeline(tmp_path / "port", device="cpu")
    rp_p = port_readpaths(rp)
    bg_p, rp2 = port.stage_patch(bg, rp_p, rs)
    for name in ("closures.npz", "graph.patched.npz", "paths.npz", "ebcx.npz"):
        assert_npz_equal(tmp_path / "ref" / name, tmp_path / "port" / name)
    assert_same_graph(bg_r, bg_p)
    for k in ("gap_pairs", "gap_closures", "placed_perc"):
        assert port.stats.get(k) == ref.stats.get(k), k
    assert port.stats.get("gap_closures") >= 1
    assert port.stage_records["patch"]["rebuild_launches"] == {
        "kmer_extract": 0, "compact": 0, "run_reduce": 0, "sort": 0, "scan_max": 0}

    monkeypatch.setattr(ppatch, "insert_patches", lambda *a: pytest.fail("rebuilt on resume"))
    resumed = prun.Pipeline(tmp_path / "port", device="cpu", resume=True)
    bg3, rp3 = resumed.stage_patch(bg, rp_p, rs)
    assert_same_graph(bg_p, bg3)
    for a, b in zip(convert.readpaths_to_numpy(rp2)[:3], convert.readpaths_to_numpy(rp3)[:3]):
        assert np.array_equal(a[: rs.n_reads], b[: rs.n_reads])


def test_stage_patch_returns_its_inputs_when_nothing_closes(fixture, tmp_path, monkeypatch):
    rs, bg, rp, *_ = fixture
    monkeypatch.setattr(ppatch, "close_gaps", lambda *a: [])
    port = prun.Pipeline(tmp_path, device="cpu")
    rp_p = port_readpaths(rp)
    bg2, rp2 = port.stage_patch(bg, rp_p, rs)
    assert bg2 is bg and rp2 is rp_p
    assert port.stats.get("gap_closures") == 0 and not (tmp_path / "closures.npz").exists()


def short_reads():
    """Three pairs, each a 48-base read (one kmer) and a 49-base read (two)
    from other places of a genome."""
    g = sim.random_genome(np.random.default_rng(5), 2000)
    reads = []
    for s in (100, 700, 1300):
        reads += [g[s : s + K].copy(), g[s + 300 : s + 300 + K + 1].copy()]
    quals = [np.full(len(r), 37, np.uint8) for r in reads]
    return build_readset(reads, quals, np.zeros(3, np.int32), n_barcodes=0, barcoded=False), reads


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("min_read_len", [None, K])
def test_min_read_len_keeps_single_kmer_reads(blocked, min_read_len):
    """min_read_len=K keeps a 48-base read's kmer, the default (K + 1)
    drops it, in both packages, single-block and blocked (3 blocks)."""
    rs, reads = short_reads()
    kw = {} if min_read_len is None else {"min_read_len": min_read_len}
    if blocked:
        info = {}
        port = kcount.count_readset_blocked(rs, "cpu", min_freq=1, max_positions=100,
                                            info=info, **kw)
        assert info["blocks"] == 3
        ref = rcount.count_readset_blocked(rs, min_freq=1, max_positions=100, **kw)
    else:
        port = kcount.count_readset(rs, "cpu", min_freq=1, **kw)
        ref = rcount.count_readset(rs, min_freq=1, **kw)
    port = convert.table_to_numpy(port)
    assert_matches_reference(ref, port)
    # 3 x 2 kmers of the 49-base reads, and 3 more when 48-base reads count
    assert port.n_valid == (9 if min_read_len == K else 6)
