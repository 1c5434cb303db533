"""Port parity for readsets above one count block: the blocked count
(per-block raw tables + one merge) and the blocked pather of
supernova_tpu_torch against the JAX reference's count_readset_blocked and
_path_readset_blocked on the CPU, and against the port's own single-block
path.  Exact equality; small blocks (max_positions) force several blocks."""
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
from supernova_tpu_torch.pipeline.datasets import r1_trimmed
from supernova_tpu_torch.pipeline.run import Pipeline

from tests.test_torch_count import assert_tables_equal
from tests.test_torch_slice import assert_npz_equal, assert_stage_paths_match, reference_stage_paths

MAX_POS = 100_000


def blocked_readset(seed=3, barcoded=True):
    """~360 kb of 150 bp reads over 30 barcodes (plus the unbarcoded
    prefix of reads whose barcode did not correct): 4 blocks at MAX_POS."""
    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, 6000, n_repeat_chunks=2, repeat_len=150)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 128)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=30, molecules_per_barcode=2,
        molecule_len=3000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    )
    rs = ingest_sim(reads, wl)
    rs.barcoded = barcoded
    return rs


@pytest.fixture(scope="module")
def rs():
    return blocked_readset()


@pytest.fixture(scope="module")
def port_blocked(rs):
    info = {}
    return kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS, info=info), info


def test_blocked_count_matches_reference_and_single_block(rs, port_blocked):
    table, info = port_blocked
    assert info["blocks"] >= 3 and info["raw_rows"] == sum(info["block_rows"])
    ref = rcount.count_readset_blocked(rs, max_positions=MAX_POS)
    assert int(ref.n_valid) > 1000
    assert_tables_equal(ref, table)
    assert_tables_equal(ref, kcount.count_readset(rs, "cpu"))


def test_blocked_count_matches_partitioned_reference_merge(rs, port_blocked, monkeypatch):
    """MERGE_ROWS cut so the reference merges on the host in exactly two
    kmer-range partitions (serially: no worker is forked); the port's one
    merge must give the same rows.  The reference pads that table with
    _finalize_table_host, so the comparison stops at n_valid."""
    table, info = port_blocked
    tot = info["raw_rows"]
    merge_rows = int(tot / 1.25)
    assert merge_rows < tot <= 1.5 * merge_rows
    assert max(2, -(-tot // int(merge_rows * 0.75))) == 2
    monkeypatch.setattr(rcount, "MERGE_ROWS", merge_rows)
    ref = rcount.count_readset_blocked(rs, max_positions=MAX_POS)
    n = int(ref.n_valid)
    assert n == int(table.n_valid)
    port = convert.table_to_numpy(table)
    for i in range(3):
        assert np.array_equal(np.asarray(ref.words[i])[:n], port.words[i][:n]), f"word {i}"
    for f in ("count", "nbc", "left_mask", "right_mask"):
        assert np.array_equal(np.asarray(getattr(ref, f))[:n], getattr(port, f)[:n]), f


def test_blocked_count_unbarcoded():
    rs = blocked_readset(seed=4, barcoded=False)
    port = kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS)
    assert_tables_equal(rcount.count_readset_blocked(rs, max_positions=MAX_POS), port)
    assert_tables_equal(rcount.count_readset(rs), port)


@pytest.mark.parametrize("max_positions", [40_000, MAX_POS, 10**9])
def test_split_readset_blocks_matches_reference(rs, max_positions):
    ref = rcount.split_readset_blocks(rs, max_positions)
    port = kcount.split_readset_blocks(rs, max_positions)
    assert len(ref) == len(port)
    assert sum(b.n_reads for b in port) == rs.n_reads
    for a, b in zip(ref, port):
        for f in ("codes", "offsets", "quals", "bc", "bci"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.barcoded == b.barcoded


def test_count_block_raw_packed_matches_reference(rs):
    """One uniform block's unfiltered raw table as the blocked count makes
    it (prepare_reads, expanded on the device, then count_block_raw) equals
    the reference's from its packed inputs (count_block_raw_packed)."""
    import jax.numpy as jnp

    blocks = kcount.split_readset_blocks(rs, MAX_POS)
    block = blocks[1]
    rp = rcount.prepare_reads_packed(block, pad_to_positions=MAX_POS)
    ref = rcount.count_block_raw_packed(
        jnp.asarray(rp["codes_packed"]), jnp.asarray(rp["glen"]), jnp.asarray(rp["read_bc"]),
        jnp.asarray(np.int32(rp["n_reads"])), uniform_rl=rp["uniform_rl"], nbp=rp["nbp"],
    )
    p = kcount.prepare_reads(block, "cpu", pad_to_positions=MAX_POS,
                             pad_to_reads=max(b.n_reads for b in blocks))
    assert p["uniform_rl"] == rp["uniform_rl"] and p["pos_read"].shape[0] == rp["nbp"]
    port = kcount.count_block_raw(p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
                                  p["uniform_rl"])
    assert int(ref.n_valid) == int(port.n_valid) > 1000
    for i in range(3):
        assert np.array_equal(np.asarray(ref.words[i]).astype(np.int64), port.words[i].numpy())
    assert np.array_equal(np.asarray(ref.count), port.count.numpy())
    assert np.array_equal(np.asarray(ref.stats).astype(np.int64), port.stats.numpy().astype(np.int64))


def test_merge_raw_blocks_matches_reference():
    """Synthetic raw rows with repeated kmers (up to 6 rows a kmer, as from
    6 blocks), top-bit words, nbc sums past the 4095 clamp and every mask
    bit; both filters."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, kinds = 5000, 1500
    ids = rng.integers(0, kinds, n)
    wa = (ids * 2654435761 % 2**32).astype(np.uint32)
    wb = (ids % 7).astype(np.uint32) | np.uint32(0x80000000)
    wc = (ids * 40503 % 2**32).astype(np.uint32)
    count = rng.integers(1, 9, n).astype(np.int32)
    nbc = np.where(rng.random(n) < 0.05, 4000, rng.integers(0, 5, n))
    stats = ((nbc << 9) | (rng.integers(0, 16, n) << 5) | (rng.integers(0, 16, n) << 1)
             | (rng.random(n) < 0.2)).astype(np.uint32)
    for mf, mb in ((3, 2), (1, 0)):
        ref = rcount.merge_raw_blocks(*map(jnp.asarray, (wa, wb, wc, count, stats)),
                                      min_freq=mf, min_bc=mb)
        t = lambda a: torch.from_numpy(a.astype(np.int64))
        port = kcount.merge_raw_blocks(t(wa), t(wb), t(wc), torch.from_numpy(count),
                                       torch.from_numpy(stats.astype(np.int32)), mf, mb)
        k = int(ref.n_valid)
        assert k == int(port.n_valid) > 100
        p = convert.table_to_numpy(port)
        for i in range(3):
            assert np.array_equal(np.asarray(ref.words[i])[:k], p.words[i][:k])
        for f in ("count", "nbc", "left_mask", "right_mask"):
            assert np.array_equal(np.asarray(getattr(ref, f))[:k], getattr(p, f)[:k]), f
        assert (p.nbc[:k] == 4095).any()


def test_blocked_pather_matches_reference_and_single_block(rs, tmp_path):
    table = rbuild.trim_table(rcount.count_readset(rs), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    rbg.save(tmp_path / "graph.npz")
    pbg = dgraph.BaseGraph.load(tmp_path / "graph.npz")
    ref = rpather._path_readset_blocked(rbg, rs, rpather.MAX_PATH, max_positions=MAX_POS)
    port = convert.readpaths_to_numpy(
        pather.path_readset_blocked(pbg, rs, "cpu", max_positions=MAX_POS))
    single = convert.readpaths_to_numpy(pather.path_readset(pbg, rs, "cpu"))
    n = rs.n_reads
    for f, a, b, c in zip(port._fields, ref, port, single):
        assert b.shape[0] == n, f
        assert np.array_equal(np.asarray(a), b), f
        assert np.array_equal(c[:n], b), f
    assert (port.path_len > 0).mean() > 0.9


def test_pipeline_blocked_equals_unblocked(rs, tmp_path, monkeypatch):
    """The Pipeline's stages with blocks forced write the same kmers.npz and
    graph.npz as the one-block run, and the same ReadPaths[:n_reads]."""
    _, _, rp1 = Pipeline(tmp_path / "one", device="cpu").run_slice(rs)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", MAX_POS)
    pl = Pipeline(tmp_path / "blocked", device="cpu")
    _, _, rp2 = pl.run_slice(rs)
    rec = pl.stage_records["count"]
    assert rec["blocks"] >= 3 and rec["spilled_blocks"] == rec["blocks"]
    assert rec["partitions"] == 1 and rec["oom_retries"] == 0
    assert not (tmp_path / "blocked" / "count_spill").exists()
    for name in ("kmers.npz", "graph.npz"):
        z1, z2 = np.load(tmp_path / "one" / name), np.load(tmp_path / "blocked" / name)
        assert z1.files == z2.files
        for k in z1.files:
            assert z1[k].dtype == z2[k].dtype and np.array_equal(z1[k], z2[k]), (name, k)
    n = rs.n_reads
    for a, b in zip(rp1, rp2):
        assert torch.equal(a[:n], b)
    assert pl.stats.get("placed_perc") > 90


def test_blocked_paths_raise_where_not_ported(rs, port_blocked, tmp_path, monkeypatch):
    """A mixed-length readset (every R1 cut by R1_SKIP, as a real 10x run
    has it) above one block runs through Pipeline: the blocked mixed count,
    the graph and the blocked general pather with rescue, extend, paths.npz
    and ebcx.npz, each equal to the reference's stage functions.  Raw rows
    above the card's merge budget take the partitioned merge: the same
    table.  (The name predates the port of the mixed-length blocked paths,
    when they raised.)"""
    mixed = r1_trimmed(rs)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", MAX_POS)
    monkeypatch.setattr(rcount, "BLOCK_POSITIONS", MAX_POS)
    pl = Pipeline(tmp_path / "port", device="cpu")
    table, _, rp = pl.run_slice(mixed)
    assert pl.stage_records["count"]["blocks"] >= 3 and pl.stage_records["paths"]["blocks"] >= 3
    assert pl.stage_records["paths"]["oom_retries"] == 0
    rt = rbuild.trim_table(rcount.count_readset(mixed))
    assert_tables_equal(rt, table)
    rbg = rgraph.from_device(rbuild.build_graph(rt), rt)
    rbg.save(tmp_path / "graph.npz")
    assert_npz_equal(tmp_path / "graph.npz", tmp_path / "port" / "graph.npz")
    rrp, rstats = reference_stage_paths(rbg, mixed, tmp_path)
    assert_stage_paths_match(pl, tmp_path / "port", rp, rrp, rstats, tmp_path, mixed.n_reads)
    assert rstats["placed_perc"] > 90

    monkeypatch.setattr(kcount, "merge_row_limit", lambda device: 1000)
    info = {}
    table = kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS, info=info)
    assert info["partitions"] >= info["raw_rows"] // 1000
    assert_tables_equal(rcount.count_readset(rs), table)
    want, got = convert.table_to_numpy(port_blocked[0]), convert.table_to_numpy(table)
    assert want.n_valid == got.n_valid
    for x, y in zip((*want.words, *want[1:5]), (*got.words, *got[1:5])):
        assert np.array_equal(x, y)
