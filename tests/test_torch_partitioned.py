"""The blocked count's bounded-memory endgame in supernova_tpu_torch: the
partitioned device merge, the block spills and their resume, the
OOM-halving retry and the chunked adjacency recompute, against the JAX
reference's count_readset_blocked (its host partitioned merge, with
MERGE_ROWS cut) and against the port's own single-block count, on the CPU.
Exact equality."""
import json
import os
import re
import tempfile

import numpy as np
import pytest
import torch

from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.kmer import spill
from supernova_tpu_torch.pipeline.run import Pipeline

from tests.test_torch_blocked import MAX_POS, blocked_readset

# the reference's meta keys, and the block size a resume takes
META_KEYS = {"n_blocks", "pad_pos", "pad_rd", "n_reads", "min_freq", "min_bc", "block_positions"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run thousands of small torch ops; with one intra-op pool
    of a thread a core in each of several test workers, the pools' waits
    make them 10-20x slower than in one process.  One thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rs():
    return blocked_readset()


@pytest.fixture(scope="module")
def single(rs):
    """The port's single-block count of rs, in numpy."""
    return convert.table_to_numpy(kcount.count_readset(rs, "cpu"))


@pytest.fixture(scope="module")
def raw_rows(rs):
    info = {}
    kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS, info=info)
    assert info["partitions"] == 1 and info["blocks"] >= 3
    return info["raw_rows"]


def assert_same_table(want, got):
    """Two numpy tables (table_to_numpy) equal bit for bit, padding included."""
    assert want.n_valid == got.n_valid
    for f, x, y in zip(("a", "b", "c", *want._fields[1:5]), (*want.words, *want[1:5]),
                       (*got.words, *got[1:5])):
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def assert_matches_reference(ref, port):
    """The reference's partitioned count pads with _finalize_table_host, so
    the comparison stops at n_valid."""
    n = int(ref.n_valid)
    assert n == port.n_valid
    for i in range(3):
        assert np.array_equal(np.asarray(ref.words[i])[:n], port.words[i][:n]), f"word {i}"
    for f in ("count", "nbc", "left_mask", "right_mask"):
        assert np.array_equal(np.asarray(getattr(ref, f))[:n], getattr(port, f)[:n]), f


# merge_rows as a fraction of the raw rows -> partitions it must give
CAPS = {"2_partitions": (1 / 1.25, 2), "4_partitions": (1 / 2.5, 4), "many": (None, 30)}


@pytest.mark.parametrize("cap", list(CAPS))
def test_partitioned_count_matches_reference_and_single_block(rs, single, raw_rows, cap,
                                                              monkeypatch):
    frac, parts = CAPS[cap]
    merge_rows = int(raw_rows * frac) if frac else 1000
    info = {}
    port = convert.table_to_numpy(kcount.count_readset_blocked(
        rs, "cpu", max_positions=MAX_POS, merge_rows=merge_rows, info=info))
    assert info["partitions"] == parts if frac else info["partitions"] >= parts
    assert sum(info["partition_rows"]) == raw_rows
    assert max(info["partition_rows"]) <= merge_rows
    assert_same_table(single, port)
    # the reference merges the same partitions on the host, serially
    monkeypatch.setattr(rcount, "MERGE_ROWS", merge_rows)
    monkeypatch.setenv("SN_MERGE_WORKERS", "1")
    assert_matches_reference(rcount.count_readset_blocked(rs, max_positions=MAX_POS), port)


def test_partitioned_count_skew_matches_reference(monkeypatch):
    """The reference's skew case (small genome, a merge cap of 4,000 raw
    rows): splitters must not cut a leading word's rows apart."""
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 4000, n_repeat_chunks=2, repeat_len=150)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 256)
    rs = ingest_sim(sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=60, molecules_per_barcode=2, molecule_len=3000,
        coverage_per_molecule=2.0, error_rate=0.002, bc_error_rate=0.02,
    ), wl)
    info = {}
    port = convert.table_to_numpy(kcount.count_readset_blocked(
        rs, "cpu", max_positions=60_000, merge_rows=4_000, info=info))
    assert info["partitions"] >= 2
    assert_same_table(convert.table_to_numpy(kcount.count_readset(rs, "cpu")), port)
    monkeypatch.setattr(rcount, "MERGE_ROWS", 4_000)
    monkeypatch.setenv("SN_MERGE_WORKERS", "1")
    assert_matches_reference(rcount.count_readset_blocked(rs, max_positions=60_000), port)


def skewed_blocks(seed=5, n_blocks=3, rows=400, dominant=0.6):
    """Raw block columns (spill dtypes, each block sorted) in which one
    leading word holds `dominant` of the rows; kmers repeat across blocks."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(n_blocks):
        ids = np.unique(rng.integers(0, rows * 2, rows))
        a = np.where(ids % 10 < dominant * 10, 5, ids * 2654435761 % 2**32).astype(np.uint32)
        b = (ids % 97).astype(np.uint32)
        c = ids.astype(np.uint32)
        order = np.lexsort((c, b, a))
        count = rng.integers(1, 4, len(ids)).astype(np.int32)
        stats = ((rng.integers(1, 3, len(ids)) << 9) | (rng.integers(0, 256, len(ids)) << 1)
                 | (rng.random(len(ids)) < 0.1)).astype(np.uint32)
        blocks.append(tuple(x[order] for x in (a, b, c, count, stats)))
    return blocks


def test_skewed_partition_widens_or_raises(monkeypatch):
    """A leading word holding more rows than merge_rows: its partition
    runs widened and the table equals the one-merge table; where the card's
    own budget cannot take it either, the merge raises naming its rows."""
    blocks = skewed_blocks()
    whole = convert.table_to_numpy(kcount.merge_blocks(blocks, "cpu", 3, 2))
    info = {}
    parts = convert.table_to_numpy(kcount.merge_blocks(blocks, "cpu", 3, 2, merge_rows=100,
                                                       info=info))
    assert info["partitions"] >= 2 and max(info["partition_rows"]) > 100
    assert whole.n_valid > 50
    assert_same_table(whole, parts)
    dominant = sum(int((b[0] == 5).sum()) for b in blocks)
    monkeypatch.setattr(kcount, "merge_row_limit", lambda device: 300)
    with pytest.raises(RuntimeError, match=r"holds (\d+) raw rows") as exc:
        kcount.merge_blocks(blocks, "cpu", 3, 2)
    assert int(re.search(r"holds (\d+) raw rows", str(exc.value))[1]) >= dominant > 300


def test_plan_partitions_cuts_on_word_boundaries():
    blocks = skewed_blocks(seed=6, n_blocks=4)
    parts = kcount.plan_partitions([b[0] for b in blocks], 150)
    assert parts[-1].hi_word == 1 << 32
    assert sum(p.rows for p in parts) == sum(len(b[0]) for b in blocks)
    for b_i, b in enumerate(blocks):
        a = b[0].astype(np.int64)
        for p, q in zip(parts, parts[1:]):
            assert p.hi[b_i] == q.lo[b_i]
            # a partition ends at its bound: no word spans two partitions
            assert (a[p.lo[b_i] : p.hi[b_i]] < p.hi_word).all()
            assert (a[q.lo[b_i] : q.hi[b_i]] >= p.hi_word).all()
    assert kcount.plan_partitions([b[0] for b in blocks], 10**9) == [
        kcount.Partition(1 << 32, [0] * 4, [len(b[0]) for b in blocks],
                         sum(len(b[0]) for b in blocks))]


def test_spill_resume(rs, single, raw_rows, tmp_path, monkeypatch):
    """A persistent spill directory: markers and the block plan's meta are
    written, a block whose marker is gone is the only one recounted, a
    different block size clears the stale spills, and every table is the
    single-block one."""
    calls = []
    real = kcount.count_block_raw

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kcount, "count_block_raw", counting)
    sd = tmp_path / "spill"
    merge_rows = int(raw_rows / 2.5)

    def run(max_positions=MAX_POS):
        calls.clear()
        info = {}
        t = kcount.count_readset_blocked(rs, "cpu", max_positions=max_positions,
                                         merge_rows=merge_rows, spill_dir=sd, info=info)
        assert_same_table(single, convert.table_to_numpy(t))
        return info

    info = run()
    nb = info["blocks"]
    assert len(calls) == nb and info["spilled_blocks"] == nb and info["resumed_blocks"] == 0
    assert info["partitions"] == 4
    meta = json.loads((sd / "meta.json").read_text())
    assert set(meta) == META_KEYS
    assert meta["n_blocks"] == nb and meta["n_reads"] == rs.n_reads
    oks = sorted(sd.glob("b*.ok"))
    assert len(oks) == nb
    # 20 B a raw row on disk: uint32 words, int32 count, uint32 stats
    for i, rows in enumerate(info["block_rows"]):
        assert int(oks[i].read_text()) == rows
        cols = [np.load(sd / f"b{i}_{j}.npy", mmap_mode="r") for j in range(5)]
        assert [c.dtype for c in cols] == [np.dtype(d) for d in spill.COLUMN_DTYPES]
        assert all(isinstance(c, np.memmap) and len(c) == rows for c in cols)
        assert sum(c.itemsize for c in cols) == 20

    oks[1].unlink()
    info = run()
    assert len(calls) == 1 and info["spilled_blocks"] == 1 and info["resumed_blocks"] == nb - 1
    info = run()
    assert calls == [] and info["resumed_blocks"] == nb

    info = run(max_positions=2 * MAX_POS)
    assert info["blocks"] < nb and info["resumed_blocks"] == 0 and len(calls) == info["blocks"]
    nb2 = info["blocks"]
    assert sorted(os.listdir(sd)) == sorted(
        ["meta.json"] + [f"b{i}.ok" for i in range(nb2)]
        + [f"b{i}_{j}.npy" for i in range(nb2) for j in range(5)])


def test_temporary_spill_is_removed(rs, tmp_path, monkeypatch):
    """Without a spill directory the blocks spill to a temporary one, which
    is gone after the count, also when the merge raises."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    seen = []
    real = kcount.merge_blocks

    def merge(blocks, *a, **kw):
        (d,) = os.listdir(tmp)
        seen.extend(os.listdir(tmp / d))
        assert all(isinstance(c, np.memmap) for b in blocks for c in b)
        return real(blocks, *a, **kw)

    monkeypatch.setattr(kcount, "merge_blocks", merge)
    info = {}
    kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS, info=info)
    assert len(seen) == 5 * info["blocks"] and "meta.json" not in seen
    assert os.listdir(tmp) == []

    def fail(*a, **kw):
        raise RuntimeError("merge failed")

    monkeypatch.setattr(kcount, "merge_blocks", fail)
    with pytest.raises(RuntimeError, match="merge failed"):
        kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS)
    assert os.listdir(tmp) == []


def fake_blocked(sizes, fail, real):
    """A count_readset_blocked that records each attempt's block size and
    raises fail(attempt) where that is an exception."""
    def blocked(rs_, device, *a, max_positions=None, **kw):
        sizes.append(max_positions)
        err = fail(len(sizes))
        if err is not None:
            raise err
        return real(rs_, device, *a, max_positions=max_positions, **kw)
    return blocked


def test_oom_halving_retry(rs, single, monkeypatch):
    """Two device OOMs: the block size halves twice, the table is the
    single-block one, and each failed attempt is freed."""
    sizes, freed = [], []
    monkeypatch.setattr(kcount, "count_readset_blocked", fake_blocked(
        sizes, lambda k: torch.cuda.OutOfMemoryError("CUDA out of memory") if k < 3 else None,
        kcount.count_readset_blocked))
    monkeypatch.setattr(kcount, "_free_failed_attempt", freed.append)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 25_000)
    info = {}
    got = kcount.count_readset(rs, "cpu", info=info)
    assert sizes == [200_000, 100_000, 50_000]
    assert info["oom_retries"] == 2 and info["block_positions"] == 50_000
    assert len(freed) == 2 and all(isinstance(e, torch.cuda.OutOfMemoryError) for e in freed)
    assert_same_table(single, convert.table_to_numpy(got))


def test_oom_below_min_block_reraises(rs, monkeypatch):
    sizes = []
    monkeypatch.setattr(kcount, "count_readset_blocked", fake_blocked(
        sizes, lambda k: torch.cuda.OutOfMemoryError("CUDA out of memory"), None))
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 100_000)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        kcount.count_readset(rs, "cpu")
    assert sizes == [200_000, 100_000]


@pytest.mark.parametrize("err", [ValueError("some other failure"),
                                 RuntimeError("CUDA error: an illegal memory access")])
def test_non_oom_error_reraises(rs, monkeypatch, err):
    sizes = []
    monkeypatch.setattr(kcount, "count_readset_blocked", fake_blocked(sizes, lambda k: err, None))
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    with pytest.raises(type(err), match=str(err)):
        kcount.count_readset(rs, "cpu")
    assert sizes == [200_000]


def test_free_failed_attempt_clears_the_chain():
    """Every traceback of the exception chain goes (they pin the failed
    attempt's frames and so its tensors)."""
    try:
        try:
            raise ValueError("inner")
        except ValueError as inner:
            raise torch.cuda.OutOfMemoryError("outer") from inner
    except torch.cuda.OutOfMemoryError as e:
        err = e
    assert err.__traceback__ is not None and err.__cause__.__traceback__ is not None
    kcount._free_failed_attempt(err)
    assert err.__traceback__ is None and err.__cause__.__traceback__ is None


def test_recompute_adjacencies_chunked(rs):
    """The chunked recompute equals the unchunked one and the reference's
    host twin on a table whose masks carry extra bits (so the recompute
    has bits to prune)."""
    rng = np.random.default_rng(1)
    t = kcount.count_readset(rs, "cpu")
    n = int(t.n_valid)
    assert n > 500
    lm, rm = t.left_mask.clone(), t.right_mask.clone()
    lm[:n] |= torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
    rm[:n] |= torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
    t2 = t._replace(left_mask=lm, right_mask=rm)
    whole = kcount.recompute_adjacencies(t2)
    chunked = kcount.recompute_adjacencies(t2, chunk=257)
    assert not torch.equal(whole.left_mask, lm) and not torch.equal(whole.right_mask, rm)
    assert torch.equal(whole.left_mask, chunked.left_mask)
    assert torch.equal(whole.right_mask, chunked.right_mask)
    host = convert.table_to_numpy(t2)
    ref_l, ref_r = rcount.recompute_adjacencies_host(
        *(w[:n] for w in host.words), host.left_mask[:n], host.right_mask[:n], chunk=257)
    assert np.array_equal(ref_l, chunked.left_mask[:n].numpy().astype(np.uint32))
    assert np.array_equal(ref_r, chunked.right_mask[:n].numpy().astype(np.uint32))


def test_pipeline_resumes_count_spill(rs, tmp_path, monkeypatch):
    """A count_spill/ left by a killed run: Pipeline's count resumes every
    block from it, writes the same kmers.npz, then removes it."""
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", MAX_POS)
    pl = Pipeline(tmp_path / "fresh", device="cpu")
    pl.stage_count(rs)
    rec = pl.stage_records["count"]
    assert rec["resumed_blocks"] == 0 and rec["oom_retries"] == 0
    assert not (tmp_path / "fresh" / "count_spill").exists()
    kcount.count_readset_blocked(rs, "cpu", max_positions=MAX_POS,
                                 spill_dir=tmp_path / "resumed" / "count_spill")
    pl2 = Pipeline(tmp_path / "resumed", device="cpu")
    pl2.stage_count(rs)
    rec2 = pl2.stage_records["count"]
    assert rec2["resumed_blocks"] == rec2["blocks"] == rec["blocks"]
    assert rec2["spilled_blocks"] == 0
    assert not (tmp_path / "resumed" / "count_spill").exists()
    z1, z2 = np.load(tmp_path / "fresh" / "kmers.npz"), np.load(tmp_path / "resumed" / "kmers.npz")
    for k in z1.files:
        assert np.array_equal(z1[k], z2[k]), k
