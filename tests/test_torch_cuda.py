"""The port's CUDA kernels on the card (marked `cuda`; every test skips
without a GPU).  This file imports no JAX module, so it also runs on a GPU
machine that has no jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Each kernel is held to its plain PyTorch twin (exact: all outputs are
integers), and the 8 kb slice and a slice cut into several count blocks
to the CPU plain path."""
import numpy as np
import pytest
import torch

from supernova_tpu_torch import convert
from supernova_tpu_torch.ingest.ingest import ingest_sim
from supernova_tpu_torch.kmer import count as kcount
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import _lib
from supernova_tpu_torch.ops.kernels import compact as k2
from supernova_tpu_torch.ops.kernels import kmer_extract as k1
from supernova_tpu_torch.ops.kernels import run_reduce as k3
from supernova_tpu_torch.ops.kernels import sort as k4
from supernova_tpu_torch.pipeline.run import Pipeline
from supernova_tpu_torch.sim import genome as sim

pytestmark = pytest.mark.cuda
SENT = 0xFFFFFFFF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def sorted_stream(rng, n, n_kmers, dev):
    """Sorted (w0, w1, w2, pk) int64 occurrence stream on `dev`, top-bit
    words included, invalid rows on sentinel words."""
    ids = np.sort(rng.integers(0, n_kmers, n))
    w0 = (ids // 1000).astype(np.int64) | 0x80000000
    w1 = (ids % 1000).astype(np.int64)
    w2 = (ids * 7 % 911).astype(np.int64)
    valid = rng.random(n) < 0.9
    bc = rng.integers(1, 50, n)
    bc[rng.random(n) < 0.2] = 0x3FFFFF
    pk = (bc << 10) | (rng.integers(0, 16, n) << 6) | (rng.integers(0, 16, n) << 2) | (valid.astype(np.int64) << 1)
    w0, w1, w2 = (np.where(valid, w, SENT) for w in (w0, w1, w2))
    order = np.lexsort((pk, w2, w1, w0))
    return [torch.from_numpy(np.ascontiguousarray(x[order])).to(dev) for x in (w0, w1, w2, pk)]


@pytest.mark.parametrize("n", [1, 257, 4097, 100_003])
def test_kernels_match_plain(dev, n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 4, n + 47, dtype=np.int32)).to(dev)
    for a, b in zip(k1.sliding_words_cuda(codes, n), k1.sliding_words_plain(codes, n)):
        assert torch.equal(a, b)
    cols = sorted_stream(rng, max(n, 2), 1 + n // 20, dev)
    for mf, mb in ((3, 2), (1, 0)):
        got = k3.run_reduce_cuda(*cols, mf, mb)
        for a, b in zip(got, k3.run_reduce_plain(*cols, mf, mb)):
            assert torch.equal(a, b)
    keep, count, stats = got
    nv_a, out_a = k2.compact_cuda(keep, *cols, count, stats)
    nv_b, out_b = k2.compact_plain(keep, *cols, count, stats)
    k = int(nv_b)
    assert int(nv_a) == k
    for a, b in zip(out_a, out_b):
        assert torch.equal(a[:k], b[:k])


def sort_keys(rng, n, n_keys, kind, dev):
    """n_keys int64 key columns in [0, 2^32) of one kind: full 32-bit
    (top bit set in half the rows), heavy ties, keys whose digits are
    mostly constant (skipped passes; the last key wholly constant), or
    every key all-ones (every pass skipped)."""
    keys = []
    for j in range(n_keys):
        if kind == "random":
            k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
        elif kind == "ties":
            k = rng.integers(0, 8, n).astype(np.int64)
        elif kind == "constant_digits":
            k = (rng.integers(0, 256, n).astype(np.int64) << 8) | 0x80000000
            if j == n_keys - 1:
                k = np.full(n, 0x12345678, np.int64)
        else:
            k = np.full(n, SENT, np.int64)
        keys.append(torch.from_numpy(k).to(dev))
    return keys


@pytest.mark.parametrize("kind", ["random", "ties", "constant_digits", "all_equal"])
@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 7])
def test_sort_matches_plain(dev, n, kind):
    """K4 equals its twin exactly (the stable permutation is unique) for
    1-6 keys."""
    rng = np.random.default_rng(n)
    for n_keys in range(1, k4.MAX_KEYS + 1):
        keys = sort_keys(rng, n, n_keys, kind, dev)
        got = k4.lex_argsort(*keys)
        assert got.dtype == torch.int64 and got.device.type == "cuda"
        assert torch.equal(got, k4.lex_argsort_plain(*keys)), (n_keys, kind)


def test_sort_wrapper_rejects_bad_input(dev):
    k = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        k4.lex_argsort(k.int())
    with pytest.raises(ValueError):
        k4.lex_argsort(k, k[:5])
    with pytest.raises(ValueError):
        k4.lex_argsort(torch.zeros(20, dtype=torch.int64, device=dev)[::2])
    with pytest.raises(ValueError):
        k4.lex_argsort(*([k] * 7))


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(TypeError):
        k1.sliding_words(torch.zeros(100, dtype=torch.int64, device=dev), 10)
    with pytest.raises(ValueError):
        k1.sliding_words(torch.zeros(100, dtype=torch.int32, device=dev), 60)
    w = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        k3.run_reduce(w, w, w, w, 3, 2)
    with pytest.raises(ValueError):
        k2.compact(torch.ones(10, dtype=torch.bool, device=dev), w[:5])
    with pytest.raises(ValueError):
        k2.compact(torch.ones(10, dtype=torch.bool, device=dev), *([w] * 9))


def test_build_is_cached(dev):
    assert _lib.build() == _lib.build()
    assert _lib.build().parent.name == _lib.source_hash()


def test_slice_cuda_equals_cpu(dev, tmp_path):
    rng = np.random.default_rng(7)
    g = sim.random_genome(rng, 8000)
    _, hb = sim.diploidize(rng, g, 0.002)
    wl = sim.make_whitelist(rng, 256)
    rs = ingest_sim(sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=80, molecules_per_barcode=2,
        molecule_len=4000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    ), wl)
    kernels.reset_launch_counts()
    tg, _, rg = Pipeline(tmp_path / "cuda", device="cuda").run(rs)
    assert all(c > 0 for c in kernels.launch_counts().values())
    tc, _, rc = Pipeline(tmp_path / "cpu", device="cpu").run(rs)
    a, b = convert.table_to_numpy(tg), convert.table_to_numpy(tc)
    assert a.n_valid == b.n_valid
    for x, y in zip((*a.words, *a[1:5]), (*b.words, *b[1:5])):
        assert np.array_equal(x, y)
    zg, zc = np.load(tmp_path / "cuda" / "graph.npz"), np.load(tmp_path / "cpu" / "graph.npz")
    for k in zc.files:
        assert np.array_equal(zg[k], zc[k]), k
    for x, y in zip(convert.readpaths_to_numpy(rg), convert.readpaths_to_numpy(rc)):
        assert np.array_equal(x[: rs.n_reads], y[: rs.n_reads])


def test_blocked_slice_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """~360 kb of reads cut into >= 3 count blocks: the blocked count, the
    device merge and the blocked pather on CUDA give the CPU's kmers.npz,
    graph.npz and ReadPaths, with every kernel launched."""
    rng = np.random.default_rng(3)
    g = sim.random_genome(rng, 6000, n_repeat_chunks=2, repeat_len=150)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 128)
    rs = ingest_sim(sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=30, molecules_per_barcode=2,
        molecule_len=3000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    ), wl)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 100_000)
    kernels.reset_launch_counts()
    pg = Pipeline(tmp_path / "cuda", device="cuda")
    _, _, rg = pg.run(rs)
    assert all(c > 0 for c in kernels.launch_counts().values())
    assert pg.stage_records["count"]["blocks"] >= 3
    _, _, rc = Pipeline(tmp_path / "cpu", device="cpu").run(rs)
    for name in ("kmers.npz", "graph.npz"):
        zg, zc = np.load(tmp_path / "cuda" / name), np.load(tmp_path / "cpu" / name)
        for k in zc.files:
            assert np.array_equal(zg[k], zc[k]), (name, k)
    for x, y in zip(convert.readpaths_to_numpy(rg), convert.readpaths_to_numpy(rc)):
        assert np.array_equal(x, y)
