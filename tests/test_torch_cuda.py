"""The port's CUDA kernels on the card (marked `cuda`; every test skips
without a GPU).  This file imports no JAX module, so it also runs on a GPU
machine that has no jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Each kernel is held to its plain PyTorch twin (exact: all outputs are
integers), and the 8 kb slice to the CPU plain path."""
import numpy as np
import pytest
import torch

from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import _lib
from supernova_tpu_torch.ops.kernels import compact as k2
from supernova_tpu_torch.ops.kernels import kmer_extract as k1
from supernova_tpu_torch.ops.kernels import run_reduce as k3
from supernova_tpu_torch.pipeline.run import Pipeline

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
