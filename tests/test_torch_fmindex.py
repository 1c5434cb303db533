"""The port's FM-index (supernova_tpu_torch/align/fmindex.py) against the
reference's on the CPU: the suffix array by prefix doubling on K4's twin
equals the reference's np.lexsort doubling (random, repetitive and
several-edge texts); FMIndex.from_edges' five arrays equal the
reference's, from a list and from a Ragged; count/locate hold against
brute force; the batched backward search equals the reference's JAX
count_batch_device, ranges reaching the end of the BWT included."""
import numpy as np
import pytest
import torch

from supernova_tpu.align import fmindex as rfm
from supernova_tpu_torch.align import fmindex as pfm
from supernova_tpu_torch.core.ragged import Ragged

FIELDS = ("bwt", "sa", "less", "occ_ck", "edge_starts")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def brute_count(edges, pat):
    """tests/test_fmindex.py's brute force: (count, sorted (edge, offset))."""
    hits = []
    p = np.asarray(pat, np.uint8).tobytes()
    for e, seq in enumerate(edges):
        s = np.asarray(seq, np.uint8).tobytes()
        start = 0
        while (i := s.find(p, start)) >= 0:
            hits.append((e, i))
            start = i + 1
    return len(hits), sorted(hits)


def text(kind, n, rng):
    if kind == "random":
        body = rng.integers(0, 4, n, dtype=np.uint8)
    elif kind == "periodic":
        body = np.tile(np.array([0, 1, 1, 2, 3], np.uint8), n // 5 + 1)[:n]
    elif kind == "one symbol":
        body = np.zeros(n, np.uint8)
    else:  # several edges with separators, repeats between them
        seg = rng.integers(0, 4, 60, dtype=np.uint8)
        parts = []
        for i in range(max(n // 64, 1)):
            parts += [seg if i % 2 else rng.integers(0, 4, 60, dtype=np.uint8),
                      np.array([pfm.SEP] * 4, np.uint8)]
        body = np.concatenate(parts)
    return np.concatenate([body, np.array([pfm.TERM], np.uint8)])


@pytest.mark.parametrize("kind", ["random", "periodic", "one symbol", "edges"])
@pytest.mark.parametrize("n", [1, 63, 640, 3001])
def test_suffix_array_matches_reference(kind, n):
    t = text(kind, n, np.random.default_rng(n))
    info = {}
    got = pfm.suffix_array(t, "cpu", info=info)
    want = rfm.suffix_array(t)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    assert info["rounds"] >= 1
    if n == 640:
        suf = [t[i:].tobytes() for i in got]
        assert suf == sorted(suf)


def random_edges(seed, n_edges=12, lo=60, hi=300):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, int(rng.integers(lo, hi)), dtype=np.uint8) for _ in range(n_edges)]


@pytest.mark.parametrize("ragged", [False, True])
def test_from_edges_matches_reference(ragged):
    edges = random_edges(3)
    edges[4] = edges[1][10:90].copy()  # a repeat across edges
    edges[7] = np.zeros(0, np.uint8)  # an empty edge
    want = rfm.FMIndex.from_edges(edges)
    src = Ragged.from_rows(edges, dtype=np.uint8) if ragged else edges
    got = pfm.FMIndex.from_edges(src, device="cpu")
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for name in ("SEP", "TERM", "SIGMA", "CHECK"):
        assert getattr(pfm, name) == getattr(rfm, name)


def test_count_locate_vs_brute():
    rng = np.random.default_rng(0)
    edges = random_edges(0)
    fm = pfm.FMIndex.from_edges(edges, device="cpu")
    for length in (3, 8, 20):
        for _ in range(25):
            e = edges[int(rng.integers(len(edges)))]
            s = int(rng.integers(0, len(e) - length))
            pat = e[s : s + length]
            want_n, want_hits = brute_count(edges, pat)
            assert fm.count(pat) == want_n
            assert sorted(tuple(x) for x in fm.locate(pat)) == want_hits
    miss = rng.integers(0, 4, 40, dtype=np.uint8)
    assert fm.count(miss) == brute_count(edges, miss)[0]


@pytest.mark.parametrize("total", [64 * 20 - 9, 64 * 20 - 8, 64 * 21 - 8])
def test_count_batch_matches_reference(total):
    """Text lengths n with n % CHECK != 0 and == 0 (8 edges: total + 8
    separators + the terminator): every first step ranks hi = n, whose
    window starts at n's checkpoint and reads past the BWT's end."""
    rng = np.random.default_rng(total)
    cuts = np.sort(rng.choice(np.arange(1, total), 7, replace=False))
    edges = np.split(rng.integers(0, 4, total, dtype=np.uint8), cuts)
    fm = pfm.FMIndex.from_edges(edges, device="cpu")
    assert len(fm.bwt) == total + 9
    ref = rfm.FMIndex.from_edges(edges)
    length, pats, lens = 24, [], []
    for i in range(120):
        e = edges[i % len(edges)]
        n = int(rng.integers(0, min(length, len(e)) + 1))
        s = int(rng.integers(0, len(e) - n + 1))
        p = np.zeros(length, np.uint8)
        p[:n] = e[s : s + n]
        if i % 5 == 0:
            p[:n] = rng.integers(0, 4, n)  # mostly absent
        pats.append(p)
        lens.append(n)
    pats, lens = np.stack(pats), np.asarray(lens, np.int32)
    got = fm.count_batch_device(pats, lens, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    want = np.asarray(ref.count_batch_device(pats, lens))
    assert np.array_equal(got.numpy(), want)
    brute = [brute_count(edges, p[:n])[0] if n else len(fm.bwt) for p, n in zip(pats, lens)]
    assert got.tolist() == brute
