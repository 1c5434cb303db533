"""Port parity for the three kernels' plain twins against the JAX package's
Pallas kernels in interpret mode (on the CPU), exact equality; plus the
wrappers' CPU behaviour.  The CUDA kernels against their twins on the card:
tests/test_torch_cuda.py.

K3's `count` is compared at run-end rows only: the TPU kernel leaves a
running partial at other rows that nothing downstream reads, while the
port's contract is zero there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supernova_tpu.kmer.count import pack_occurrence_attrs as ref_pack
from supernova_tpu.ops.pallas.compact import compact_stream_pallas
from supernova_tpu.ops.pallas.kmer_extract import sliding_words_pallas
from supernova_tpu.ops.pallas.run_reduce import BLOCK_ROWS, LANES, run_reduce_pallas
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import compact as k2
from supernova_tpu_torch.ops.kernels import kmer_extract as k1
from supernova_tpu_torch.ops.kernels import run_reduce as k3

PALLAS_BLOCK = BLOCK_ROWS * LANES  # 32768 rows per Pallas grid step
SENT = 0xFFFFFFFF


def sorted_stream(rng, n, n_kmers, long_run=None, top_bit=False):
    """Sorted (w0, w1, w2, pk) occurrence stream as uint32 numpy columns.
    long_run=(lo, hi) makes one run span those rows (crossing Pallas block
    edges); top_bit sets the top bit of w0/w1 in every real kmer."""
    ids = np.sort(rng.integers(0, n_kmers, n))
    if long_run is not None:
        ids[long_run[0] : long_run[1]] = ids[long_run[0]]
        ids = np.sort(ids)
    w0 = (ids // 1000).astype(np.uint32)
    w1 = (ids % 1000).astype(np.uint32)
    w2 = (ids * 7 % 911).astype(np.uint32)
    if top_bit:
        w0 |= np.uint32(0x80000000)
        w1 |= np.uint32(0xC0000000)
    valid = rng.random(n) < 0.9
    bc = rng.integers(1, 50, n).astype(np.int32)
    bc[rng.random(n) < 0.2] = -1
    lm = rng.integers(0, 16, n).astype(np.uint32)
    rm = rng.integers(0, 16, n).astype(np.uint32)
    pk = np.asarray(ref_pack(*map(jnp.asarray, (bc, lm, rm, valid))))
    # invalid rows carry sentinel words (extract_occurrences' invariant)
    w0, w1, w2 = (np.where(valid, w, np.uint32(SENT)) for w in (w0, w1, w2))
    order = np.lexsort((pk, w2, w1, w0))
    return [x[order] for x in (w0, w1, w2, pk)]


def t64(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("n", [128, 128 * 300])
def test_k1_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n + 128, dtype=np.int32)
    codes[:64] = 3  # top bit set in the first words
    ref = sliding_words_pallas(codes, n, interpret=True)
    got = k1.sliding_words(torch.from_numpy(codes), n)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r).astype(np.int64), g.numpy())


@pytest.mark.parametrize(
    "n,n_kmers,long_run,top_bit,min_freq,min_bc",
    [
        (70_000, 2_000, (PALLAS_BLOCK - 500, PALLAS_BLOCK + 9_000), False, 3, 2),
        (70_000, 5_000, None, True, 3, 2),
        (40_000, 800, (1_000, 36_000), False, 1, 0),
    ],
)
def test_k3_plain_matches_pallas(n, n_kmers, long_run, top_bit, min_freq, min_bc):
    rng = np.random.default_rng(n_kmers)
    cols = sorted_stream(rng, n, n_kmers, long_run, top_bit)
    rk, rc, rs = (np.asarray(x) for x in run_reduce_pallas(
        *map(jnp.asarray, cols), min_freq, min_bc, interpret=True))
    pk_, pc, ps = k3.run_reduce(*map(t64, cols), min_freq, min_bc)
    assert np.array_equal(rk == 1, pk_.numpy())
    assert np.array_equal(rs.astype(np.int64), ps.numpy().astype(np.int64))
    w = np.stack(cols[:3], axis=-1)
    ends = np.r_[(w[1:] != w[:-1]).any(axis=1), ~(w[-1] == SENT).all()]
    assert ends.sum() > 50
    assert np.array_equal(rc[ends], pc.numpy()[ends])
    assert not pc.numpy()[~ends].any() and not ps.numpy()[~ends].any()


def test_k3_plain_matches_bruteforce_model():
    """The plain twin against a per-run python model of the reduce rules."""
    rng = np.random.default_rng(11)
    cols = sorted_stream(rng, 3_000, 150)
    keep, count, stats = (x.numpy() for x in k3.run_reduce(*map(t64, cols), 3, 2))
    w0, w1, w2, pk = (c.astype(np.int64) for c in cols)
    i = 0
    while i < len(w0):
        j = i
        while j < len(w0) and (w0[j], w1[j], w2[j]) == (w0[i], w1[i], w2[i]):
            j += 1
        v = ((pk[i:j] >> 1) & 1) == 1
        f = pk[i:j] >> 10
        c = int(v.sum())
        nbc = len(set(f[v & (f > 0) & (f != 0x3FFFFF)].tolist()))
        ign = bool((v & (f == 0x3FFFFF)).any())
        lm = int(np.bitwise_or.reduce((pk[i:j][v] >> 6) & 15, initial=0))
        rm = int(np.bitwise_or.reduce((pk[i:j][v] >> 2) & 15, initial=0))
        e = j - 1
        if w0[i] != SENT:
            assert count[e] == c
            assert stats[e] == (min(nbc, 4095) << 9) | (lm << 5) | (rm << 1) | ign
            assert keep[e] == (c >= 3 and (ign or nbc >= 2))
        i = j


@pytest.mark.parametrize("n,frac", [(70_000, 0.5), (40_000, 0.03), (32_768, 1.0)])
def test_k2_plain_matches_pallas_with_duplicate_words(n, frac):
    rng = np.random.default_rng(int(frac * 100) + n)
    keep = rng.random(n) < frac
    wa = np.sort(rng.integers(0, 50, n)).astype(np.uint32) | np.uint32(0x80000000)
    wb = np.zeros(n, np.uint32)  # many kept rows share identical words
    pay = rng.integers(-5, 2**30, n).astype(np.int32)
    rn, rres = compact_stream_pallas(
        jnp.asarray(keep), jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(pay), interpret=True
    )
    pn, pres = k2.compact(
        torch.from_numpy(keep), t64(wa), t64(wb), torch.from_numpy(pay)
    )
    k = int(rn)
    assert k == int(pn) == keep.sum()
    for r, p in zip(rres, pres):
        assert np.array_equal(np.asarray(r)[:k].astype(np.int64), p.numpy()[:k].astype(np.int64))
        assert not p.numpy()[k:].any()


def test_cpu_wrappers_never_launch():
    """On CPU tensors every wrapper takes its plain twin; the launch
    counters stay 0."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 4, 400).astype(np.int32))
    k1.sliding_words(codes, 300)
    cols = [t64(c) for c in sorted_stream(rng, 500, 40)]
    keep, count, stats = k3.run_reduce(*cols, 3, 2)
    k2.compact(keep, *cols[:3], count, stats)
    kernels.WRAPPERS["sort"](*cols)
    assert kernels.launch_counts() == {"kmer_extract": 0, "compact": 0, "run_reduce": 0, "sort": 0}
