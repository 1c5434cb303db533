"""Port parity: supernova_tpu_torch.core.kmer_codec / ops.segments /
core.device against the JAX reference (on the CPU), exact equality.

Inputs are made with numpy from a seed and handed to both packages; words
include values with the top bit set (the unsigned-compare hazard)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supernova_tpu.core import kmer_codec as rkc
from supernova_tpu.ops import segments as rseg
from supernova_tpu_torch.core import kmer_codec as kc
from supernova_tpu_torch.core.device import resolve_device
from supernova_tpu_torch.ops import segments as seg

TOP = np.array([0xFFFFFFFF, 0x80000000, 0xFFFFFFFE, 0x7FFFFFFF, 0, 1], np.uint32)


def rand_words(rng, n, pool=None):
    """(n,) x3 uint32 with top-bit words mixed in; `pool` limits the
    distinct values of the first word (forces ties)."""
    cols = []
    for j in range(3):
        hi = 2**32 if pool is None or j else pool
        x = rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
        if pool is not None and j == 0:
            x = np.where(x % 2 == 1, x | np.uint32(0x80000000), x)
        special = rng.random(n) < 0.1
        x[special] = rng.choice(TOP, int(special.sum()))
        cols.append(x)
    return cols


def rw(cols):
    return rkc.W3(*(jnp.asarray(c) for c in cols))


def pw(cols):
    return kc.W3(*(torch.from_numpy(c.astype(np.int64)) for c in cols))


def npw(w):
    return [np.asarray(x).astype(np.int64) for x in w]


def tpw(w):
    return [x.numpy() for x in w]


def eq_w3(ref, port):
    for a, b in zip(npw(ref), tpw(port)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 129, 1000])
def test_sliding_words(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n + 47 + 5).astype(np.int32)
    codes[:48] = 3  # first word all-T: top bit set
    eq_w3(rkc.sliding_words(jnp.asarray(codes), n), kc.sliding_words(torch.from_numpy(codes), n))


def test_rc_canonical_lex():
    rng = np.random.default_rng(1)
    x, y = rand_words(rng, 4000), rand_words(rng, 4000)
    x[0][:6], y[0][:6] = TOP, TOP[::-1]
    rx, ry, px, py = rw(x), rw(y), pw(x), pw(y)
    eq_w3(rkc.rc_words(rx), kc.rc_words(px))
    rc_, rf = rkc.canonicalize(rx)
    pc_, pf = kc.canonicalize(px)
    eq_w3(rc_, pc_)
    assert np.array_equal(np.asarray(rf), pf.numpy())
    assert np.array_equal(np.asarray(rkc.lex_lt(rx, ry)), kc.lex_lt(px, py).numpy())
    assert np.array_equal(np.asarray(rkc.lex_eq(rx, rx)), kc.lex_eq(px, px).numpy())
    s = [np.full(3, 0xFFFFFFFF, np.uint32)] * 3
    s[2] = np.array([0xFFFFFFFF, 0, 0xFFFFFFFF], np.uint32)
    assert kc.is_sentinel(pw(s)).tolist() == np.asarray(rkc.is_sentinel(rw(s))).tolist()


@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_successor_predecessor(base):
    rng = np.random.default_rng(10 + base)
    x = rand_words(rng, 3000)
    eq_w3(rkc.successor_words(rw(x), jnp.int32(base)), kc.successor_words(pw(x), base))
    eq_w3(rkc.predecessor_words(rw(x), jnp.int32(base)), kc.predecessor_words(pw(x), base))
    bt = torch.full((3000,), base, dtype=torch.int64)
    eq_w3(rkc.successor_words(rw(x), jnp.full(3000, base, jnp.int32)), kc.successor_words(pw(x), bt))


def test_last_base_unpack_and_np_helpers():
    rng = np.random.default_rng(2)
    x = rand_words(rng, 500)
    assert np.array_equal(np.asarray(rkc.last_base(rw(x))), kc.last_base(pw(x)).numpy())
    assert np.array_equal(np.asarray(rkc.unpack_bases(rw(x))), kc.unpack_bases(pw(x)).numpy())
    arr = np.stack(x, axis=-1)
    assert np.array_equal(kc.soa_to_np(kc.np_to_soa(arr, "cpu")), arr)
    assert kc.soa_to_np(kc.np_to_soa(arr, "cpu")).dtype == np.uint32
    codes = rng.integers(0, 4, 48).astype(np.uint8)
    w = kc.words_from_codes_np(codes)
    assert np.array_equal(w, rkc.words_from_codes_np(codes))
    assert np.array_equal(kc.codes_from_words_np(w), codes)


@pytest.mark.parametrize("n_extra", [0, 1, 2])
def test_sort_by_words(n_extra):
    rng = np.random.default_rng(3 + n_extra)
    n = 5000
    x = rand_words(rng, n, pool=64)
    x[1] = (x[1] % 3).astype(np.uint32) | np.uint32(0x80000000)  # ties on (a, b)
    x[2] = (x[2] % 5).astype(np.uint32)
    extra = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(n_extra)]
    pay = rng.integers(0, 2**31, n).astype(np.int32)
    rs, rex, (rp,) = rkc.sort_by_words(
        rw(x), tuple(map(jnp.asarray, extra)), (jnp.asarray(pay),), stable=True
    )
    ps, pex, (pp,) = kc.sort_by_words(
        pw(x), tuple(torch.from_numpy(e.astype(np.int64)) for e in extra),
        (torch.from_numpy(pay),),
    )
    eq_w3(rs, ps)
    for a, b in zip(rex, pex):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())
    assert np.array_equal(np.asarray(rp), pp.numpy())


def test_lex_argsort_orders_top_bit_keys_unsigned():
    rng = np.random.default_rng(4)
    keys = [rng.choice(TOP, 2000).astype(np.int64) for _ in range(3)]
    perm = kc.lex_argsort(*(torch.from_numpy(k) for k in keys)).numpy()
    assert np.array_equal(perm, np.lexsort(keys[::-1], axis=0))


def _table_and_queries(rng, m_real, m, nq):
    t = rand_words(rng, m_real)
    arr = np.unique(np.stack(t, axis=-1), axis=0)
    arr = arr[~(arr == 0xFFFFFFFF).all(axis=1)]
    pad = np.full((m - len(arr), 3), 0xFFFFFFFF, np.uint32)
    table = np.concatenate([arr, pad])
    hits = arr[rng.integers(0, len(arr), nq // 2)]
    miss = np.stack(rand_words(rng, nq - nq // 2), axis=-1)
    q = np.concatenate([hits, miss, np.full((3, 3), 0xFFFFFFFF, np.uint32)])
    q = q[rng.permutation(len(q))]
    return [table[:, j].copy() for j in range(3)], [q[:, j].copy() for j in range(3)]


def test_searchsorted_words():
    rng = np.random.default_rng(5)
    t, q = _table_and_queries(rng, 700, 1024, 900)
    ri, rf = rkc.searchsorted_words(rw(t), rw(q))
    pi, pf = kc.searchsorted_words(pw(t), pw(q))
    assert np.array_equal(np.asarray(ri), pi.numpy())
    assert np.array_equal(np.asarray(rf), pf.numpy())


def test_lookup_words_merge():
    rng = np.random.default_rng(6)
    t, q = _table_and_queries(rng, 900, 1024, 1500)
    rr, rf = rkc.lookup_words_merge(rw(t), rw(q))
    pr, pf = kc.lookup_words_merge(pw(t), pw(q))
    rf = np.asarray(rf)
    assert np.array_equal(rf, pf.numpy())
    assert np.array_equal(np.asarray(rr)[rf], pr.numpy()[rf])


def test_segments():
    rng = np.random.default_rng(7)
    n = 3000
    a = rng.integers(0, 40, n).astype(np.int32)
    b = np.sort(rng.integers(0, 9, (n, 2)), axis=0).astype(np.int32)
    st_r = np.asarray(rseg.run_starts(jnp.asarray(a), jnp.asarray(b)))
    st_p = seg.run_starts(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(st_r, st_p.numpy())
    assert np.array_equal(np.asarray(rseg.run_end_mask(jnp.asarray(st_r))), seg.run_end_mask(st_p).numpy())
    cs = np.cumsum(rng.integers(0, 5, n)).astype(np.int32)
    assert np.array_equal(
        np.asarray(rseg.run_broadcast_from_start(jnp.asarray(cs), jnp.asarray(st_r))),
        seg.run_broadcast_from_start(torch.from_numpy(cs), st_p).numpy(),
    )
    ids = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    assert np.array_equal(
        np.asarray(rseg.seg_min(jnp.asarray(vals), jnp.asarray(ids), 60)),
        seg.seg_min(torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int64)), 60).numpy(),
    )
    valid = rng.random(n) < 0.4
    m2 = rng.integers(0, 9, (n, 2)).astype(np.int32)
    rn, rres = rseg.stable_compact(jnp.asarray(valid), jnp.asarray(vals), jnp.asarray(m2))
    pn, pres = seg.stable_compact(torch.from_numpy(valid), torch.from_numpy(vals), torch.from_numpy(m2))
    assert int(rn) == int(pn)
    for r, p in zip(rres, pres):
        assert np.array_equal(np.asarray(r), p.numpy())


def test_compact_sorted_words_matches_reference():
    """Kept rows with distinct sorted words: the reference's sort path and
    the port's stable compaction give the same rows, tail zeroed."""
    rng = np.random.default_rng(8)
    n = 4000
    arr = np.stack(rand_words(rng, n, pool=1000), axis=-1)
    arr = arr[np.lexsort(arr.T[::-1])]
    ends = np.ones(n, bool)
    ends[:-1] = (arr[1:] != arr[:-1]).any(axis=1)
    keep = ends & (rng.random(n) < 0.5)
    pay = rng.integers(0, 2**31, n).astype(np.int32)
    cols = [arr[:, j].copy() for j in range(3)]
    rn, rres = rseg.compact_sorted_words(jnp.asarray(keep), *map(jnp.asarray, cols), jnp.asarray(pay))
    pn, pres = seg.compact_sorted_words(
        torch.from_numpy(keep), *(torch.from_numpy(c.astype(np.int64)) for c in cols),
        torch.from_numpy(pay),
    )
    assert int(rn) == int(pn)
    for r, p in zip(rres, pres):
        assert np.array_equal(np.asarray(r).astype(np.int64), p.numpy().astype(np.int64))


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
