"""K4's plain twin, `lex_argsort_plain` (supernova_tpu_torch/ops/kernels/
sort.py), against the TPU kernel it replaces, `sort_bitonic_pallas`
(interpret mode), and `jax.lax.sort` on the CPU.  Exact: with every operand
a key, tied rows are identical, so the sorted columns are bit-identical;
with payloads, the stable sort is unique and equals lax.sort(is_stable=True)
column for column, while the unstable TPU kernel agrees on the keys and on
each key group's payload multiset.  Cases: keys >= 2^31, all-ones sentinel
rows, heavy ties, 1-4 keys, n not a power of two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from supernova_tpu.ops.pallas.sort import sort_bitonic_pallas
from supernova_tpu_torch.core import kmer_codec as kc
from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import sort as k4

SENT = 0xFFFFFFFF
# (n, num_keys, key_max): key_max 2^32 puts half the keys at >= 2^31
CASES = [
    (1000, 4, 2**32),
    (1537, 3, 2**32),
    (4096, 4, 64),
    (3000, 1, 8),
    (2500, 2, 300),
    (777, 4, 8),
]


def make_cols(seed, n, n_ops, num_keys, key_max):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, key_max if k < num_keys else 2**32, n, dtype=np.uint64).astype(np.uint32)
        for k in range(n_ops)
    ]


def port_perm(keys):
    return k4.lex_argsort_plain(*(torch.from_numpy(k.astype(np.int64)) for k in keys)).numpy()


def pallas_sort(cols, num_keys):
    out = sort_bitonic_pallas(*map(jnp.asarray, cols), num_keys=num_keys, tile_rows=8,
                              interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n,num_keys,key_max", CASES)
def test_all_keys_bit_identical_to_bitonic_pallas(n, num_keys, key_max):
    cols = make_cols(n, n, num_keys, num_keys, key_max)
    perm = port_perm(cols)
    assert sorted(perm.tolist()) == list(range(n))
    for k, (want, c) in enumerate(zip(pallas_sort(cols, num_keys), cols)):
        assert np.array_equal(want, c[perm]), f"key {k}"


@pytest.mark.parametrize("n,num_keys,key_max", CASES)
def test_payloads_equal_stable_lax_sort(n, num_keys, key_max):
    cols = make_cols(n + 1, n, num_keys + 2, num_keys, key_max)
    perm = port_perm(cols[:num_keys])
    ref = jax.lax.sort(tuple(map(jnp.asarray, cols)), num_keys=num_keys, is_stable=True)
    for k, (want, c) in enumerate(zip(ref, cols)):
        assert np.array_equal(np.asarray(want), c[perm]), f"operand {k}"


@pytest.mark.parametrize("n,num_keys,key_max", CASES[2:5])
def test_payload_multisets_match_bitonic_pallas(n, num_keys, key_max):
    cols = make_cols(n + 2, n, num_keys + 1, num_keys, key_max)
    perm = port_perm(cols[:num_keys])
    got = [c[perm] for c in cols]
    want = pallas_sort(cols, num_keys)
    for k in range(num_keys):
        assert np.array_equal(want[k], got[k]), f"key {k}"
    grp = np.unique(np.stack(got[:num_keys], 1), axis=0, return_inverse=True)[1].reshape(-1)
    p_want, p_got = want[num_keys], got[num_keys]
    assert np.array_equal(p_want[np.lexsort((p_want, grp))], p_got[np.lexsort((p_got, grp))])


def test_sentinel_rows_sort_last():
    """Real all-ones rows interleave with sentinel-like keys, as the
    count's padding rows do."""
    rng = np.random.default_rng(5)
    n = 1500
    cols = [np.full(n, SENT, np.uint32) for _ in range(4)]
    for c in cols[1:]:
        c[: n // 2] = rng.integers(0, 2**32, n // 2, dtype=np.uint64).astype(np.uint32)
    cols[0][:100] = 0
    perm = port_perm(cols)
    for k, want in enumerate(pallas_sort(cols, 4)):
        assert np.array_equal(want, cols[k][perm]), f"key {k}"
    assert (cols[0][perm][-n // 2:] == SENT).all()


def test_dispatch_on_cpu_takes_the_twin_and_counts_nothing():
    cols = make_cols(9, 2000, 5, 5, 40)
    keys = [torch.from_numpy(c.astype(np.int64)) for c in cols]
    kernels.reset_launch_counts()
    for nk in range(1, 6):
        assert torch.equal(kc.lex_argsort(*keys[:nk]), k4.lex_argsort_plain(*keys[:nk]))
    assert kernels.launch_counts()["sort"] == 0
    for bad in ((), tuple(keys) + (keys[0], keys[1])):
        with pytest.raises(ValueError, match="1..6 keys"):
            kc.lex_argsort(*bad)
    assert k4.lex_argsort_plain(torch.zeros(0, dtype=torch.int64)).shape == (0,)


def test_live_digits_are_the_digits_that_vary():
    """The AND/OR rule for skipping passes: from a key's AND and OR (as
    signed int32), exactly the digits taking two or more values are live.
    The card's histogram rule is held to it below."""
    rng = np.random.default_rng(13)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        vary = int(rng.integers(0, 2**32)) & int(rng.choice([0, 0xFF, 0xFF00FF00, 0x80000001, 0xFFFFFFFF]))
        keys = (int(rng.integers(0, 2**32)) ^ (rng.integers(0, 2**32, n, dtype=np.uint64) & vary)).astype(np.uint32)
        want = [d for d in range(4) if len(np.unique((keys >> (8 * d)) & 0xFF)) > 1]
        as_i32 = lambda x: int(np.uint32(x).view(np.int32))
        got = k4.live_digits(as_i32(np.bitwise_and.reduce(keys)), as_i32(np.bitwise_or.reduce(keys)))
        assert got == want


def as_i32(x):
    return int(np.uint32(x).view(np.int32))


@settings(max_examples=80, deadline=None)
@given(n=st.integers(1, 400), kind=st.sampled_from(["random", "ties", "constant_digits"]),
       seed=st.integers(0, 2**32 - 1))
def test_live_digits_from_hist_agree_with_and_or(n, kind, seed):
    """The card plans its passes from the digit histograms (one bin holding
    all n rows = a constant digit); on random, tied and constant-digit keys
    that picks the same digits as the AND/OR rule.  Histograms by
    torch.bincount on the CPU."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        keys = rng.integers(0, 2**32, n, dtype=np.uint64)
    elif kind == "ties":
        keys = rng.choice(rng.integers(0, 2**32, 3, dtype=np.uint64), n)
    else:
        keys = (rng.integers(0, 256, n, dtype=np.uint64) << np.uint64(8)) | np.uint64(0x80000000)
    t = torch.from_numpy(keys.astype(np.int64))
    hist = torch.stack([torch.bincount((t >> (8 * d)) & 0xFF, minlength=k4.RADIX)
                        for d in range(k4.DIGITS)])
    k32 = keys.astype(np.uint32)
    want = k4.live_digits(as_i32(np.bitwise_and.reduce(k32)), as_i32(np.bitwise_or.reduce(k32)))
    assert k4.live_digits_from_hist(hist, n) == want


def test_plan_passes_is_lsd_order():
    """Keys from the last to the first, each key's live digits from the
    least significant; keys with no live digit get no pass."""
    assert k4.plan_passes([[0, 3], [], [1, 2]]) == [(2, 1), (2, 2), (0, 0), (0, 3)]
    assert k4.plan_passes([[], []]) == []


def test_sort_by_words_equals_stable_lax_sort():
    """The codec's occurrence sort (3 words + attribute key, one payload)."""
    cols = make_cols(21, 3001, 5, 4, 2**32)
    cols[0] = cols[0] % 5  # shared leading words, ties into later keys
    cols[3] = cols[3] % 3
    t = [torch.from_numpy(c.astype(np.int64)) for c in cols]
    ws, (pk,), (pay,) = kc.sort_by_words(kc.W3(*t[:3]), extra_keys=(t[3],), payloads=(t[4],))
    ref = jax.lax.sort(tuple(map(jnp.asarray, cols)), num_keys=4, is_stable=True)
    for want, got in zip(ref, (*ws, pk, pay)):
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
