"""The port's sorted-segment helpers (supernova_tpu_torch/ops/segments.py)
and kmer_codec.first_base against the reference's on the CPU:
stable_compact (its tail zeroed, 1-D and 2-D columns), seg_sum, seg_max
(empty segments at the dtype's minimum), seg_min and
segment_ids_from_starts on the same numpy inputs.
The reference runs without x64, so its int64 results come back as int32:
values are compared, and the port keeps its inputs' dtypes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supernova_tpu.core import kmer_codec as rkc
from supernova_tpu.ops import segments as rseg
from supernova_tpu_torch.core import kmer_codec as pkc
from supernova_tpu_torch.ops import segments as pseg


@pytest.mark.parametrize("n,n_cols", [(0, 1), (5, 2), (257, 3), (1000, 6)])
def test_stable_compact_matches_reference(n, n_cols):
    rng = np.random.default_rng(n)
    valid = rng.random(n) < 0.4
    cols = [rng.integers(-2**31, 2**31, n) for _ in range(n_cols - 1)]
    cols.append(rng.integers(0, 2**31, (n, 2)).astype(np.int32))
    nv_r, want = rseg.stable_compact(jnp.asarray(valid), *map(jnp.asarray, cols))
    nv_p, got = pseg.stable_compact(torch.from_numpy(valid), *map(torch.from_numpy, cols))
    k = int(nv_r)
    assert int(nv_p) == k == int(valid.sum())
    for a, b, c in zip(got, want, cols):
        assert a.shape == c.shape and a.dtype == torch.from_numpy(c).dtype
        assert np.array_equal(a.numpy(), np.asarray(b).astype(c.dtype))
        assert not a[k:].any()  # the tail zeroed


def test_stable_compact_reference_case():
    """tests/test_segments.py's case."""
    valid = torch.tensor([False, True, False, True, True])
    a = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    w = torch.arange(10, dtype=torch.int64).view(5, 2)
    n, (a2, w2) = pseg.stable_compact(valid, a, w)
    assert int(n) == 3
    assert a2.tolist() == [11, 13, 14, 0, 0]
    assert w2.tolist() == [[2, 3], [6, 7], [8, 9], [0, 0], [0, 0]]


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_segment_reductions_match_reference(dtype):
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 40, 300))
    starts_r = rseg.run_starts(jnp.asarray(keys))
    ids_r = rseg.segment_ids_from_starts(starts_r)
    ids_p = pseg.segment_ids_from_starts(pseg.run_starts(torch.from_numpy(keys)))
    assert ids_p.dtype == torch.int32 and np.array_equal(ids_p.numpy(), np.asarray(ids_r))
    vals = rng.integers(-1000, 1000, 300).astype(dtype)
    n_seg = int(ids_p.max()) + 1
    info = np.finfo(dtype) if dtype == np.float32 else np.iinfo(dtype)
    low, high = (-np.inf, np.inf) if dtype == np.float32 else (info.min, info.max)
    for name, empty in (("seg_sum", 0), ("seg_max", low), ("seg_min", high)):
        if name == "seg_min" and dtype == np.float32:
            continue  # the port's seg_min takes integers (its one caller's)
        want = np.asarray(getattr(rseg, name)(jnp.asarray(vals), ids_r, n_seg + 4))
        got = getattr(pseg, name)(torch.from_numpy(vals), ids_p, n_seg + 4).numpy()
        assert got.dtype == vals.dtype and np.array_equal(got[:n_seg], want[:n_seg]), name
        # empty segments hold the identity of the port's dtype (the
        # reference's int32 one without x64)
        assert (got[n_seg:] == empty).all(), name
    ids = torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32)
    v = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    assert pseg.seg_sum(v, ids, 6).tolist() == [3, 12, 6, 0, 0, 0]
    assert pseg.seg_max(v, ids, 6).tolist() == [2, 5, 6] + [np.iinfo(np.int32).min] * 3


def test_first_base_matches_reference():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (200, rkc.K)).astype(np.uint8)
    words = np.stack([rkc.words_from_codes_np(c) for c in codes])
    want = np.asarray(rkc.first_base(rkc.np_to_soa(words)))
    got = pkc.first_base(pkc.np_to_soa(words, "cpu"))
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, codes[:, 0])
