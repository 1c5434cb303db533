"""K5's wrapper on CPU tensors (the plain twin): a running maximum of
torch.where(mask, values, fill), held to numpy; what it refuses; its
counters; and that no call site K5 took over still calls torch.cummax.
The kernel against its twin on the card: tests/test_torch_cuda.py."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from supernova_tpu_torch.ops import kernels
from supernova_tpu_torch.ops.kernels import scan_max as k5

TILE = 4096  # the kernel's elements a tile (csrc/scan_max.cu kTile)
PKG = Path(k5.__file__).resolve().parents[2]
ROUTED = ("kmer/count.py", "core/kmer_codec.py", "align/pather.py", "ops/segments.py",
          "parallel/device_nucleate.py", "parallel/sharded_nucleate.py",
          "parallel/sharded_scaffold.py")


def scan_input(n, dtype, has_values, has_mask, seed, extremes=False):
    """(values or None, mask or None, fill) as torch CPU tensors: values of
    both signs (or the dtype's extremes), ~30% of the mask set, a
    negative fill."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if extremes:
        v = rng.choice(np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max],
                                dtype=dtype), n)
        fill = int(info.min)
    else:
        v = rng.integers(-1_000_000, 1_000_000, n).astype(dtype)
        fill = -7
    values = torch.from_numpy(v) if has_values else None
    mask = torch.from_numpy(rng.random(n) < 0.3) if has_mask else None
    return values, mask, fill


def model(values, mask, fill, n):
    """numpy's running maximum of the same elements."""
    v = np.arange(n, dtype=np.int64) if values is None else values.numpy()
    x = v if mask is None else np.where(mask.numpy(), v, np.asarray(fill, v.dtype))
    return np.maximum.accumulate(x) if n else x


CASES = [(dt, hv, hm) for dt in (np.int32, np.int64) for hv in (True, False)
         for hm in (True, False) if hv or (dt == np.int64 and hm)]


@pytest.mark.parametrize("dtype,has_values,has_mask", CASES)
@pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 17])
def test_wrapper_on_cpu_matches_numpy_and_twin(n, dtype, has_values, has_mask):
    values, mask, fill = scan_input(n, dtype, has_values, has_mask, seed=n)
    got = k5.scan_max(values, mask, fill)
    assert got.dtype == (torch.int64 if values is None else values.dtype)
    assert got.shape == (n,) and got.is_contiguous()
    assert np.array_equal(got.numpy(), model(values, mask, fill, n))
    assert torch.equal(got, k5.scan_max_plain(values, mask, fill))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("has_mask", [True, False])
def test_wrapper_on_cpu_at_the_dtype_extremes(dtype, has_mask):
    n = 2 * TILE + 5
    values, mask, fill = scan_input(n, dtype, True, has_mask, seed=11, extremes=True)
    got = k5.scan_max(values, mask, fill)
    assert np.array_equal(got.numpy(), model(values, mask, fill, n))
    assert int(got[-1]) == int(np.iinfo(dtype).max)


def test_values_none_is_the_last_masked_index():
    mask = torch.zeros(10, dtype=torch.bool)
    mask[[2, 3, 7]] = True
    assert k5.scan_max(None, mask, -1).tolist() == [-1, -1, 2, 3, 3, 3, 3, 7, 7, 7]
    assert k5.scan_max(None, mask, 5).tolist() == [5, 5, 5, 5, 5, 5, 5, 7, 7, 7]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    v = torch.arange(12)
    m = torch.ones(12, dtype=torch.bool)
    with pytest.raises(ValueError):
        k5.scan_max(v.reshape(3, 4))
    with pytest.raises(ValueError):
        k5.scan_max(v[::2])
    with pytest.raises(TypeError):
        k5.scan_max(v.float())
    with pytest.raises(TypeError):
        k5.scan_max(v.to(torch.int16))
    with pytest.raises(ValueError):
        k5.scan_max(v, m[:5])
    with pytest.raises(ValueError):
        k5.scan_max(None, m.reshape(3, 4))
    with pytest.raises(TypeError):
        k5.scan_max(v, m.int())
    with pytest.raises(ValueError):
        k5.scan_max(v.int(), m, fill=1 << 40)
    with pytest.raises(ValueError):
        k5.scan_max(None, None)


def test_counters_hold_scan_max_and_cpu_calls_launch_nothing():
    kernels.reset_launch_counts()
    k5.scan_max(torch.arange(100), torch.ones(100, dtype=torch.bool), 0)
    c = kernels.counters()
    assert c["scan_max.launches"] == 0 and c["scan_max.bytes"] == 0
    assert kernels.WRAPPERS["scan_max"] is k5.scan_max
    assert kernels.byte_counts()["scan_max"] == 0


def test_launch_bytes():
    assert k5.launch_bytes(1000, 8, values=True, mask=True) == 1000 * 17
    assert k5.launch_bytes(1000, 8, values=False, mask=True) == 1000 * 9
    assert k5.launch_bytes(1000, 4, values=True, mask=False) == 1000 * 8


@pytest.mark.parametrize("rel", ROUTED)
def test_routed_sites_no_longer_call_torch_cummax(rel):
    src = (PKG / rel).read_text()
    assert not re.search(r"torch\.cummax\s*\(", src), rel
    assert "scan_max(" in src, rel
