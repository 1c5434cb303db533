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
from supernova_tpu_torch.ops.kernels import scan_max as k5
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


def k4_tile():
    return _lib.library().sn_radix_tile_rows()


def k3_tile():
    return _lib.library().sn_run_reduce_tile_rows()


@pytest.mark.parametrize("kind", ["random", "ties", "constant_digits", "all_equal"])
@pytest.mark.parametrize("n", [0, 1, 1000, "tile-1", "tile", "tile+1", (1 << 20) + 7])
def test_sort_matches_plain(dev, n, kind):
    """K4 equals its twin exactly (the stable permutation is unique) for
    1-6 keys, at the edges of the kernel's tile included."""
    if isinstance(n, str):
        n = k4_tile() + {"tile-1": -1, "tile": 0, "tile+1": 1}[n]
    rng = np.random.default_rng(n)
    for n_keys in range(1, k4.MAX_KEYS + 1):
        keys = sort_keys(rng, n, n_keys, kind, dev)
        got = k4.lex_argsort(*keys)
        assert got.dtype == torch.int64 and got.device.type == "cuda"
        assert torch.equal(got, k4.lex_argsort_plain(*keys)), (n_keys, kind)


@pytest.mark.parametrize("kind", ["random", "ties", "constant_digits"])
def test_sort_matches_plain_thousands_of_tiles(dev, kind):
    """n = 2^24 + 3: thousands of onesweep tiles look back over each other."""
    n = (1 << 24) + 3
    rng = np.random.default_rng(24)
    for n_keys in (1, 2, 4):
        keys = sort_keys(rng, n, n_keys, kind, dev)
        assert torch.equal(k4.lex_argsort(*keys), k4.lex_argsort_plain(*keys)), (n_keys, kind)


def largest_count_block(dev) -> int:
    """The largest block the count's budget gives this card: its whole
    memory free (count_block_positions)."""
    total = torch.cuda.get_device_properties(dev).total_memory
    return kcount.count_block_positions(dev, free_bytes=total)


def test_kmer_extract_at_the_largest_count_block(dev):
    """K1 over the positions of the largest block the card's budget plans:
    64-bit positions and a grid of millions of blocks, equal to its twin."""
    torch.cuda.empty_cache()
    n = largest_count_block(dev)
    g = torch.Generator(device=dev).manual_seed(31)
    codes = torch.randint(0, 4, (n + 128,), dtype=torch.int32, device=dev, generator=g)
    for a, b in zip(k1.sliding_words_cuda(codes, n), k1.sliding_words_plain(codes, n)):
        assert a.shape == (n,) and torch.equal(a, b)


def test_sort_at_the_largest_count_block(dev):
    """K4, whose rows carry 32-bit indices (n < 2^31), at the sort rows of
    the largest block the card's budget plans (a mixed block sorts every
    position) by 4 keys: the permutation equals its twin's exactly.  The
    budget is capped below 2^31 (kcount.MAX_BLOCK_POSITIONS)."""
    torch.cuda.empty_cache()
    n = largest_count_block(dev)
    assert n <= kcount.MAX_BLOCK_POSITIONS < 1 << 31 and n > kcount.BLOCK_POSITIONS
    g = torch.Generator(device=dev).manual_seed(32)
    keys = [torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device=dev, generator=g)
            for _ in range(3)]
    keys.append(torch.randint(0, 8, (n,), dtype=torch.int64, device=dev, generator=g))
    got = k4.lex_argsort_cuda(*keys)
    torch.cuda.empty_cache()
    assert torch.equal(got, k4.lex_argsort_plain(*keys))


def test_sorts_back_to_back(dev):
    """Sorts of different n one after another: a look-back status word or a
    tile counter left over from the previous sort would misplace rows."""
    rng = np.random.default_rng(5)
    t = k4_tile()
    for n in ((1 << 22) + 11, 3 * t + 5, (1 << 21) - 1, t * 40):
        keys = sort_keys(rng, n, 3, "random", dev)
        got = k4.lex_argsort(*keys)
        assert torch.equal(got, k4.lex_argsort_plain(*keys)), n


def stream_with_runs(rng, lengths, sentinel_rows, dev):
    """Sorted (w0, w1, w2, pk) stream whose runs have the given lengths,
    then `sentinel_rows` rows on the all-ones words."""
    ids = np.repeat(np.arange(len(lengths)), lengths)
    n = len(ids) + sentinel_rows
    valid = rng.random(n) < 0.9
    bc = rng.integers(1, 50, n)
    bc[rng.random(n) < 0.2] = 0x3FFFFF
    pk = (bc << 10) | (rng.integers(0, 16, n) << 6) | (rng.integers(0, 16, n) << 2) | (valid.astype(np.int64) << 1)
    w0 = np.r_[(ids // 1000).astype(np.int64) | 0x80000000, np.full(sentinel_rows, SENT)]
    w1 = np.r_[(ids % 1000).astype(np.int64), np.full(sentinel_rows, SENT)]
    w2 = np.r_[(ids * 7 % 911).astype(np.int64), np.full(sentinel_rows, SENT)]
    order = np.lexsort((pk, np.r_[ids, np.full(sentinel_rows, len(lengths))]))
    return [torch.from_numpy(np.ascontiguousarray(x[order])).to(dev) for x in (w0, w1, w2, pk)]


def small_runs(rng, count):
    return list(rng.integers(1, 60, count))


@pytest.mark.parametrize("case", [
    # (run lengths, sentinel rows) from the kernel's tile t
    pytest.param(lambda t, rng: ([t - 1, t, t + 1] * 3, 0), id="tile_edges"),
    pytest.param(lambda t, rng: ([5, t - 1, 7, t, 1, t + 1, 3], 5), id="tile_edges_offset"),
    pytest.param(lambda t, rng: ([5 * t + 17], 0), id="one_run"),
    pytest.param(lambda t, rng: ([5 * t + 17], 2 * t + 5), id="one_run_sentinel_tail"),
    pytest.param(lambda t, rng: ([0], 3 * t + 1), id="sentinel_only"),
    pytest.param(lambda t, rng: (
        [1_000_000] + small_runs(rng, 500) + [999_999, 1_000_001] + small_runs(rng, 300),
        2 * t + 5), id="runs_of_1M"),
])
def test_run_reduce_runs_match_plain(dev, case):
    """K3's segmented reduction: runs of one tile and one row either side,
    a run spanning the whole input, runs of a million rows (a carry over
    ~490 tiles), sentinel-only tails; exactly its twin's outputs."""
    rng = np.random.default_rng(33)
    lengths, sentinel_rows = case(k3_tile(), rng)
    cols = stream_with_runs(rng, [x for x in lengths if x], sentinel_rows, dev)
    for mf, mb in ((3, 2), (1, 0)):
        for a, b in zip(k3.run_reduce_cuda(*cols, mf, mb), k3.run_reduce_plain(*cols, mf, mb)):
            assert torch.equal(a, b)


def k2_tile():
    return _lib.library().sn_compact_tile_rows()


def compact_input(n, frac, ncols, dev, seed, offset=0):
    """A keep mask of density `frac` (a view `offset` bytes into its
    buffer) and `ncols` columns, int64 (full 64-bit values) and int32 in
    turn, drawn on the card; and one fill value a column."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = (torch.rand(n + offset, device=dev, generator=g) < frac)[offset:]
    cols, fills = [], []
    for j in range(ncols):
        dt = torch.int64 if j % 2 == 0 else torch.int32
        info = torch.iinfo(dt)
        cols.append(torch.randint(info.min, info.max, (n,), dtype=dt, device=dev, generator=g))
        fills.append(SENT if dt == torch.int64 else -1 - j)
    return keep, cols, fills


def assert_compact_matches_plain(keep, cols, fills):
    """K2 equals its twin: n_valid and the kept rows always, the tail too
    when fill values are given."""
    nv_a, out_a = k2.compact(keep, *cols, fills=fills)
    nv_b, out_b = k2.compact_plain(keep, *cols, fills=fills)
    k = int(nv_b)
    assert int(nv_a) == k
    for a, b in zip(out_a, out_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) if fills is not None else torch.equal(a[:k], b[:k])


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.25, 1.0])
@pytest.mark.parametrize("n", [0, 1, "tile-1", "tile", "tile+1", (1 << 24) + 3])
def test_compact_matches_plain(dev, n, frac):
    """K2 at the edges of its tile and over thousands of tiles, 1 and 8
    columns of mixed int32/int64, with and without fill values."""
    if isinstance(n, str):
        n = k2_tile() + {"tile-1": -1, "tile": 0, "tile+1": 1}[n]
    for ncols in (1, 8):
        keep, cols, fills = compact_input(n, frac, ncols, dev, seed=n + ncols)
        for f in (None, fills):
            assert_compact_matches_plain(keep, cols, f)


@pytest.mark.parametrize("n", ["3tiles+5", (1 << 20) + 7])
def test_compact_unaligned_mask(dev, n):
    """A mask view 1 byte into its buffer (no 16-byte vector loads)."""
    if isinstance(n, str):
        n = 3 * k2_tile() + 5
    keep, cols, fills = compact_input(n, 0.3, 5, dev, seed=n, offset=1)
    assert keep.data_ptr() % 16 != 0
    for f in (None, fills):
        assert_compact_matches_plain(keep, cols, f)


def test_compacts_back_to_back(dev):
    """Compactions of different n one after another on one stream: a
    status word or tile counter left from the previous call would misplace
    rows."""
    t = k2_tile()
    for i, n in enumerate(((1 << 22) + 11, 3 * t + 5, (1 << 21) - 1, t * 40, 7)):
        keep, cols, fills = compact_input(n, (0.03, 0.5)[i % 2], 3, dev, seed=i)
        assert_compact_matches_plain(keep, cols, fills)


def k5_tile():
    return _lib.library().sn_scan_max_tile_elems()


def scan_input(n, dtype, has_values, has_mask, dev, seed, extremes=False, offset=0):
    """(values or None, mask or None, fill) drawn on the card: values of
    both signs and a negative fill, or only the dtype's extremes and their
    neighbours and the dtype's minimum as the fill; ~30% of the mask set.
    With `offset`, values and mask are views that many elements into their
    buffers."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.iinfo(dtype)
    m = n + offset
    if extremes:
        pool = torch.tensor([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max],
                            dtype=dtype, device=dev)
        v, fill = pool[torch.randint(0, 7, (m,), device=dev, generator=g)], info.min
    else:
        v, fill = torch.randint(-(1 << 30), 1 << 30, (m,), dtype=dtype, device=dev,
                                generator=g), -7
    mask = torch.rand(m, device=dev, generator=g) < 0.3
    return (v[offset:] if has_values else None), (mask[offset:] if has_mask else None), fill


def assert_scan_matches_cummax(values, mask, fill, n, dev):
    """K5 equals torch.cummax(torch.where(mask, values, fill), 0).values,
    element for element."""
    got = k5.scan_max(values, mask, fill)
    v = torch.arange(n, device=dev) if values is None else values
    want = torch.cummax(v if mask is None else torch.where(mask, v, fill), 0).values
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


K5_CASES = [(torch.int32, True, True), (torch.int32, True, False), (torch.int64, True, True),
            (torch.int64, True, False), (torch.int64, False, True)]


@pytest.mark.parametrize("dtype,has_values,has_mask", K5_CASES)
@pytest.mark.parametrize("n", [0, 1, "tile-1", "tile", "tile+1", (1 << 22) + 5, (1 << 26) + 3])
def test_scan_max_matches_cummax(dev, n, dtype, has_values, has_mask):
    """K5 at the edges of its tile and over thousands of tiles, int32 and
    int64, with values or each element's index, with and without a mask."""
    if isinstance(n, str):
        n = k5_tile() + {"tile-1": -1, "tile": 0, "tile+1": 1}[n]
    values, mask, fill = scan_input(n, dtype, has_values, has_mask, dev, seed=n)
    assert_scan_matches_cummax(values, mask, fill, n, dev)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("has_mask", [True, False])
def test_scan_max_at_the_dtype_extremes(dev, dtype, has_mask):
    n = 37 * k5_tile() + 11
    values, mask, fill = scan_input(n, dtype, True, has_mask, dev, seed=5, extremes=True)
    assert_scan_matches_cummax(values, mask, fill, n, dev)


@pytest.mark.parametrize("offset", [1, 3])
def test_scan_max_unaligned_views(dev, offset):
    """Values and mask as views at an odd element offset (no 16-byte
    vector loads)."""
    n = 3 * k5_tile() + 5
    for dtype in (torch.int32, torch.int64):
        values, mask, fill = scan_input(n, dtype, True, True, dev, seed=offset, offset=offset)
        assert values.data_ptr() % 16 != 0 and mask.data_ptr() % 2 != 0
        assert_scan_matches_cummax(values, mask, fill, n, dev)
        assert_scan_matches_cummax(None, mask, fill, n, dev)


def test_scans_back_to_back(dev):
    """Scans of different n one after another on one stream: a flag or
    tile counter left from the previous call would give a wrong prefix."""
    t = k5_tile()
    for i, n in enumerate(((1 << 22) + 11, 3 * t + 5, (1 << 21) - 1, t * 40, 7)):
        values, mask, fill = scan_input(n, torch.int64, i % 2 == 0, True, dev, seed=i)
        assert_scan_matches_cummax(values, mask, fill, n, dev)


def test_scan_max_past_2_31_elements(dev):
    """More than 2^31 elements (64-bit offsets), int32 values with a mask
    and int64 indices with a mask, checked in chunks against torch.cummax
    carried from chunk to chunk."""
    n = (1 << 31) + k5_tile() + 3
    free = torch.cuda.mem_get_info(dev)[0]
    # the larger case: a mask byte and an int64 result an element, and a chunk's scratch
    if free < n * 9 + (4 << 30):
        n = (free - (4 << 30)) // 9 // k5_tile() * k5_tile() + 3  # the most tiles it holds
    g = torch.Generator(device=dev).manual_seed(9)
    mask = torch.randint(0, 10, (n,), dtype=torch.uint8, device=dev, generator=g) < 3
    chunk = 1 << 27
    for values in (None, "int32"):
        if values is not None:
            values = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32, device=dev,
                                   generator=g)
        got = k5.scan_max(values, mask, -5)
        carry = None
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            v = torch.arange(s, e, device=dev) if values is None else values[s:e]
            want = torch.cummax(torch.where(mask[s:e], v, -5), 0).values
            if carry is not None:
                want = torch.maximum(want, carry)
            assert torch.equal(got[s:e], want), (s, e)
            carry = want[-1]
        del got, values
        torch.cuda.empty_cache()


def test_scan_max_counts_launches_and_bytes(dev):
    n = 100_003
    v = torch.arange(n, dtype=torch.int32, device=dev)
    m = torch.ones(n, dtype=torch.bool, device=dev)
    for values, mask, esize in ((v, m, 4), (None, m, 8), (v, None, 4), (v.long(), m, 8)):
        c0 = kernels.counters()
        k5.scan_max(values, mask, 0)
        c1 = kernels.counters()
        assert c1["scan_max.launches"] - c0["scan_max.launches"] == 1
        assert c1["scan_max.bytes"] - c0["scan_max.bytes"] == k5.launch_bytes(
            n, esize, values is not None, mask is not None)


def test_scan_max_rejects_bad_input(dev):
    v = torch.arange(12, device=dev)
    m = torch.ones(12, dtype=torch.bool, device=dev)
    for args in ((v.reshape(3, 4),), (v[::2],), (v, m[:5]), (None, m.reshape(3, 4)), (v, m.cpu()),
                 (v.int(), m, 1 << 40)):
        with pytest.raises(ValueError):
            k5.scan_max(*args)
    for args in ((v.float(),), (v.to(torch.int16),), (v, m.int())):
        with pytest.raises(TypeError):
            k5.scan_max(*args)


def test_hot_sites_through_k5_equal_the_twin(dev, monkeypatch):
    """extract_occurrences, lookup_words_merge and the pather's
    _compact_and_place (through path_readset) give the same tensors through
    K5 as through its plain twin, on the same inputs on the card."""
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.core import kmer_codec as kc
    from supernova_tpu_torch.dbg import build, graph
    from supernova_tpu_torch.pipeline import datasets

    rs = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    table = kcount.count_readset(rs, dev)
    bg = graph.from_device(build.build_graph(table), table)
    inp = kcount.prepare_reads(rs, dev)
    occ_args = tuple(inp[a] for a in ("codes_ext", "pos_read", "glen_pos", "bc_pos"))
    g = torch.Generator(device=dev).manual_seed(3)
    m = table.words.a.shape[0]
    pick = torch.randint(0, m, (50_000,), device=dev, generator=g)
    query = kc.W3(*(torch.where(pick % 3 == 0, w[pick] ^ 1, w[pick]) for w in table.words))

    def outputs():
        occ = kcount.extract_occurrences(*occ_args)
        return [*occ[0], *occ[1:], *kc.lookup_words_merge(table.words, query),
                *pather.path_readset(bg, rs, dev)]

    l0 = k5.scan_max.launches
    got = outputs()
    assert k5.scan_max.launches > l0
    for mod in (kcount, kc, pather):
        monkeypatch.setattr(mod, "scan_max", k5.scan_max_plain)
    l0 = k5.scan_max.launches
    want = outputs()
    assert k5.scan_max.launches == l0
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


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
    with pytest.raises(ValueError):
        k2.compact(torch.ones(10, dtype=torch.bool, device=dev), w, fills=(SENT,))
    with pytest.raises(ValueError):
        k2.compact(torch.ones(10, dtype=torch.bool, device=dev), w, w, fills=(0,))


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
    tg, _, rg = Pipeline(tmp_path / "cuda", device="cuda").run_slice(rs)
    assert all(c > 0 for c in kernels.launch_counts().values())
    tc, _, rc = Pipeline(tmp_path / "cpu", device="cpu").run_slice(rs)
    a, b = convert.table_to_numpy(tg), convert.table_to_numpy(tc)
    assert a.n_valid == b.n_valid
    for x, y in zip((*a.words, *a[1:5]), (*b.words, *b[1:5])):
        assert np.array_equal(x, y)
    zg, zc = np.load(tmp_path / "cuda" / "graph.npz"), np.load(tmp_path / "cpu" / "graph.npz")
    for k in zc.files:
        assert np.array_equal(zg[k], zc[k]), k
    for x, y in zip(convert.readpaths_to_numpy(rg), convert.readpaths_to_numpy(rc)):
        assert np.array_equal(x[: rs.n_reads], y[: rs.n_reads])


def blocked_readset():
    """~360 kb of 150 bp reads over 30 barcodes: >= 3 count blocks of 100 kb."""
    rng = np.random.default_rng(3)
    g = sim.random_genome(rng, 6000, n_repeat_chunks=2, repeat_len=150)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 128)
    return ingest_sim(sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=30, molecules_per_barcode=2,
        molecule_len=3000, coverage_per_molecule=2.0, error_rate=0.002,
        bc_error_rate=0.02,
    ), wl)


def pin_blocks(monkeypatch, positions):
    """The count's and the pather's block budgets at `positions` on every
    device (the card's own budget would take the readset in one block)."""
    from supernova_tpu_torch.align import pather

    monkeypatch.setattr(kcount, "count_block_positions", lambda device, free_bytes=None: positions)
    monkeypatch.setattr(pather, "path_block_positions",
                        lambda device, bg, free_bytes=None: positions)


def test_blocked_slice_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """~360 kb of reads cut into >= 3 count blocks: the blocked count, the
    device merge and the blocked pather on CUDA give the CPU's kmers.npz,
    graph.npz and ReadPaths, with every kernel launched."""
    rs = blocked_readset()
    pin_blocks(monkeypatch, 100_000)
    kernels.reset_launch_counts()
    pg = Pipeline(tmp_path / "cuda", device="cuda")
    _, _, rg = pg.run_slice(rs)
    assert all(c > 0 for c in kernels.launch_counts().values())
    assert pg.stage_records["count"]["blocks"] >= 3
    _, _, rc = Pipeline(tmp_path / "cpu", device="cpu").run_slice(rs)
    for name in ("kmers.npz", "graph.npz"):
        zg, zc = np.load(tmp_path / "cuda" / name), np.load(tmp_path / "cpu" / name)
        for k in zc.files:
            assert np.array_equal(zg[k], zc[k]), (name, k)
    for x, y in zip(convert.readpaths_to_numpy(rg), convert.readpaths_to_numpy(rc)):
        assert np.array_equal(x, y)


def test_partitioned_count_cuda_equals_cpu(dev, tmp_path):
    """The blocked count with its merge cut into >= 3 partitions on the card
    and its blocks spilled equals the CPU's table bit for bit; the same call
    then resumes every block from the spills and recounts none."""
    rs = blocked_readset()
    info = {}
    want = convert.table_to_numpy(
        kcount.count_readset_blocked(rs, "cpu", max_positions=100_000, info=info))
    merge_rows = info["raw_rows"] // 3
    for resumed in (False, True):
        info = {}
        kernels.reset_launch_counts()
        got = convert.table_to_numpy(kcount.count_readset_blocked(
            rs, "cuda", max_positions=100_000, merge_rows=merge_rows,
            spill_dir=tmp_path / "spill", info=info))
        launches = kernels.launch_counts()
        assert info["partitions"] >= 3 and info["blocks"] >= 3
        assert info["resumed_blocks"] == (info["blocks"] if resumed else 0)
        assert info["spilled_blocks"] == (0 if resumed else info["blocks"])
        assert launches["sort"] > 0 and launches["compact"] >= info["partitions"]
        assert (launches["kmer_extract"] == 0) == resumed
        assert want.n_valid == got.n_valid
        for x, y in zip((*want.words, *want[1:5]), (*got.words, *got[1:5])):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_mixed_slice_cuda_equals_cpu(dev, tmp_path, monkeypatch):
    """The blocked readset with every R1 cut by R1_SKIP (mixed-length reads)
    in >= 3 blocks: the blocked mixed count, the chunked graph build and the
    blocked general pather with rescue and extend on CUDA give the CPU's
    kmers.npz, graph.npz, paths.npz, ebcx.npz, ReadPaths and stats, with
    every kernel launched."""
    from supernova_tpu_torch.dbg import build as dbuild
    from supernova_tpu_torch.pipeline.datasets import r1_trimmed

    rs = r1_trimmed(blocked_readset())
    pin_blocks(monkeypatch, 100_000)
    kernels.reset_launch_counts()
    pg = Pipeline(tmp_path / "cuda", device="cuda")
    tg, _, rg = pg.run_slice(rs)
    assert all(c > 0 for c in kernels.launch_counts().values())
    assert pg.stage_records["count"]["blocks"] >= 3 and pg.stage_records["paths"]["blocks"] >= 3
    pc = Pipeline(tmp_path / "cpu", device="cpu")
    _, _, rc = pc.run_slice(rs)
    for name in ("kmers.npz", "graph.npz", "paths.npz", "ebcx.npz"):
        zg, zc = np.load(tmp_path / "cuda" / name), np.load(tmp_path / "cpu" / name)
        assert zg.files == zc.files
        for k in zc.files:
            assert zg[k].dtype == zc[k].dtype and np.array_equal(zg[k], zc[k]), (name, k)
    for x, y in zip(convert.readpaths_to_numpy(rg), convert.readpaths_to_numpy(rc)):
        assert np.array_equal(x[: rs.n_reads], y[: rs.n_reads])
    for k in ("placed_perc", "paths_rescued", "paths_extended"):
        assert pg.stats.get(k) == pc.stats.get(k), k
    whole, chunked = dbuild.build_links(tg), dbuild.build_links(tg, chunk=1001)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def hole_readset(rng):
    """tests/test_patch.py's readset, from the port's copies of the
    simulator and build_readset: mate pairs tiling a 3 kb genome except
    across a hole at 1400-1480, and one long read over the hole."""
    from supernova_tpu_torch.core import dna
    from supernova_tpu_torch.ingest.reads import build_readset

    g = sim.random_genome(rng, 3000)
    hole_lo, hole_hi = 1400, 1480
    read_len, insert = 150, 500
    reads, quals = [], []
    overlaps = lambda a, b: not (b <= hole_lo or a >= hole_hi)
    for s in range(0, len(g) - insert, 17):
        r1, r2 = (s, s + read_len), (s + insert - read_len, s + insert)
        if overlaps(*r1) or overlaps(*r2):
            continue
        reads += [g[r1[0] : r1[1]].copy(), dna.revcomp(g[r2[0] : r2[1]]).copy()]
        quals += [np.full(read_len, 37, np.uint8)] * 2
    reads.append(g[hole_lo - 70 : hole_hi + 150].copy())
    quals.append(np.full(70 + (hole_hi - hole_lo) + 150, 37, np.uint8))
    reads.append(dna.revcomp(g[2000:2150]).copy())
    quals.append(np.full(read_len, 37, np.uint8))
    return build_readset(reads, quals, np.zeros(len(reads) // 2, np.int32),
                         n_barcodes=0, barcoded=False)


def test_patch_rebuild_cuda_equals_cpu(dev):
    """The patch rebuild's count (unbarcoded reads of 0 to ~3,000 bases,
    min_freq=1, min_read_len=K) on the card equals its run on the CPU,
    table for table, and so does the rebuilt graph, with K1-K4 launched."""
    from supernova_tpu_torch.align import pather
    from supernova_tpu_torch.asm import patch as apatch
    from supernova_tpu_torch.core.kmer_codec import K
    from supernova_tpu_torch.dbg import build as dbuild
    from supernova_tpu_torch.dbg import graph as dgraph

    rs = hole_readset(np.random.default_rng(0))
    table = dbuild.trim_table(kcount.count_readset(rs, "cpu", min_freq=2), pad_multiple=256)
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    edges, plen, _ = (x[: rs.n_reads] for x in convert.readpaths_to_numpy(
        pather.path_readset(bg, rs, "cpu"))[:3])
    closures = apatch.close_gaps(bg, rs, apatch.find_edge_pairs(bg, edges, plen, dup=None))
    assert closures
    prs = apatch.patch_readset(bg, closures)
    kernels.reset_launch_counts()
    got = convert.table_to_numpy(kcount.count_readset(prs, dev, min_freq=1, min_read_len=K))
    assert all(c > 0 for c in kernels.launch_counts().values())
    want = convert.table_to_numpy(kcount.count_readset(prs, "cpu", min_freq=1, min_read_len=K))
    assert want.n_valid == got.n_valid
    for x, y in zip((*want.words, *want[1:5]), (*got.words, *got[1:5])):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    bg_g, bg_c = apatch.insert_patches(bg, closures, dev), apatch.insert_patches(bg, closures, "cpu")
    for f in ("inv", "from_v", "to_v", "is_circle", "kmer_words", "node_edge", "node_pos"):
        assert np.array_equal(getattr(bg_g, f), getattr(bg_c, f)), f
    assert np.array_equal(bg_g.edges.values, bg_c.edges.values)
    assert np.array_equal(bg_g.edges.offsets, bg_c.edges.offsets)


def glue_case(seed, size, repeats, n, max_len):
    """tests/test_nucleate_property.py's graph and random-walk closures
    (the glue parity cases of tests/test_torch_supergraph.py), from the
    port's copies: error-free tiling reads every 23 bases of a genome with
    repeats, counted at min_freq 2."""
    from supernova_tpu_torch.core import dna
    from supernova_tpu_torch.dbg import build as dbuild
    from supernova_tpu_torch.dbg import graph as dgraph
    from supernova_tpu_torch.ingest.reads import build_readset

    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, size, n_repeat_chunks=repeats, repeat_len=150)
    starts = list(range(0, len(g) - 150 + 1, 23))
    if starts[-1] != len(g) - 150:
        starts.append(len(g) - 150)
    reads = [r for s in starts for r in (g[s:s + 150].copy(), dna.revcomp(g[s:s + 150]).copy())]
    rs = build_readset(reads, [np.full(150, 37, np.uint8)] * len(reads),
                       np.zeros(len(reads) // 2, np.int32), n_barcodes=0, barcoded=False)
    table = dbuild.trim_table(kcount.count_readset(rs, "cpu", min_freq=2), pad_multiple=256)
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    nxt = {e: [int(f) for f in np.nonzero(bg.from_v == bg.to_v[e])[0]] for e in range(bg.n_edges)}
    closures = []
    for _ in range(n):
        walk = [int(rng.integers(bg.n_edges))]
        for _ in range(int(rng.integers(1, max_len))):
            if not nxt[walk[-1]]:
                break
            walk.append(int(rng.choice(nxt[walk[-1]])))
        closures.append(tuple(walk))
    return bg, closures


@pytest.mark.parametrize("case", [(1, 4000, 2, 50, 8, 100), (4, 4000, 2, 50, 8, 100),
                                  (9, 4000, 2, 50, 8, 100), (0, 6000, 3, 80, 12, None)])
def test_glue_cuda_equals_cpu(dev, case, monkeypatch):
    """The closure glue on the card (K4 and K2) gives the labels of its
    plain twin on CPU tensors, and nucleate_graph's gate sends a CUDA
    device to it (threshold lowered to 0 here) with the host core's D."""
    from supernova_tpu_torch.asm import nucleate as anuc
    from supernova_tpu_torch.parallel import device_nucleate as dn

    *gcase, mob = case
    bg, closures = glue_case(*gcase)
    adaptive = mob is None
    cls = anuc.sanitize_closures(bg, closures)
    mo = anuc.MIN_OVER_BASES if adaptive else mob
    kernels.reset_launch_counts()
    got = dn.glue_closures_device(bg, cls, mo, adaptive, dev)
    counts = kernels.launch_counts()
    assert counts["sort"] >= 4 and counts["compact"] == 1
    want = dn.glue_closures_device(bg, cls, mo, adaptive, "cpu")
    assert got is not None and np.array_equal(got, want)
    monkeypatch.setattr(anuc, "DEVICE_GLUE_MIN_POSITIONS", 0)
    info = {}
    D = anuc.nucleate_graph(bg, closures, min_over_bases=mob, device=dev, info=info)
    assert info["glue_route"] == "device"
    H = anuc.nucleate_graph(bg, closures, min_over_bases=mob, device_glue=False)
    for f in ("dinv", "from_v", "to_v"):
        assert np.array_equal(getattr(D, f), getattr(H, f)), f
    assert np.array_equal(D.epaths.values, H.epaths.values)
    assert np.array_equal(D.epaths.offsets, H.epaths.offsets)


def dp_pairs(seed=5, n=200, max_len=300):
    """Ragged pairs of lengths 1..max_len, half unrelated, half edited
    copies (tests/test_torch_alignment.py's kind of input)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        a = rng.integers(0, 4, int(rng.integers(1, max_len + 1))).astype(np.int32)
        if k % 2:
            b = rng.integers(0, 4, int(rng.integers(1, max_len + 1))).astype(np.int32)
        else:
            b = a.copy()
            hits = rng.integers(0, len(b), 4)
            b[hits] = (b[hits] + 1) % 4
            b = np.delete(b, hits[:1]) if len(b) > 1 else b
        pairs.append((a, b))
    return pairs


def test_het_dp_cuda_equals_cpu(dev):
    """The het DP (ops/alignment.py) on the card equals the same function
    on CPU tensors: 200 ragged pairs, and one pair at the het estimate's
    20,000-base cap with SNPs and an indel."""
    from supernova_tpu_torch.ops import alignment as al

    pairs = dp_pairs()
    assert np.array_equal(al.align_pairs(pairs, dev), al.align_pairs(pairs, "cpu"))
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 20_000).astype(np.int32)
    b = a.copy()
    b[rng.integers(0, 20_000, 40)] ^= 1
    b = np.delete(b, 12_345)
    b = np.insert(b, 777, 2)[:20_000]
    got = al.align_pairs([(a, b)], dev)
    assert np.array_equal(got, al.align_pairs([(a, b)], "cpu")) and 0 < got[0] < 40 * al.MIS + 100


def test_cli_run_cuda_equals_cpu(dev, tmp_path):
    """`python -m supernova_tpu_torch run` in process, on the card and on the
    CPU, on tests/test_cli.py's simulation: the card's run launches every
    kernel; the four FASTA files, summary.json (timing keys aside) and
    pipestance.json's stage states are the same."""
    import contextlib
    import gzip
    import io
    import json

    from supernova_tpu_torch import cli

    sim = tmp_path / "sim"
    assert cli.main(["simulate", "--out", str(sim), "--genome-size", "6000", "--barcodes", "40",
                     "--whitelist-size", "128", "--repeats", "1"]) == 0
    got = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["run", "--r1", str(sim / "sample_R1.fastq.gz"), "--r2",
                           str(sim / "sample_R2.fastq.gz"), "--whitelist",
                           str(sim / "whitelist.txt"), "--out", str(out), "--device", device])
        assert rc == 0
        if device == "cuda":
            assert all(c > 0 for c in kernels.launch_counts().values()), kernels.launch_counts()
        fastas = {}
        for flavor in ("raw", "megabubbles", "pseudohap", "pseudohap2"):
            with gzip.open(out / f"assembly.{flavor}.fasta.gz", "rb") as f:
                fastas[flavor] = f.read()
        summary = {k: v for k, v in json.loads((out / "summary.json").read_text()).items()
                   if not k.startswith(("etime_", "mem_"))}
        stages = {k: (v["status"], v["attempts"]) for k, v in
                  json.loads((out / "pipestance.json").read_text())["stages"].items()}
        got[device] = (fastas, summary, stages)
    assert got["cuda"] == got["cpu"]


def test_links_votes_and_fmindex_cuda_equal_cpu(dev):
    """The last modules' entry points on the card and on CPU tensors at a
    small size: stable_compact (K2, its tail zero), bc_link_triples and
    sharded_bc_links over 4 shards (K4 and K2 launched), sharded_vote_matrix
    and the dry run's two rounds, suffix_array, FMIndex.from_edges and
    count_batch_device - each equal to its CPU result."""
    from supernova_tpu_torch.align import fmindex
    from supernova_tpu_torch.asm.links import incidence_from_sets, link_triples_np
    from supernova_tpu_torch.ops import segments
    from supernova_tpu_torch.parallel import mesh, rounds, sharded_phase, sharded_scaffold

    rng = np.random.default_rng(12)
    valid = torch.from_numpy(rng.random(5000) < 0.3)
    cols = [torch.from_numpy(rng.integers(0, 2**31, 5000)) for _ in range(3)]
    kernels.reset_launch_counts()
    nv, got = segments.stable_compact(valid.to(dev), *(c.to(dev) for c in cols))
    assert kernels.launch_counts()["compact"] == 1
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, segments.stable_compact(valid, *cols)[1]))
    assert not any(a[int(nv):].any() for a in got)

    sets = [np.sort(rng.choice(300, size=rng.binomial(300, 0.1), replace=False)) + 1
            for _ in range(80)]
    bcv, item = incidence_from_sets(sets)
    for cap in (4, 64):
        kernels.reset_launch_counts()
        got = sharded_scaffold.bc_link_triples(bcv, item, cap=cap, min_shared=2, device=dev)
        counts = kernels.launch_counts()
        assert counts["sort"] >= 2 and counts["compact"] == 2, counts
        want = link_triples_np(bcv, item, min_shared=2, max_per_bc=cap)
        assert all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(got[:3], want))
        shards = sharded_scaffold.split_incidence(bcv, item, 4)
        got = sharded_scaffold.sharded_bc_links(mesh.make_mesh(4, "cuda"), *shards, cap=cap,
                                                min_shared=2)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))

    eb = np.full(50, -1, np.int32)
    es = np.zeros(50, np.int32)
    eb[:20], es[:20] = np.arange(20) // 2, np.where(np.arange(20) % 2, -1, 1)
    votes = sharded_phase.split_votes(rng.integers(-1, 60, 20000), rng.integers(-1, 90, 20000), 4)
    got = sharded_phase.sharded_vote_matrix(mesh.make_mesh(4, "cuda"), eb, es, *votes, 10, 80)
    want = sharded_phase.sharded_vote_matrix(mesh.make_mesh(4, "cpu"), eb, es, *votes, 10, 80)
    assert np.array_equal(got, want) and got.any()
    assert rounds.scaffold_join_round(mesh.make_mesh(4, "cuda")) == (4, 2)
    assert rounds.phase_round(mesh.make_mesh(4, "cuda")) == (2, 1.0)

    edges = [rng.integers(0, 4, int(rng.integers(50, 3000)), dtype=np.uint8) for _ in range(60)]
    edges[3] = np.tile(edges[2][:40], 30)  # a long repeat: more doubling rounds
    kernels.reset_launch_counts()
    fm = fmindex.FMIndex.from_edges(edges, device=dev)
    assert kernels.launch_counts()["sort"] > 0
    want = fmindex.FMIndex.from_edges(edges, device="cpu")
    for f in ("bwt", "sa", "less", "occ_ck", "edge_starts"):
        assert np.array_equal(getattr(fm, f), getattr(want, f)), f
    pats = np.zeros((3000, 40), np.uint8)
    lens = rng.integers(0, 41, 3000)
    for i in range(3000):
        e = edges[i % 60]
        s = int(rng.integers(0, len(e) - 40))
        pats[i] = e[s : s + 40]
    got = fm.count_batch_device(pats, lens, device=dev)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want.count_batch_device(pats, lens, device="cpu"))


def test_spans_and_byte_counters_on_the_card(dev):
    """K2's bytes count its kept rows, read from the card; a traced count
    on the card gives each step a device interval and the launches' bytes
    the shapes' arithmetic (K1's from prepare_reads' codes)."""
    from torch.profiler import ProfilerActivity, profile

    from supernova_tpu_torch.pipeline import datasets
    from supernova_tpu_torch.stats import trace as st

    g = torch.Generator(device=dev).manual_seed(5)
    n = 100_003
    keep = torch.rand(n, device=dev, generator=g) < 0.3
    cols = (torch.arange(n, device=dev), torch.arange(n, device=dev, dtype=torch.int32))
    for fills in (None, (0, 0)):
        b0 = kernels.byte_counts()["compact"]
        nv, _ = k2.compact(keep, *cols, fills=fills)
        assert kernels.byte_counts()["compact"] - b0 == k2.launch_bytes(
            n, int(nv), 12, fill=fills is not None)

    rs = datasets.simulate(datasets.SMALL, datasets.SMALL_SEED)
    kcount.count_readset(rs, dev)  # the library built and loaded outside the profile
    st.clear_spans()
    info: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        table = kcount.count_readset(rs, dev, info=info)
    log = st.spans()
    st.clear_spans()
    assert [s["name"] for s in log] == ["call.count.prep", "call.count.sort", "call.count.reduce",
                                        "call.count.recompute", "call.count_readset"]
    assert all(s["device_s"] > 0 for s in log)
    assert sum(s["device_s"] for s in log[:4]) <= log[4]["device_s"] * 1.001
    root = log[4]
    inp = kcount.prepare_reads(rs, dev)
    assert root["kmer_extract.launches"] == 1 and root["kmer_extract.bytes"] == k1.launch_bytes(
        inp["codes_ext"].numel(), inp["pos_read"].shape[0])
    rows, m, kept = info["first_block_sort_rows"], table.count.shape[0], int(table.n_valid)
    # the occurrence sort, then 8 membership joins of the table against itself
    assert root["sort.launches"] == 9
    # the extraction's scan, then 3 in each of the 8 joins
    assert root["scan_max.launches"] == 25
    assert root["scan_max.bytes"] == k5.launch_bytes(
        inp["pos_read"].shape[0], 8, False, True) + 8 * (
        2 * k5.launch_bytes(2 * m, 8, False, True) + k5.launch_bytes(2 * m, 8, True, True))
    assert root["sort.bytes"] == k4.launch_bytes(rows, 4) + 8 * k4.launch_bytes(2 * m, 4)
    assert root["run_reduce.bytes"] == k3.launch_bytes(rows)
    # three words and two int32 columns, the tail filled
    assert root["compact.bytes"] == k2.launch_bytes(rows, kept, 32, fill=True)
    assert kept > 0
