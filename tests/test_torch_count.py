"""Port parity: supernova_tpu_torch.kmer.count against the JAX reference on
the CPU, exact equality — barcoded, unbarcoded and mixed-length readsets,
plus the host-prep copies held equal to their originals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supernova_tpu.core.kmer_codec import K
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.ingest.reads import build_readset
from supernova_tpu.kmer import count as rcount
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch import convert
from supernova_tpu_torch.core import kmer_codec as kc
from supernova_tpu_torch.kmer import count as kcount

from tests.test_dbg import perfect_readset


def barcoded_readset(seed=0, error_rate=0.003, n_barcodes=12):
    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, 3000, n_repeat_chunks=1, repeat_len=200)
    _, hb = sim.diploidize(rng, g, het_rate=0.002)
    wl = sim.make_whitelist(rng, 64)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=n_barcodes, molecules_per_barcode=2,
        molecule_len=1500, coverage_per_molecule=1.2, error_rate=error_rate,
        bc_error_rate=0.02,
    )
    return ingest_sim(reads, wl)


def mixed_length_readset(seed=1):
    """Reads of 60..150 bases with low-qual runs, barcoded, some bc 0."""
    rng = np.random.default_rng(seed)
    g = sim.random_genome(rng, 2000)
    reads, quals = [], []
    for _ in range(300):
        ln = int(rng.integers(60, 151))
        s = int(rng.integers(0, len(g) - ln))
        r = g[s : s + ln].copy()
        if rng.random() < 0.5:
            r = sim.dna.revcomp(r).copy()
        q = np.full(ln, 37, np.uint8)
        q[rng.random(ln) < 0.02] = 2
        reads.append(r)
        quals.append(q)
    bc = np.sort(rng.integers(0, 6, len(reads) // 2)).astype(np.int32)
    return build_readset(reads, quals, bc, n_barcodes=5, barcoded=True)


@pytest.fixture(scope="module")
def readsets():
    return {
        "barcoded": barcoded_readset(),
        "unbarcoded": perfect_readset(sim.random_genome(np.random.default_rng(2), 1500)),
        "mixed": mixed_length_readset(),
    }


def assert_tables_equal(ref, port):
    p = convert.table_to_numpy(port)
    assert int(ref.n_valid) == p.n_valid
    for i in range(3):
        assert np.array_equal(np.asarray(ref.words[i]), p.words[i]), f"word {i}"
    for f in ("count", "nbc", "left_mask", "right_mask"):
        a = np.asarray(getattr(ref, f))
        assert a.dtype == getattr(p, f).dtype, f
        assert np.array_equal(a, getattr(p, f)), f


@pytest.mark.parametrize("kind", ["barcoded", "unbarcoded", "mixed"])
def test_count_readset_matches_reference(readsets, kind):
    rs = readsets[kind]
    min_freq = 2 if kind == "unbarcoded" else 3
    ref = rcount.count_readset(rs, min_freq=min_freq)
    port = kcount.count_readset(rs, "cpu", min_freq=min_freq)
    assert int(ref.n_valid) > 100
    assert_tables_equal(ref, port)


@pytest.mark.parametrize("kind", ["barcoded", "mixed"])
def test_count_kmers_untrimmed_matches_reference(readsets, kind):
    """count_kmers before trimming (occurrence-padded) and trim_table."""
    rs = readsets[kind]
    ri = rcount.prepare_reads(rs)
    pi = kcount.prepare_reads(rs, "cpu")
    args = ("codes_ext", "pos_read", "glen_pos", "bc_pos")
    ref = rcount.count_kmers(*(ri[a] for a in args), uniform_rl=ri["uniform_rl"])
    port = kcount.count_kmers(*(pi[a] for a in args), uniform_rl=pi["uniform_rl"])
    assert_tables_equal(ref, port)
    from supernova_tpu_torch.dbg.build import trim_table

    assert_tables_equal(rbuild.trim_table(ref, pad_multiple=256), trim_table(port, pad_multiple=256))


def test_extract_occurrences_matches_reference(readsets):
    rs = readsets["barcoded"]
    ri = rcount.prepare_reads(rs)
    pi = kcount.prepare_reads(rs, "cpu")
    args = ("codes_ext", "pos_read", "glen_pos", "bc_pos")
    r = rcount.extract_occurrences(*(ri[a] for a in args))
    p = kcount.extract_occurrences(*(pi[a] for a in args))
    for i in range(3):
        assert np.array_equal(np.asarray(r[0][i]).astype(np.int64), p[0][i].numpy())
    for a, b in zip(r[1:], p[1:]):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))
    pk_r = rcount.pack_occurrence_attrs(*r[1:])
    pk_p = kcount.pack_occurrence_attrs(*p[1:])
    assert np.array_equal(np.asarray(pk_r).astype(np.int64), pk_p.numpy())
    for a, b in zip(rcount.unpack_occurrence_attrs(pk_r), kcount.unpack_occurrence_attrs(pk_p)):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))


@pytest.mark.parametrize("min_freq,min_bc", [(1, 0), (2, 3)])
def test_reduce_occurrences_filters_match_reference(readsets, min_freq, min_bc):
    rs = readsets["barcoded"]
    ri = rcount.prepare_reads(rs)
    pi = kcount.prepare_reads(rs, "cpu")
    args = ("codes_ext", "pos_read", "glen_pos", "bc_pos")
    r = rcount.extract_occurrences(*(ri[a] for a in args))
    p = kcount.extract_occurrences(*(pi[a] for a in args))
    assert_tables_equal(
        rcount.reduce_occurrences(*r, min_freq=min_freq, min_bc=min_bc),
        kcount.reduce_occurrences(*p, min_freq=min_freq, min_bc=min_bc),
    )


def test_recompute_adjacencies_from_reference_table(readsets):
    """The reference's pre-adjacency table, carried across by convert."""
    rs = readsets["barcoded"]
    ri = rcount.prepare_reads(rs)
    raw = rbuild.trim_table(rcount.count_kmers(
        ri["codes_ext"], ri["pos_read"], ri["glen_pos"], ri["bc_pos"],
        uniform_rl=ri["uniform_rl"]))
    ref = rcount.recompute_adjacencies(raw)
    port = kcount.recompute_adjacencies(convert.table_from_numpy(raw, "cpu"))
    assert_tables_equal(ref, port)
    assert_tables_equal(ref, convert.table_from_numpy(convert.table_to_numpy(port), "cpu"))


@pytest.mark.parametrize("kind", ["barcoded", "mixed"])
def test_prepare_reads_copies_match_originals(readsets, kind):
    rs = readsets[kind]
    assert np.array_equal(
        kcount.good_lengths_np(rs.quals, rs.offsets),
        rcount.good_lengths_np(rs.quals, rs.offsets),
    )
    ri = rcount.prepare_reads(rs)
    pi = kcount.prepare_reads(rs, "cpu")
    assert ri.keys() == pi.keys()
    assert ri["uniform_rl"] == pi["uniform_rl"]
    for k in ri:
        if k != "uniform_rl":
            assert np.array_equal(np.asarray(ri[k]), pi[k].numpy()), k
    rp = rcount.prepare_reads_packed(rs)
    pp = kcount.prepare_reads_packed(rs)
    if rp is None:
        assert pp is None
        return
    for k in rp:
        assert np.array_equal(np.asarray(rp[k]), np.asarray(pp[k])), k
    ext = max(K, 128)
    assert np.array_equal(
        np.asarray(rcount._unpack_codes_dev(jnp.asarray(rp["codes_packed"]), rp["nbp"], ext)),
        kcount._unpack_codes_dev(torch.from_numpy(pp["codes_packed"]), pp["nbp"], ext).numpy(),
    )


def test_good_lengths_random_quals():
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 200, 400)
    quals = rng.choice(np.array([2, 11, 37], np.uint8), size=int(lens.sum()), p=[0.05, 0.15, 0.8])
    offsets = np.r_[0, np.cumsum(lens)]
    assert np.array_equal(
        kcount.good_lengths_np(quals, offsets), rcount.good_lengths_np(quals, offsets)
    )


def test_estimate_coverage_and_rev4(readsets):
    ref = rcount.count_readset(readsets["barcoded"])
    port = convert.table_from_numpy(ref, "cpu")
    assert rcount.estimate_coverage(ref) == kcount.estimate_coverage(port)
    m = np.arange(16)
    assert np.array_equal(np.asarray(rcount.rev4(jnp.asarray(m))), kcount.rev4(torch.from_numpy(m)).numpy())
    assert isinstance(port.words, kc.W3)


def test_count_above_one_block_raises(readsets, monkeypatch):
    """Above one block a uniform-length readset takes the blocked count
    (tests/test_torch_blocked.py); a mixed-length one raises, since its
    blocked count is not ported."""
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 10_000)
    with pytest.raises(NotImplementedError, match="mixed-length"):
        kcount.count_readset(readsets["mixed"], "cpu")
