"""The port's het DP (supernova_tpu_torch/ops/alignment.py) against the
reference's jitted lax.scan DP (supernova_tpu/ops/alignment.py) and its
brute-force oracle, exactly, on CPU tensors; and asm/het.py's
estimate_hetdist against the reference's on tests/test_alignment.py's
diploid case.  The card's run of the same DP is in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from supernova_tpu.asm import het as rhet
from supernova_tpu.asm import lines as ralines
from supernova_tpu.asm import supergraph as rsg
from supernova_tpu.dbg import build as rbuild
from supernova_tpu.dbg import graph as rgraph
from supernova_tpu.ingest.reads import build_readset
from supernova_tpu.kmer import count as rcount
from supernova_tpu.ops import alignment as ral
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch.asm import het as phet
from supernova_tpu_torch.asm import lines as palines
from supernova_tpu_torch.asm import supergraph as psg
from supernova_tpu_torch.dbg import graph as pgraph
from supernova_tpu_torch.ops import alignment as pal

from tests.test_dbg import perfect_readset


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_pairs(seed=5, n=200, max_len=300):
    """n pairs of unequal random lengths 1..max_len: unrelated sequences,
    and b made from a by random substitutions, insertions and deletions."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        a = rng.integers(0, 4, int(rng.integers(1, max_len + 1))).astype(np.int32)
        if k % 2:
            b = rng.integers(0, 4, int(rng.integers(1, max_len + 1))).astype(np.int32)
        else:
            b = a.tolist()
            for _ in range(int(rng.integers(0, 8))):
                pos = int(rng.integers(0, len(b)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[pos] = (b[pos] + 1) % 4
                elif op == 1:
                    b.insert(pos, int(rng.integers(0, 4)))
                elif len(b) > 1:
                    del b[pos]
            b = np.asarray(b, np.int32)
        pairs.append((a, b))
    return pairs


def test_dp_constants_and_oracle_are_the_reference():
    assert (pal.MIS, pal.OPEN, pal.EXT, pal.BIG) == (ral.MIS, ral.OPEN, ral.EXT, ral.BIG)
    import inspect

    assert inspect.getsource(pal.brute_affine_np) == inspect.getsource(ral.brute_affine_np)


def test_random_ragged_pairs_match_reference_and_oracle():
    """200 pairs of lengths 1-300 in one ragged batch: the reference's
    scores, and the oracle's on every pair."""
    pairs = random_pairs()
    info = {}
    got = pal.align_pairs(pairs, "cpu", info=info)
    want = ral.align_pairs_np(pairs)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert info["pairs"] == 200 and info["shape"] == (max(len(a) for a, _ in pairs),
                                                       max(len(b) for _, b in pairs))
    assert np.array_equal(got, [ral.brute_affine_np(a, b) for a, b in pairs])


def test_identical_snp_and_indel_pairs():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 4, 100).astype(np.int32)
    snp = a.copy()
    snp[50] = (snp[50] + 1) % 4
    ins = np.insert(a, 40, (a[40] + 1) % 4)
    dele = np.delete(a, 70)
    ins3 = np.insert(a, 10, [0, 1, 2])
    pairs = [(a, a), (a, snp), (a, ins), (a, dele), (a, ins3), (ins, a)]
    got = pal.align_pairs(pairs, "cpu")
    assert np.array_equal(got, ral.align_pairs_np(pairs))
    assert list(got[:4]) == [0, ral.MIS, ral.OPEN + ral.EXT, ral.OPEN + ral.EXT]
    assert np.array_equal(got, [ral.brute_affine_np(x, y) for x, y in pairs])


def test_padding_much_longer_than_the_pairs():
    """Short pairs in a batch padded to a 400 x 380 matrix by one long pair:
    the padded rows and columns leave the short pairs' scores alone."""
    rng = np.random.default_rng(7)
    pairs = [(rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 4, m).astype(np.int32))
             for n, m in ((1, 1), (3, 9), (12, 5), (40, 41), (2, 30))]
    pairs.append((rng.integers(0, 4, 400).astype(np.int32),
                  rng.integers(0, 4, 380).astype(np.int32)))
    got = pal.align_pairs(pairs, "cpu")
    assert np.array_equal(got, ral.align_pairs_np(pairs))
    assert np.array_equal(got, [ral.brute_affine_np(a, b) for a, b in pairs])
    alone = pal.align_pairs(pairs[:5], "cpu")
    assert np.array_equal(got[:5], alone)


def test_estimate_hetdist_matches_reference():
    """tests/test_alignment.py's diploid case (6 kb, het 0.004, perfect
    reads of both haplotypes, unbarcoded): the same bubbles, pairs and
    hetdist through the port's het estimate on the port's copies of the
    supergraph and lines."""
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 6000)
    snp_pos, hb = sim.diploidize(rng, g, het_rate=0.004)
    rs_a, rs_b = perfect_readset(g), perfect_readset(hb)
    reads = [rs_a.read(i) for i in range(rs_a.n_reads)] + [
        rs_b.read(i) for i in range(rs_b.n_reads)]
    quals = [rs_a.qual(i) for i in range(rs_a.n_reads)] + [
        rs_b.qual(i) for i in range(rs_b.n_reads)]
    rs = build_readset(reads, quals, np.zeros(len(reads) // 2, np.int32), n_barcodes=0,
                       barcoded=False)
    table = rbuild.trim_table(rcount.count_readset(rs, min_freq=2), pad_multiple=256)
    rbg = rgraph.from_device(rbuild.build_graph(table), table)
    D_r = rsg.build_supergraph(rbg)
    want = rhet.estimate_hetdist(D_r, ralines.find_lines(D_r))
    bg = pgraph.BaseGraph(**{f: getattr(rbg, f) for f in (
        "edges", "inv", "from_v", "to_v", "n_vertices", "is_circle", "kmer_words",
        "node_edge", "node_pos", "n_kmers")})
    D = psg.build_supergraph(bg)
    info = {}
    got = phet.estimate_hetdist(D, palines.find_lines(D), "cpu", info=info)
    assert want is not None and got == want
    assert info["pairs"] >= 3 and len(snp_pos) > 3
