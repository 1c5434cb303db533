"""The port's barcode-link accumulation (supernova_tpu_torch/parallel/
sharded_scaffold.py) against the reference's on the CPU: the same numpy
incidence rows go through the JAX package's bc_link_triples and
sharded_bc_links (its 8-virtual-device mesh) and through the port on CPU
meshes of 1, 3 and 8 shards; every triple is an integer and every
comparison exact, also against asm/links.link_triples_np.  The port sizes
its triples exactly where the reference's out_cap clips them."""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from supernova_tpu.asm.links import incidence_from_sets, link_triples_np, links_as_dict
from supernova_tpu.parallel import mesh as rmesh
from supernova_tpu.parallel import sharded_scaffold as rss
from supernova_tpu_torch.parallel import mesh as pmesh
from supernova_tpu_torch.parallel import rounds
from supernova_tpu_torch.parallel import sharded_scaffold as pss

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_incidence(seed, n_items=40, n_bc=120, density=0.12):
    """tests/test_links.py's random per-item barcode sets -> incidence rows."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_items):
        k = rng.binomial(n_bc, density)
        sets.append(np.sort(rng.choice(n_bc, size=k, replace=False)) + 1)
    return incidence_from_sets(sets)


def padded(bcv, item, bucket=128):
    n = len(bcv)
    pad = -(-n // bucket) * bucket
    bc = np.full(pad, rss.SENT, np.int32)
    it = np.full(pad, rss.SENT, np.int32)
    bc[:n], it[:n] = bcv, item
    return bc, it


def port_triples(out):
    o1, o2, tot, nv = out
    assert o1.shape[0] == int(nv)
    return tuple(x.numpy() for x in (o1, o2, tot))


def ref_triples(out):
    o1, o2, tot, nv = out
    nv = int(nv)
    return tuple(np.asarray(x)[:nv].astype(np.int64) for x in (o1, o2, tot))


def same(a, b):
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def test_fnv_mix_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    x[:4] = [0, -1, rss.SENT, np.iinfo(np.int32).min]
    want = np.asarray(rss._fnv_mix(x)).astype(np.int64)
    got = pss._fnv_mix(torch.from_numpy(x))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert pss.SENT == rss.SENT


@pytest.mark.parametrize("cap,min_shared", [(2, 1), (5, 1), (12, 2), (16, 1), (64, 3)])
def test_bc_link_triples_match_reference(cap, min_shared):
    bcv, item = random_incidence(cap, density=0.2)
    bc, it = padded(bcv, item)
    ref = link_triples_np(bcv, item, min_shared=min_shared, max_per_bc=cap)
    got = port_triples(pss.bc_link_triples(bc, it, cap=cap, min_shared=min_shared, device="cpu"))
    assert same(got, ref)
    jax_out = ref_triples(rss.bc_link_triples(bc, it, cap=cap, out_cap=4 * len(bc),
                                              min_shared=min_shared))
    assert same(got, jax_out)


def test_bc_link_triples_edge_cases():
    """No rows, only pad rows, one row, one barcode whose run passes cap."""
    z = np.zeros(0, np.int64)
    for bc, it in ((z, z), (np.full(5, rss.SENT), np.full(5, rss.SENT)),
                   (np.array([3]), np.array([1]))):
        o1, o2, tot, nv = pss.bc_link_triples(bc, it, device="cpu")
        assert int(nv) == 0 and o1.shape == o2.shape == tot.shape == (0,)
    bc = np.array([7] * 5 + [9, 9])
    it = np.array([4, 0, 3, 1, 2, 0, 4])
    assert same(port_triples(pss.bc_link_triples(bc, it, cap=4, device="cpu")),
                (np.array([0]), np.array([4]), np.array([1])))


@pytest.fixture(scope="module")
def links_case():
    """tests/test_links.py's mesh case and the reference's result on its
    8-device mesh."""
    bcv, item = random_incidence(1, n_items=30, n_bc=100)
    bc_sh, it_sh = rss.split_incidence(bcv, item, N_DEV)
    want = rss.sharded_bc_links(rmesh.make_mesh(N_DEV), bc_sh, it_sh, cap=12, out_cap=1024,
                                min_shared=2)
    return bcv, item, want


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_bc_links_match_reference(links_case, n_dev):
    bcv, item, want = links_case
    assert same(want, link_triples_np(bcv, item, min_shared=2, max_per_bc=12))
    bc_sh, it_sh = pss.split_incidence(bcv, item, n_dev)
    info = {}
    got = pss.sharded_bc_links(pmesh.make_mesh(n_dev, "cpu"), bc_sh, it_sh, cap=12,
                               out_cap=1024, min_shared=2, info=info)
    assert same(got, want)
    assert info["dropped"] == [0] * n_dev and info["pair_rows"] > info["local_rows"] > 0


def test_sharded_bc_links_capacity_drops_rows():
    """cap_rows bounds each exchange's received rows: the rows past it are
    dropped and counted, and the triples lose their pairs."""
    bcv, item = random_incidence(2, n_items=30, n_bc=100)
    bc_sh, it_sh = pss.split_incidence(bcv, item, 3)
    info = {}
    got = pss.sharded_bc_links(pmesh.make_mesh(3, "cpu"), bc_sh, it_sh, cap=12, cap_rows=40,
                               min_shared=1, info=info)
    full = link_triples_np(bcv, item, min_shared=1, max_per_bc=12)
    assert sum(info["dropped"]) > 0 and len(got[0]) < len(full[0])


def test_reference_out_cap_clips_and_the_port_does_not():
    """The deliberate difference: the reference's out_cap (for
    bc_link_triples, by default the input rows) drops real triples; the
    port sizes its outputs exactly, and sharded_bc_links keeps every triple
    past out_cap (the reference keeps out_cap a shard)."""
    bcv, item = random_incidence(3, n_items=60, n_bc=40, density=0.5)
    full = link_triples_np(bcv, item, min_shared=1, max_per_bc=64)
    bc, it = padded(bcv, item)
    assert len(full[0]) > len(bc)  # more distinct pairs than input rows
    ref = ref_triples(rss.bc_link_triples(bc, it, cap=64))
    assert len(ref[0]) == len(bc) < len(full[0])
    assert links_as_dict(*ref).items() <= links_as_dict(*full).items()
    assert same(port_triples(pss.bc_link_triples(bc, it, cap=64, device="cpu")), full)
    bc_sh, it_sh = pss.split_incidence(bcv, item, N_DEV)
    got = pss.sharded_bc_links(pmesh.make_mesh(N_DEV, "cpu"), bc_sh, it_sh, cap=64, out_cap=64)
    assert len(full[0]) > N_DEV * 64 and same(got, full)


def test_scaffold_join_round_matches_reference():
    want = graft._scaffold_join_round(rmesh.make_mesh(1), 1)
    assert want[0] > want[1]
    for n_dev in (1, N_DEV):
        assert rounds.scaffold_join_round(pmesh.make_mesh(n_dev, "cpu")) == want
