"""The port's mesh phasing votes (supernova_tpu_torch/parallel/
sharded_phase.py) and the mesh's tensor sum against the reference's on the
CPU: tests/test_sharded_phase.py's cases go through the JAX package's
sharded_vote_matrix on its 8-virtual-device mesh and through the port on
CPU meshes; the dry run's phasing round gives the reference's result."""
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from supernova_tpu.parallel import mesh as rmesh
from supernova_tpu.parallel import sharded_phase as rsp
from supernova_tpu_torch.parallel import mesh as pmesh
from supernova_tpu_torch.parallel import rounds
from supernova_tpu_torch.parallel import sharded_phase as psp

N_DEV = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def votes_case(seed):
    """tests/test_sharded_phase.py's random votes and the host's matrix."""
    rng = np.random.default_rng(seed)
    n_edges, n_bub, n_mols, n_votes = 40, 6, 25, 5000
    edge_bubble = np.full(n_edges, -1, np.int32)
    edge_sign = np.zeros(n_edges, np.int32)
    for b in range(n_bub):
        edge_bubble[2 * b] = b
        edge_sign[2 * b] = 1
        edge_bubble[2 * b + 1] = b
        edge_sign[2 * b + 1] = -1
    re = rng.integers(0, n_edges, n_votes).astype(np.int32)
    rb = rng.integers(0, n_mols, n_votes).astype(np.int32)
    want = np.zeros((n_bub, n_mols), np.int32)
    for e, m in zip(re, rb):
        if edge_bubble[e] >= 0:
            want[edge_bubble[e], m] += edge_sign[e]
    return edge_bubble, edge_sign, re, rb, n_bub, n_mols, want


@pytest.fixture(scope="module")
def reference_votes():
    eb, es, re, rb, n_bub, n_mols, want = votes_case(0)
    re_sh, rb_sh = rsp.split_votes(re, rb, N_DEV)
    got = rsp.sharded_vote_matrix(rmesh.make_mesh(N_DEV), eb, es, re_sh, rb_sh, n_bub, n_mols)
    assert np.array_equal(got, want)
    return got


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_vote_matrix_matches_host_and_reference(reference_votes, n_dev):
    eb, es, re, rb, n_bub, n_mols, want = votes_case(0)
    re_sh, rb_sh = psp.split_votes(re, rb, n_dev)
    got = psp.sharded_vote_matrix(pmesh.make_mesh(n_dev, "cpu"), eb, es, re_sh, rb_sh, n_bub,
                                  n_mols)
    assert got.dtype == np.int32 and np.array_equal(got, reference_votes)


def test_vote_matrix_ignores_pad_and_range():
    """Pad rows, edges of no bubble, molecules out of range (99), a bubble
    index past n_bubbles (JAX drops its scatter) and an edge past the
    table (clamped, then masked) add nothing, in both packages."""
    edge_bubble = np.array([0, 0, -1, 3], np.int32)
    edge_sign = np.array([1, -1, 0, 1], np.int32)
    re = np.array([0, 1, -1, 2, 0, 3, 7], np.int32)
    rb = np.array([0, 0, 0, 1, 99, 2, 2], np.int32)
    re_sh, rb_sh = rsp.split_votes(re, rb, N_DEV)
    want = rsp.sharded_vote_matrix(rmesh.make_mesh(N_DEV), edge_bubble, edge_sign, re_sh, rb_sh,
                                   1, 4)
    assert want.tolist() == [[0, 0, 0, 0]]
    for n_dev in (1, 3):
        re_sh, rb_sh = psp.split_votes(re, rb, n_dev)
        got = psp.sharded_vote_matrix(pmesh.make_mesh(n_dev, "cpu"), edge_bubble, edge_sign,
                                      re_sh, rb_sh, 1, 4)
        assert np.array_equal(got, want)


def test_phase_round_matches_reference():
    want = graft._phase_round(rmesh.make_mesh(N_DEV), N_DEV)
    assert want == (2, 1.0)
    for n_dev in (1, 4):
        assert rounds.phase_round(pmesh.make_mesh(n_dev, "cpu")) == want


@pytest.mark.parametrize("n_dev", [1, 4])
def test_tensor_sum(n_dev):
    """Every shard's tensor summed in mesh order, the sum on every shard's
    device; the inputs are left as they were; a fleet mesh refuses a
    floating sum (all_reduce's order is not the mesh's; integer sums cross
    processes, tests/test_torch_fleet.py)."""
    m = pmesh.make_mesh(n_dev, "cpu")
    xs = [torch.arange(12, dtype=torch.int32).view(3, 4) * (i + 1) for i in range(n_dev)]
    before = [x.clone() for x in xs]
    got = m.tensor_sum(xs)
    want = torch.arange(12, dtype=torch.int32).view(3, 4) * (n_dev * (n_dev + 1) // 2)
    assert len(got) == n_dev and all(torch.equal(g, want) and g.dtype == torch.int32
                                     for g in got)
    assert all(torch.equal(x, b) for x, b in zip(xs, before))
    fleet = pmesh.Mesh(m.shape, m.axis_names, m.devices, group=object())
    with pytest.raises(TypeError):
        fleet.tensor_sum([x.float() for x in xs])
