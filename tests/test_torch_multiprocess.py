"""The port's multi-process fleet: 2 CPU processes x 2 shards each, joined
by parallel/dist.init_from_env over gloo (the SUPERNOVA_* environment of
tests/test_multiprocess.py), run the hierarchical count over the global
("host", "chip") mesh, whose host-axis exchange crosses the processes over
torch.distributed.all_to_all_single with uneven splits.  Both ranks' merged
table equals the single-device table, and every shard's table equals the
same count on an in-process (2, 2) mesh and the reference's
sharded_count_hier on its virtual-device mesh.  Each rank's Pipeline takes
the fleet's (2, 2) topology by itself, builds over the fleet's shard
tables, paths on all 4 shards of the fleet, and its kmers.npz, graph.npz
and paths.npz equal the single-device Pipeline's.

The same fleet over NCCL (2 processes x 1 card, and 2 x 2), with the whole
fleet path of tests/test_torch_fleet.py, is a card test: it skips without
two (four) cards."""
import pytest
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def dryrun_readset(n_groups: int, seed: int = 0):
    """tests/multiproc_worker.py's readset, through the port's own
    build_readset."""
    from supernova_tpu_torch.ingest.reads import build_readset

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600, dtype=np.uint8)
    reads, quals, bcs = [], [], []
    for i in range(8 * n_groups):
        s = int(rng.integers(0, len(genome) - 120))
        reads.append(genome[s:s + 120].copy())
        reads.append(genome[s + 1:s + 121].copy())
        quals.append(np.full(120, 37, np.uint8))
        quals.append(np.full(120, 37, np.uint8))
        bcs.append(1 + (i % 5))
    return build_readset(reads, quals, np.asarray(bcs), n_barcodes=8)


def e2e_readset():
    """The e2e genome (5 kb, 40 barcodes, 150-base reads) for the
    Pipeline, through the port's simulator and ingest."""
    from supernova_tpu_torch.ingest.ingest import ingest_sim
    from supernova_tpu_torch.pipeline import datasets

    return ingest_sim(*datasets.e2e_reads(np.random.default_rng(0)))


def table_rows(t):
    """A port KmerTable's valid rows as numpy (words, count, nbc, lm, rm)."""
    n = int(t.n_valid)
    return [np.stack([w[:n].cpu().numpy() for w in t.words], -1)] + [
        getattr(t, f)[:n].cpu().numpy() for f in ("count", "nbc", "left_mask", "right_mask")]


def worker() -> None:
    """One rank on MPW_DEVICE (gloo on "cpu", NCCL on "cuda"): join, count
    over the fleet, write rank<r>.npz."""
    import torch

    torch.set_num_threads(1)
    from supernova_tpu_torch.parallel import dist
    from supernova_tpu_torch.parallel import sharded_count as psc
    from supernova_tpu_torch.parallel.mesh import Sharded

    dev = os.environ["MPW_DEVICE"]
    assert dist.init_from_env(dev), "the worker needs the SUPERNOVA_* fleet environment"
    mesh = dist.fleet_mesh(dev)
    rs = dryrun_readset(mesh.size)
    inputs, nbl = psc.split_readset(rs, mesh)
    tables, ovf = psc.sharded_count_hier(mesh, inputs, capacity=2 * nbl, min_freq=1)
    merged = psc.merge_shard_tables(tables, mesh.devices[0])
    n_valid = Sharded([t.n_valid.reshape(1) for t in tables], mesh)
    _, idx = dist.local_rows(n_valid)
    out = {"ovf": np.array(ovf), "shards": np.array(idx), "n_dev": np.array(mesh.size),
           "n_valid": dist.host_fetch(n_valid)}  # gathered over the fleet
    for name, x in zip(("words", "count", "nbc", "lm", "rm"), table_rows(merged)):
        out[f"merged_{name}"] = x
    for i, t in zip(idx, tables):
        for name, x in zip(("words", "count", "nbc", "lm", "rm"), table_rows(t)):
            out[f"shard{i}_{name}"] = x
    # the Pipeline in a fleet: its count crosses the processes
    from supernova_tpu_torch.pipeline.run import Pipeline

    pl = Pipeline(Path(os.environ["MPW_OUT"]) / f"asm{mesh.rank}", device=dev)
    pl.run_slice(e2e_readset())
    rec = pl.stage_records["count"]
    out.update(pl_topology=np.array(pl.multi_device), pl_shards=np.array(pl.stats.get("n_shards")),
               pl_path_shards=np.array(pl.stats.get("n_shards_path", 0)),
               pl_route=np.array(rec["count_route"]),
               devices=np.array([str(d) for d in mesh.devices]))
    np.savez(Path(os.environ["MPW_OUT"]) / f"rank{mesh.rank}.npz", **out)
    import torch.distributed as tdist

    tdist.destroy_process_group()


def launch_fleet(tmp_path, n_proc: int = 2, local: int = 2, device: str = "cpu"):
    """n_proc ranks of this file's worker (parallel/dist.py's spawn_fleet)
    -> (their Popens, their outputs)."""
    from supernova_tpu_torch.parallel import dist

    env = dict(os.environ, MPW_OUT=str(tmp_path), MPW_DEVICE=device,
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    procs = dist.spawn_fleet([sys.executable, str(Path(__file__).resolve())], n_proc, local, env,
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return procs, [out for out, _ in dist.wait_fleet(procs, timeout=240)]


NAMES = ("words", "count", "nbc", "lm", "rm")


def assert_npz_equal(want, got):
    """Two .npz files hold the same arrays, names, dtypes and values
    (tests/test_torch_slice.py's, whose module imports the JAX package)."""
    zw, zg = np.load(want), np.load(got)
    assert sorted(zw.files) == sorted(zg.files)
    for k in zw.files:
        assert zw[k].dtype == zg[k].dtype and np.array_equal(zw[k], zg[k]), (got, k)


def check_fleet(tmp_path, local: int, device: str):
    """Two ranks of `local` shards on `device`: the fleet's merged table
    == the single-device table on both ranks, each rank's Pipeline ran the
    mesh count over the fleet's (2, local) topology, the build over its
    shard tables and paths over all 2 * local shards, and wrote the
    single-device Pipeline's kmers/graph/paths.npz.
    -> (rank 0's npz, rank 1's npz, the in-process (2, local) tables)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    procs, outs = launch_fleet(tmp_path, local=local, device=device)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    r0, r1 = np.load(tmp_path / "rank0.npz"), np.load(tmp_path / "rank1.npz")
    assert r0["ovf"].sum() == 0
    assert list(r0["shards"]) == list(range(local))
    assert list(r1["shards"]) == list(range(local, 2 * local))
    for k in NAMES:
        assert np.array_equal(r0[f"merged_{k}"], r1[f"merged_{k}"]), k
    for r in (r0, r1):
        assert list(r["pl_topology"]) == [2, local] and int(r["pl_shards"]) == 2 * local
        assert int(r["pl_path_shards"]) == 2 * local  # the fleet's shards, as the reference's
        assert str(r["pl_route"]) == "mesh"
    from supernova_tpu_torch.pipeline.run import Pipeline

    Pipeline(tmp_path / "single", device="cpu", multi_device=False).run_slice(e2e_readset())
    for name in ("kmers.npz", "graph.npz", "paths.npz"):
        assert_npz_equal(tmp_path / "single" / name, tmp_path / "asm0" / name)
        assert_npz_equal(tmp_path / "single" / name, tmp_path / "asm1" / name)

    from supernova_tpu_torch.dbg import build as pbuild
    from supernova_tpu_torch.kmer import count as pcount
    from supernova_tpu_torch.parallel import mesh as pmesh
    from supernova_tpu_torch.parallel import sharded_count as psc

    n_dev = int(r0["n_dev"])
    rs = dryrun_readset(n_dev)
    inp = pcount.prepare_reads(rs, "cpu")
    single = pbuild.trim_table(pcount.count_kmers(
        inp["codes_ext"], inp["pos_read"], inp["glen_pos"], inp["bc_pos"], min_freq=1,
        uniform_rl=inp["uniform_rl"]))
    assert len(r0["merged_count"]) > 0
    for k, want in zip(NAMES, table_rows(single)):
        assert np.array_equal(r0[f"merged_{k}"], want.astype(r0[f"merged_{k}"].dtype)), k

    mesh = pmesh.make_mesh2(2, local, device="cpu")
    inputs, nbl = psc.split_readset(rs, mesh)
    tables, ovf = psc.sharded_count_hier(mesh, inputs, capacity=2 * nbl, min_freq=1)
    assert sum(ovf) == 0
    for r in (r0, r1):
        assert list(r["n_valid"]) == [int(t.n_valid) for t in tables]
    for s, t in enumerate(tables):
        r = r0 if s < local else r1
        for k, x in zip(NAMES, table_rows(t)):
            assert np.array_equal(r[f"shard{s}_{k}"], x), (s, k)
    return r0, r1, tables


def check_nccl_fleet(tmp_path, local: int):
    """The NCCL route with `local` cards a process: init_from_env("cuda"),
    the hierarchical count as above, then tests/test_torch_fleet.py's
    worker over the fleet's flat mesh of 2 * local cards (every exchange
    across processes over all_to_all_single on CUDA tensors, staged
    through each process's first card; the reductions, the sized gathers,
    the build, both pathers, the glue, links, votes and the Pipeline
    through the supergraph stage), each equal to the CPU's."""
    import torch

    import test_torch_fleet as tf  # this directory's (test_torch_fleet.py says why)

    if torch.cuda.device_count() < 2 * local:
        pytest.skip(f"an NCCL fleet of 2 processes x {local} cards needs {2 * local} cards")
    r0, r1, _ = check_fleet(tmp_path / "count", local=local, device="cuda")
    assert list(r0["devices"]) == [f"cuda:{i}" for i in range(local)]
    assert list(r1["devices"]) == [f"cuda:{local + i}" for i in range(local)]
    single = tf.single_e2e(tmp_path / "single")
    ranks = tf.check_fleet_run(tmp_path / "fleet", "cuda", local, single)
    assert [list(x["devices"]) for x in ranks] == [list(r0["devices"]), list(r1["devices"])]


@pytest.mark.cuda
def test_two_process_nccl_fleet_matches_single(tmp_path):
    """2 processes x 1 card (two cards)."""
    check_nccl_fleet(tmp_path, local=1)


@pytest.mark.cuda
def test_two_process_two_card_nccl_fleet_matches_single(tmp_path):
    """2 processes x 2 cards (four cards): each process's shards on two
    cards, its exchanges staged through its first."""
    check_nccl_fleet(tmp_path, local=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dataset", ["FULL", "GENOME"])
def test_nccl_fleet_on_datasets_matches_one_card(tmp_path, dataset):
    """stats/fleet.py on the full slice and on the genome: count, graph,
    paths, patch and supergraph on one card, then over NCCL fleets of 2
    processes x 1 card and (with four cards) 2 x 2; every process's
    checkpoints equal to the one card's.  Its JSON lines (walls, card
    peaks, rows sent across processes) are printed."""
    import json

    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("an NCCL fleet needs one card per process: two cards")
    locals_ = [1, 2] if cards >= 4 else [1]
    out = subprocess.run([sys.executable, "-m", "supernova_tpu_torch.stats.fleet",
                          "--out", str(tmp_path), "--dataset", dataset,
                          "--locals", ",".join(map(str, locals_))],
                         cwd=REPO, capture_output=True, text=True, timeout=2400)
    print(out.stdout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = json.loads(out.stdout.splitlines()[-1])
    assert {"kmers.npz", "graph.npz", "paths.npz", "supergraph.npz"} <= set(last["files"])
    assert last["ok"] and len(last["equal"]) == 2 * len(last["files"]) * len(locals_)
    assert all(last["equal"].values())


def test_two_process_hier_count_matches_single(tmp_path):
    r0, r1, tables = check_fleet(tmp_path, local=2, device="cpu")
    n_dev = int(r0["n_dev"])

    # the reference's single-process (2, 2) hierarchical count, shard by shard
    from supernova_tpu.core.kmer_codec import soa_to_np
    from supernova_tpu.parallel.mesh import make_mesh2
    from supernova_tpu.parallel.sharded_count import sharded_count_hier, split_readset
    from tests.multiproc_worker import dryrun_readset as ref_readset

    codes, pr, glp, bcp, rnbl, _, url = split_readset(ref_readset(n_dev), n_dev,
                                                      base_bucket=2048, read_bucket=64)
    ref, rovf = sharded_count_hier(make_mesh2(2, 2), *map(np.asarray, (codes, pr, glp, bcp)),
                                   n_hosts=2, chips_per_host=2, capacity=2 * rnbl, min_freq=1,
                                   uniform_rl=url)
    assert int(np.asarray(rovf).sum()) == 0
    nv = np.asarray(ref.n_valid)
    cap = len(np.asarray(ref.count)) // n_dev
    rw = soa_to_np(ref.words).reshape(n_dev, cap, 3)
    for s, t in enumerate(tables):
        got = table_rows(t)
        assert np.array_equal(got[0], rw[s, : nv[s]].astype(np.int64)), s
        for k, f in zip(NAMES[1:], ("count", "nbc", "left_mask", "right_mask")):
            want = np.asarray(getattr(ref, f)).reshape(n_dev, cap)[s, : nv[s]]
            assert np.array_equal(got[NAMES.index(k)], want.astype(got[NAMES.index(k)].dtype))


if __name__ == "__main__":  # one rank of launch_fleet
    worker()
