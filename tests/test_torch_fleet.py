"""The port's fleet-wide mesh: 2 CPU processes x 2 shards each, joined over
gloo by parallel/dist.init_from_env, run every collective and every
sharded stage over the fleet's flat "shard" mesh of 4 shards, as the
reference's make_mesh spans the fleet (tests/multiproc_worker.py's
sequence: flat count, build, paths, glue; then links and votes).

Each rank writes its results; the tests hold them, on both ranks, to the
same calls on an in-process mesh of as many CPU shards (the collectives
too), to the single-device port, and to the reference on its in-process
4-device mesh (count, build, pather, votes; the glue to its device glue,
the links to its host link_triples_np).  The fleet Pipeline's outputs
through the supergraph stage equal the single-device Pipeline's.  One
fleet launch serves every test (a module fixture).  The worker imports no
JAX: tests/test_torch_multiprocess.py runs it over NCCL on cards (1 or 2
a process) with the same checks (check_fleet_run)."""
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

# by its file's name, not as tests.*: the card host has another `tests`
# package on its path (this directory is on sys.path under pytest and as
# the worker's script directory)
from test_torch_multiprocess import assert_npz_equal, dryrun_readset, e2e_readset

REPO = Path(__file__).resolve().parent.parent
N_PROC, LOCAL = 2, 2
# the exchange cases: (name, mesh axis, rows global shard g sends (the
# first mesh.size of them), receiver capacity); a row names a member of
# its group or stays home
EXCHANGES = (("uneven", "shard", (3, 0, 5, 9), None),
             ("empty", "shard", (0, 0, 0, 0), None),
             ("capacity", "shard", (6, 7, 8, 2), 5),
             ("host", "host", (4, 1, 0, 6), None),
             ("chip", "chip", (2, 5, 3, 0), 3))
# rows of global shard g for from_global (one empty)
GATHER_ROWS = (2, 0, 3, 1)
# valid rows of global shard g's toy kmer table (trim_shard_tables): the
# largest sits in process 1 of a 2 x 1 fleet and process 0 of a 2 x 2 one
TRIM_ROWS = (10, 3000, 20, 40)
NPZ_FILES = ("kmers.npz", "graph.npz", "paths.npz", "ebcx.npz", "graph.patched.npz",
             "supergraph.npz", "dpaths.npz", "cpaths.npz")
# checkpoints each rank loses before the resumed fleet run: (rank, file);
# the ranks then disagree on the graph, the patch and the supergraph
RESUME_DROP = ((0, "kmers.npz"), (1, "kmers.npz"), (1, "graph.npz"), (0, "graph.patched.npz"),
               (0, "supergraph.npz"))
# the e2e glues: (tag, min_over_bases (None: the default), adaptive, value_shard)
GLUES = (("glue", 100, False, False), ("glue_adaptive_vs", None, True, True))


# ------------------------------------------------------------- the inputs

def meshes(n_proc: int, local: int, mesh_of=None):
    """(flat mesh, 2-D mesh) of n_proc x local shards: the joined fleet's
    (mesh_of: dist.fleet_mesh), or one process's CPU meshes."""
    from supernova_tpu_torch.parallel import mesh as pmesh

    if mesh_of is not None:
        mesh2 = mesh_of()
        return pmesh.flat(mesh2), mesh2
    return pmesh.make_mesh(n_proc * local, "cpu"), pmesh.make_mesh2(n_proc, local, "cpu")


def groups_of(mesh, axis):
    return mesh.size if axis == "shard" else mesh.axis_size(axis)


def exchange_inputs(name, sizes, n_groups):
    """Every global shard's (rows, 2) columns and keys of one case, from a
    seed (keys == n_groups stay home)."""
    import torch

    g = torch.Generator().manual_seed(len(name) * 1000 + sum(sizes) + n_groups)
    cols = [torch.randint(0, 1000, (n, 2), generator=g) for n in sizes]
    keys = [torch.randint(0, n_groups + 1, (n,), generator=g) for n in sizes]
    return cols, keys


def run_exchange(mesh, name, axis, sizes, capacity):
    """One exchange and its give_back on `mesh`, each shard answering with
    its rows' first column * 7 + its global index -> {key: array} for this
    process's shards."""
    n_groups = groups_of(mesh, axis)
    cols, keys = exchange_inputs(name, sizes[:mesh.size], n_groups)
    mine = [mesh.global_index(i) for i in range(mesh.n_local)]
    recv, ctx, dropped = mesh.exchange([cols[g].to(d) for g, d in zip(mine, mesh.devices)],
                                       [keys[g].to(d) for g, d in zip(mine, mesh.devices)],
                                       n_groups, axis, capacity)
    resp = [r[:, :1] * 7 + g for r, g in zip(recv, mine)]
    back = mesh.give_back(resp, ctx, -1)
    out = {}
    for g, r, b, d in zip(mine, recv, back, dropped):
        out.update({f"{name}_recv{g}": r.cpu().numpy(), f"{name}_back{g}": b.cpu().numpy(),
                    f"{name}_dropped{g}": np.array(d)})
    return out


def gather_inputs():
    """Every global shard's rows for from_global: (n, 3) int64 and (n,)
    bool."""
    rng = np.random.default_rng(5)
    return ([rng.integers(-9, 9, (n, 3)) for n in GATHER_ROWS],
            [rng.random(n) < 0.5 for n in GATHER_ROWS])


def votes_case(seed=0):
    """tests/test_sharded_phase.py's random votes and the host's matrix."""
    rng = np.random.default_rng(seed)
    n_edges, n_bub, n_mols, n_votes = 40, 6, 25, 5000
    edge_bubble = np.full(n_edges, -1, np.int32)
    edge_sign = np.zeros(n_edges, np.int32)
    for b in range(n_bub):
        edge_bubble[2 * b], edge_sign[2 * b] = b, 1
        edge_bubble[2 * b + 1], edge_sign[2 * b + 1] = b, -1
    re = rng.integers(0, n_edges, n_votes).astype(np.int32)
    rb = rng.integers(0, n_mols, n_votes).astype(np.int32)
    on = edge_bubble[re] >= 0
    want = np.zeros((n_bub, n_mols), np.int32)
    np.add.at(want, (edge_bubble[re][on], rb[on]), edge_sign[re][on])
    return edge_bubble, edge_sign, re, rb, n_bub, n_mols, want


def path_walks(edges, plen):
    return [[int(e) for e in edges[r, :int(plen[r])]] for r in range(len(plen)) if plen[r] > 0]


def incidence(edges, plen, bc):
    """(barcode, edge) rows of the placed reads: the links' input."""
    rows = {(int(bc[r]), int(e)) for r in range(len(plen)) if bc[r] > 0
            for e in edges[r, :int(plen[r])]}
    rows = np.array(sorted(rows), np.int64).reshape(-1, 2)
    return rows[:, 0], rows[:, 1]


def partition(labels):
    """Canonical form of a partition: each class as the tuple of its members."""
    classes = {}
    for i, lab in enumerate(labels):
        classes.setdefault(int(lab), []).append(i)
    return sorted(tuple(v) for v in classes.values())


# ----------------------------------------------------- the calls checked

def collectives(mesh, mesh2):
    """Every exchange case, the reductions and from_global on this
    process's shards -> {key: array}."""
    import torch

    from supernova_tpu_torch.parallel import dist
    from supernova_tpu_torch.parallel.mesh import Sharded
    from supernova_tpu_torch.parallel.sharded_build import trim_shard_tables

    out = {}
    for name, axis, sizes, capacity in EXCHANGES:
        out.update(run_exchange(mesh if axis == "shard" else mesh2, name, axis, sizes, capacity))
    mine = [mesh.global_index(i) for i in range(mesh.n_local)]
    xs = [(torch.arange(12, dtype=torch.int32).view(3, 4) * (g + 1)).to(d)
          for g, d in zip(mine, mesh.devices)]
    out["tensor_sum"] = torch.stack([t.cpu() for t in mesh.tensor_sum(xs)]).numpy()
    try:
        mesh.tensor_sum([x.float() for x in xs])
        out["float_refused"] = np.array(False)
    except TypeError:
        out["float_refused"] = np.array(True)
    out.update(psum=np.array(mesh.psum(g + 1 for g in mine)),
               pmax=np.array(mesh.pmax(g * g for g in mine)),
               any_one=np.array(mesh.any(g == mesh.size - 1 for g in mine)),
               any_none=np.array(mesh.any(False for _ in mine)),
               all_gather=torch.stack([t.cpu() for t in mesh.all_gather(
                   [torch.full((3,), g, dtype=torch.int64, device=d)
                    for g, d in zip(mine, mesh.devices)])]).numpy())
    rows, flags = gather_inputs()
    for key, vals in (("gather_rows", rows), ("gather_flags", flags)):
        out[key] = dist.from_global(Sharded(
            [torch.from_numpy(vals[g]).to(d) for g, d in zip(mine, mesh.devices)], mesh))
    out["trim_cap"] = np.array(trim_shard_tables(mesh, [
        toy_table(TRIM_ROWS[g], d) for g, d in zip(mine, mesh.devices)])[0].count.shape[0])
    return out


def toy_table(n: int, device):
    """A KmerTable of n valid rows (the build's input shape)."""
    import torch

    from supernova_tpu_torch.core.kmer_codec import W3
    from supernova_tpu_torch.kmer.count import KmerTable

    col = lambda dt: torch.arange(n, dtype=dt, device=device)
    return KmerTable(W3(col(torch.int64), col(torch.int64), col(torch.int64)),
                     *(col(torch.int32) for _ in range(4)),
                     torch.tensor(n, dtype=torch.int64, device=device))


def slice_sequence(mesh):
    """tests/multiproc_worker.py's sequence on a flat mesh of the port
    (a fleet's, or one process's): flat count, build, the replicated and
    the value-sharded pather, the glue as the worker calls it; then votes
    and the dry run's rounds -> {key: array}."""
    from supernova_tpu_torch.asm.nucleate import sanitize_closures
    from supernova_tpu_torch.parallel import rounds
    from supernova_tpu_torch.parallel import sharded_count as psc
    from supernova_tpu_torch.parallel import sharded_path as psp
    from supernova_tpu_torch.parallel.sharded_build import sharded_build_graph
    from supernova_tpu_torch.parallel.sharded_nucleate import glue_closures_sharded
    from supernova_tpu_torch.parallel.sharded_phase import sharded_vote_matrix, split_votes

    out = {}
    dev = mesh.devices[0]
    rs = dryrun_readset(mesh.size)
    inputs, nbl = psc.split_readset(rs, mesh)
    tables, ovf = psc.sharded_count(mesh, inputs, capacity=2 * nbl, min_freq=1)
    out["count_overflow"] = np.array(mesh.psum(ovf))
    bg = sharded_build_graph(mesh, tables, dev)
    out.update(graph_checksum=np.uint64(bg.checksum()), graph_n_edges=np.int64(bg.n_edges),
               graph_inv=bg.inv, graph_words=bg.kmer_words, graph_node_edge=bg.node_edge)
    da = bg.device_arrays(dev)
    pin, blocks = psp.split_for_pathing(rs, mesh)
    rp = psp.gather_paths(psp.sharded_path(mesh, da["words"], da["node_edge"], da["node_pos"],
                                           da["from_v"], da["to_v"], da["edge_kmers"], pin),
                          blocks)
    shards = psp.shard_dictionary(mesh, da["words"], da["node_edge"], da["node_pos"])
    cap = 2 * mesh.pmax(int(i["pos_read"].shape[0]) for i in pin)
    vs = psp.gather_paths(psp.sharded_path_vs(mesh, shards, da["from_v"], da["to_v"],
                                              da["edge_kmers"], pin, capacity=cap), blocks)
    for tag, p in (("path", rp), ("path_vs", vs)):
        out.update({f"{tag}_len": p.path_len.cpu().numpy(), f"{tag}_edges": p.edges.cpu().numpy(),
                    f"{tag}_offset": p.offset.cpu().numpy()})
    cls = sanitize_closures(bg, path_walks(out["path_edges"], out["path_len"]))
    labels, govf = glue_closures_sharded(mesh, bg, cls, min_over_bases=100, adaptive=False)
    out.update(glue_labels=labels, glue_ovf=np.array(govf))
    eb, es, re, rb, n_bub, n_mols, _ = votes_case()
    out["votes"] = sharded_vote_matrix(mesh, eb, es, *split_votes(re, rb, mesh.size),
                                       n_bub, n_mols)
    out["scaffold_round"] = np.array(rounds.scaffold_join_round(mesh))
    out["phase_round"] = np.array(rounds.phase_round(mesh))
    return out


def e2e_sequence(mesh, bg, edges, plen, bc):
    """The glue and the links at the e2e genome's size on a flat mesh: the
    closures of the patched graph's read paths glued as the worker calls it
    and adaptively over range-sharded values, and the links of the
    (barcode, edge) rows -> {key: array}."""
    from supernova_tpu_torch.asm.nucleate import MIN_OVER_BASES, sanitize_closures
    from supernova_tpu_torch.parallel.sharded_nucleate import glue_closures_sharded
    from supernova_tpu_torch.parallel.sharded_scaffold import sharded_bc_links, split_incidence

    out = {}
    cls = sanitize_closures(bg, path_walks(edges, plen))
    for tag, over, adaptive, vshard in GLUES:
        labels, govf = glue_closures_sharded(mesh, bg, cls, over or MIN_OVER_BASES, adaptive,
                                             value_shard=vshard)
        out.update({f"e2e_{tag}_labels": labels, f"e2e_{tag}_ovf": np.array(govf)})
    bcv, item = incidence(edges, plen, bc)
    info = {}
    out["links"] = np.stack(sharded_bc_links(mesh, *split_incidence(bcv, item, mesh.size),
                                             cap=16, min_shared=1, info=info))
    out["links_pair_rows"] = np.array(info["pair_rows"])
    return out


def single_pipeline(out: Path, rs, device="cpu", multi_device=False, resume=False):
    """The e2e genome through run(), stage_patch and the supergraph stage
    -> (the Pipeline, the patched graph, its ReadPaths)."""
    from supernova_tpu_torch.pipeline.run import Pipeline

    pl = Pipeline(out, device=device, multi_device=multi_device, resume=resume)
    bg, _ = pl.run(rs)
    bg, rp = pl.stage_patch(bg, pl.stage_paths(bg, rs), rs)
    pl._stage("supergraph", pl.stage_supergraph, bg, rp, rs)
    return pl, bg, rp


# ---------------------------------------------------------------- a rank

def worker() -> None:
    """One rank on MPW_DEVICE (gloo on "cpu", NCCL on "cuda"): the
    collectives, the slice sequence, the Pipeline and the e2e glue and
    links over the fleet -> MPW_OUT/rank<r>.npz and MPW_OUT/asm<r>/."""
    import torch

    torch.set_num_threads(1)
    from supernova_tpu_torch.parallel import dist

    device = os.environ["MPW_DEVICE"]
    assert dist.init_from_env(device), "the worker needs the SUPERNOVA_* fleet environment"
    mesh, mesh2 = meshes(0, 0, lambda: dist.fleet_mesh(device))
    if os.environ.get("MPW_RESUME"):
        resume_worker(mesh.rank, device)
        return
    out = {"shards": np.array([mesh.global_index(i) for i in range(mesh.n_local)]),
           "devices": np.array([str(d) for d in mesh.devices]),
           "crosses": np.array([mesh.crosses_processes("shard"),
                                mesh2.crosses_processes("host"),
                                mesh2.crosses_processes("chip")])}
    out.update(collectives(mesh, mesh2))
    out.update(slice_sequence(mesh))
    rs = e2e_readset()
    pl, bg, rp = single_pipeline(Path(os.environ["MPW_OUT"]) / f"asm{mesh.rank}", rs, device,
                                 multi_device=None)
    out.update(e2e_sequence(mesh, bg, rp.edges.cpu().numpy(), rp.path_len.cpu().numpy(),
                            rs.bc))
    out.update(pl_topology=np.array(pl.multi_device), pl_shards=np.array(pl.stats.get("n_shards")),
               pl_path_shards=np.array(pl.stats.get("n_shards_path")),
               pl_route=np.array(pl.stage_records["count"]["count_route"]),
               pl_glue_route=np.array(pl.stage_records["supergraph"]["glue_route"]))
    np.savez(Path(os.environ["MPW_OUT"]) / f"rank{mesh.rank}.npz", **out)
    import torch.distributed as tdist

    tdist.destroy_process_group()


def resume_worker(rank: int, device: str) -> None:
    """MPW_RESUME's rank: the Pipeline again with resume=True in its
    asm<r>/, where RESUME_DROP took some checkpoints -> MPW_OUT/rank<r>.npz
    (the count's and the glue's routes; "" where the stage reloaded)."""
    import torch.distributed as tdist

    pl, _, _ = single_pipeline(Path(os.environ["MPW_OUT"]) / f"asm{rank}", e2e_readset(), device,
                               multi_device=None, resume=True)
    np.savez(Path(os.environ["MPW_OUT"]) / f"rank{rank}.npz",
             count_route=np.array(pl.stage_records["count"].get("count_route", "")),
             glue_route=np.array(pl.stage_records["supergraph"].get("glue_route", "")))
    tdist.destroy_process_group()


def launch(root: Path, device: str, local: int, timeout: int = 300, **env):
    """N_PROC ranks of this file's worker, `local` shards each (env: more
    of the worker's MPW_* variables) -> their npz dicts (the worker's
    output is in the failure message)."""
    from supernova_tpu_torch.parallel import dist

    env = dict(os.environ, MPW_OUT=str(root), MPW_DEVICE=device, **env,
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    procs = dist.spawn_fleet([sys.executable, str(Path(__file__).resolve())], N_PROC, local, env,
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    outs = dist.wait_fleet(procs, timeout)
    for p, (out, _) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed (rc {p.returncode}):\n{out[-4000:]}"
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(N_PROC)]


def expected(local: int, single):
    """The worker's calls on one process's CPU meshes of N_PROC x local
    shards (the e2e glue and links on the single-device Pipeline's graph
    and paths: `single`, from single_run)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh, mesh2 = meshes(N_PROC, local)
        out = collectives(mesh, mesh2)
        out.update(slice_sequence(mesh))
        out.update(e2e_sequence(mesh, *single[1:]))
        return out
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------- the checks

def check_placement(ranks, local):
    """Rank r holds global shards local*r ...; the flat axis and the host
    axis cross the processes, the chip axis stays in one."""
    for r, x in enumerate(ranks):
        assert list(x["shards"]) == [local * r + i for i in range(local)]
        assert list(x["crosses"]) == [True, True, False]


def check_exchange(ranks, want, local, case):
    """Every shard receives its senders' rows in global mesh order (member
    0, 1, ...), the capacity cut keeps the first rows and counts the rest,
    and give_back returns each sender's answers in its own row order: the
    in-process mesh's arrays, and as the rule says."""
    name, axis, sizes, capacity = next(c for c in EXCHANGES if c[0] == case)
    ref = meshes(N_PROC, local)[0 if axis == "shard" else 1]
    n_groups = groups_of(ref, axis)
    cols, keys = exchange_inputs(name, sizes[:ref.size], n_groups)
    for g in range(ref.size):
        got = ranks[g // local]
        for k in ("recv", "back", "dropped"):
            assert np.array_equal(got[f"{name}_{k}{g}"], want[f"{name}_{k}{g}"]), (g, k)
        grp = ref.members(g, axis)
        rows = np.concatenate([cols[s].numpy()[keys[s].numpy() == grp.index(g)] for s in grp])
        kept = rows if capacity is None else rows[:capacity]
        assert np.array_equal(got[f"{name}_recv{g}"], kept)
        assert int(got[f"{name}_dropped{g}"]) == len(rows) - len(kept)
        back, k = got[f"{name}_back{g}"][:, 0], keys[g].numpy()
        home = k >= n_groups
        assert (back[home] == -1).all()
        for j in np.nonzero(~home)[0]:  # the receiver's answer, or cut there
            assert back[j] in (cols[g].numpy()[j, 0] * 7 + grp[k[j]], -1)


def check_reductions(ranks, local):
    """tensor_sum (integer: the sum on every shard; a float sum refused),
    psum, pmax, any, all_gather and from_global's sized gather over the
    whole fleet, equal on every rank; the build's shared row count is the
    fleet's largest table's bucket on every rank."""
    from supernova_tpu_torch.dbg.build import geom_bucket
    from supernova_tpu_torch.parallel.sharded_build import PAD_MULTIPLE

    n = N_PROC * local
    cap = geom_bucket(max(TRIM_ROWS[:n]), PAD_MULTIPLE)
    assert cap > geom_bucket(40, PAD_MULTIPLE)  # the other process's own tables' bucket
    want = np.arange(12, dtype=np.int32).reshape(3, 4) * (n * (n + 1) // 2)
    rows, flags = gather_inputs()
    for x in ranks:
        assert x["tensor_sum"].dtype == np.int32
        assert all(np.array_equal(t, want) for t in x["tensor_sum"])
        assert bool(x["float_refused"])
        assert int(x["psum"]) == n * (n + 1) // 2 and int(x["pmax"]) == (n - 1) ** 2
        assert bool(x["any_one"]) and not bool(x["any_none"])
        for stack in x["all_gather"]:
            assert np.array_equal(stack, np.repeat(np.arange(n), 3).reshape(n, 3))
        assert x["gather_rows"].dtype == np.int64 and x["gather_flags"].dtype == bool
        assert np.array_equal(x["gather_rows"], np.concatenate(rows[:n]))
        assert np.array_equal(x["gather_flags"], np.concatenate(flags[:n]))
        assert int(x["trim_cap"]) == cap


def check_slice(ranks, want):
    """The flat count, the build, both pathers, the glue, the votes and
    the rounds over the fleet: the in-process mesh's arrays on every rank."""
    keys = ("count_overflow", "graph_checksum", "graph_n_edges", "graph_inv", "graph_words",
            "graph_node_edge", "path_len", "path_edges", "path_offset", "path_vs_len",
            "path_vs_edges", "path_vs_offset", "glue_labels", "glue_ovf", "votes",
            "scaffold_round", "phase_round")
    for x in ranks:
        for k in keys:
            assert np.array_equal(x[k], want[k]), k
        assert int(x["count_overflow"]) == int(x["glue_ovf"]) == 0
        assert (x["path_len"] > 0).mean() > 0.9


def check_e2e(ranks, want, single):
    """The e2e glues and links over the fleet: the in-process mesh's, the
    single-device port's partition and triples; no overflow."""
    from supernova_tpu_torch.asm.nucleate import MIN_OVER_BASES, sanitize_closures
    from supernova_tpu_torch.parallel.device_nucleate import glue_closures_device
    from supernova_tpu_torch.parallel.sharded_scaffold import bc_link_triples

    _, bg, edges, plen, bc = single
    cls = sanitize_closures(bg, path_walks(edges, plen))
    for tag, over, adaptive, _ in GLUES:
        one = glue_closures_device(bg, cls, over or MIN_OVER_BASES, adaptive, "cpu")
        assert len(cls) > 20 and len(set(one.tolist())) < len(one)  # some boundaries glued
        for x in ranks:
            assert int(x[f"e2e_{tag}_ovf"]) == 0
            assert np.array_equal(x[f"e2e_{tag}_labels"], want[f"e2e_{tag}_labels"])
            assert partition(x[f"e2e_{tag}_labels"]) == partition(one)
    o1, o2, tot, _ = bc_link_triples(*incidence(edges, plen, bc), cap=16, min_shared=1,
                                     device="cpu")
    one = np.stack([t.numpy() for t in (o1, o2, tot)])
    assert one.shape[1] > 10
    for x in ranks:
        assert np.array_equal(x["links"], one) and np.array_equal(x["links"], want["links"])
        assert int(x["links_pair_rows"]) == int(want["links_pair_rows"])


def check_pipeline(ranks, root, single_dir, local, name=None):
    """Each rank's Pipeline took the fleet's (2, local) topology by itself
    (the count over its mesh, the build over its shard tables, the pather
    and the glue over all its shards: n_shards_path = 2 * local, as the
    reference's) and wrote the single-device Pipeline's files."""
    for x in ranks:
        assert list(x["pl_topology"]) == [N_PROC, local]
        assert int(x["pl_shards"]) == int(x["pl_path_shards"]) == N_PROC * local
        assert str(x["pl_route"]) == "mesh" and str(x["pl_glue_route"]) == "mesh"
    for f in NPZ_FILES if name is None else (name,):
        for r in range(N_PROC):
            assert_npz_equal(single_dir / f, root / f"asm{r}" / f)


def check_fleet_run(root: Path, device: str, local: int, single):
    """Launch the worker's fleet on `device` and run every check."""
    ranks = launch(root, device, local)
    want = expected(local, single)
    check_placement(ranks, local)
    for case in EXCHANGES:
        check_exchange(ranks, want, local, case[0])
    check_reductions(ranks, local)
    check_slice(ranks, want)
    check_e2e(ranks, want, single)
    check_pipeline(ranks, root, single[0], local)
    return ranks


# --------------------------------------------------------------- fixtures

def single_e2e(out: Path):
    """The e2e genome through the single-device Pipeline on the CPU, as the
    worker's -> (its directory, the patched graph, its read paths' edges
    and lengths, the reads' barcodes)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rs = e2e_readset()
        _, bg, rp = single_pipeline(out, rs)
        return out, bg, rp.edges.numpy(), rp.path_len.numpy(), rs.bc
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    return single_e2e(tmp_path_factory.mktemp("single"))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two gloo ranks of 2 CPU shards each -> (their npz dicts, the
    directory)."""
    root = tmp_path_factory.mktemp("fleet")
    return launch(root, "cpu", LOCAL), root


@pytest.fixture(scope="module")
def want(single_run):
    return expected(LOCAL, single_run)


@pytest.fixture(scope="module")
def reference():
    """tests/multiproc_worker.py's flat sequence by the reference on its
    in-process 4-device mesh: graph and paths; the glue by its device glue
    (its mesh glue compiles for minutes on the CPU; tests/test_torch_sharded.py
    holds the port's mesh glue to the same), and its votes on the mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from supernova_tpu.asm.nucleate import sanitize_closures
    from supernova_tpu.core import kmer_codec as kcodec
    from supernova_tpu.parallel import sharded_phase as rsph
    from supernova_tpu.parallel.device_nucleate import glue_closures_device
    from supernova_tpu.parallel.dist import ensure_global
    from supernova_tpu.parallel.mesh import AXIS, make_mesh
    from supernova_tpu.parallel.sharded_build import sharded_build_graph
    from supernova_tpu.parallel.sharded_count import sharded_count, split_readset
    from supernova_tpu.parallel.sharded_path import sharded_path, split_for_pathing
    from tests.multiproc_worker import dryrun_readset as ref_readset

    n_dev = N_PROC * LOCAL
    mesh = make_mesh(n_dev)
    sp = PartitionSpec(AXIS)
    rs = ref_readset(n_dev)
    codes, pr, glp, bcp, nbl, _, url = split_readset(rs, n_dev, base_bucket=2048, read_bucket=64)
    tables, ovf = sharded_count(mesh, *(ensure_global(mesh, sp, np.asarray(a))
                                        for a in (codes, pr, glp, bcp)),
                                n_dev=n_dev, capacity=2 * nbl, min_freq=1, uniform_rl=url)
    assert int(np.asarray(ovf).sum()) == 0
    bg = sharded_build_graph(mesh, tables, n_dev)
    pc, po, pp, prl, _, rl, idxb = split_for_pathing(rs, n_dev, base_bucket=2048, read_bucket=64)
    rp = sharded_path(mesh, kcodec.np_to_soa(bg.kmer_words), jnp.asarray(bg.node_edge),
                      jnp.asarray(bg.node_pos), jnp.asarray(bg.from_v.astype(np.int32)),
                      jnp.asarray(bg.to_v.astype(np.int32)),
                      jnp.asarray((bg.edges.lengths() - (kcodec.K - 1)).astype(np.int32)),
                      *(ensure_global(mesh, sp, np.asarray(a)) for a in (pc, po, pp, prl)))

    def per_read(x):
        x = np.asarray(x).reshape((n_dev, rl) + np.asarray(x).shape[1:])
        return np.concatenate([x[d][: len(idxb[d])] for d in range(n_dev)])

    plen, pedges = per_read(rp.path_len), per_read(rp.edges)
    cls = sanitize_closures(bg, path_walks(pedges, plen))
    eb, es, re, rb, n_bub, n_mols, votes_want = votes_case()
    votes = rsph.sharded_vote_matrix(mesh, eb, es, *rsph.split_votes(re, rb, n_dev), n_bub,
                                     n_mols)
    assert np.array_equal(votes, votes_want)
    return dict(graph_checksum=bg.checksum(), graph_n_edges=bg.n_edges, graph_inv=bg.inv,
                path_len=plen, path_edges=pedges,
                glue_labels=glue_closures_device(bg, cls, 100, adaptive=False), votes=votes)


# ------------------------------------------------------------------ tests

def test_fleet_mesh_spans_the_processes(fleet):
    check_placement(fleet[0], LOCAL)


@pytest.mark.parametrize("case", [c[0] for c in EXCHANGES])
def test_fleet_exchange_matches_in_process(fleet, want, case):
    check_exchange(fleet[0], want, LOCAL, case)


def test_fleet_reductions_and_sized_gather(fleet):
    check_reductions(fleet[0], LOCAL)


def test_fleet_slice_matches_in_process(fleet, want):
    check_slice(fleet[0], want)


def test_fleet_slice_matches_reference(fleet, reference):
    """The reference worker's sequence: the graph's checksum, edges and
    involution and every read's path (both pathers) as the reference's
    mesh gives them, the glue's partition its device glue's, the vote
    matrix its mesh's."""
    for x in fleet[0]:
        assert int(x["graph_checksum"]) == reference["graph_checksum"]
        assert int(x["graph_n_edges"]) == reference["graph_n_edges"] > 0
        assert np.array_equal(x["graph_inv"], reference["graph_inv"])
        for tag in ("path", "path_vs"):
            assert np.array_equal(x[f"{tag}_len"], reference["path_len"])
            assert np.array_equal(x[f"{tag}_edges"], reference["path_edges"])
        assert partition(x["glue_labels"]) == partition(reference["glue_labels"])
        assert np.array_equal(x["votes"], reference["votes"])


def test_fleet_glue_and_links_at_genome_size(fleet, want, single_run):
    check_e2e(fleet[0], want, single_run)


def test_fleet_glue_and_links_match_reference(fleet, single_run):
    """The e2e glues' partitions are the reference device glue's on the
    same graph; the links the reference's host link_triples_np's."""
    from supernova_tpu.asm.links import link_triples_np
    from supernova_tpu.dbg.graph import BaseGraph as RBaseGraph
    from supernova_tpu.parallel.device_nucleate import glue_closures_device as ref_glue
    from supernova_tpu_torch.asm.nucleate import MIN_OVER_BASES, sanitize_closures

    out, bg, edges, plen, bc = single_run
    rbg = RBaseGraph.load(out / "graph.patched.npz")
    cls = sanitize_closures(bg, path_walks(edges, plen))
    links = np.stack(link_triples_np(*incidence(edges, plen, bc), min_shared=1, max_per_bc=16))
    for tag, over, adaptive, _ in GLUES:
        ref = ref_glue(rbg, cls, over or MIN_OVER_BASES, adaptive=adaptive)
        for x in fleet[0]:
            assert partition(x[f"e2e_{tag}_labels"]) == partition(ref)
    for x in fleet[0]:
        assert np.array_equal(x["links"], links)


@pytest.mark.parametrize("name", NPZ_FILES)
def test_fleet_pipeline_matches_single(fleet, single_run, name):
    """Each rank's Pipeline (count, graph, paths, patch, supergraph over the
    fleet) writes the single-device Pipeline's file, after taking the
    fleet's mesh for every sharded stage."""
    ranks, root = fleet
    check_pipeline(ranks, root, single_run[0], LOCAL, name)


def test_fleet_resume_agrees_across_processes(fleet, single_run, tmp_path):
    """A resumed fleet whose ranks hold different checkpoints, as after a
    partial failure (RESUME_DROP): every stage whose checkpoint one rank
    lacks is recomputed by both over the fleet's mesh (one that reloaded
    while the other recomputed would leave the other in a collective), so
    the count and the glue run on the mesh in both, each lost file is
    rewritten in both, and every file equals the single-device
    Pipeline's."""
    _, root = fleet
    for r in range(N_PROC):
        shutil.copytree(root / f"asm{r}", tmp_path / f"asm{r}")
    for r, f in RESUME_DROP:
        (tmp_path / f"asm{r}" / f).unlink()
    t0 = time.time_ns()
    ranks = launch(tmp_path, "cpu", LOCAL, timeout=150, MPW_RESUME="1")
    for x in ranks:
        assert str(x["count_route"]) == "mesh" and str(x["glue_route"]) == "mesh"
    for r in range(N_PROC):
        for f in {f for _, f in RESUME_DROP}:
            assert (tmp_path / f"asm{r}" / f).stat().st_mtime_ns > t0, (r, f)
        for f in NPZ_FILES:
            assert_npz_equal(single_run[0] / f, tmp_path / f"asm{r}" / f)


def test_fleet_of_one_shard_a_process(tmp_path, single_run):
    """2 gloo ranks of 1 CPU shard each (the NCCL card test's 2 x 1 shape):
    every check of check_fleet_run, as the card test runs them."""
    ranks = check_fleet_run(tmp_path, "cpu", 1, single_run)
    assert [list(x["devices"]) for x in ranks] == [["cpu"], ["cpu"]]


if __name__ == "__main__":  # one rank of launch()
    worker()
