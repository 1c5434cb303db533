"""Multi-process (multi-host) wiring (port of supernova_tpu/parallel/dist.py).

The reference runs cluster-wide through one JAX controller per host joined
by jax.distributed.initialize.  Here every process joins one
torch.distributed process group: gloo when the device is the CPU, NCCL when
it is CUDA (never the one in place of the other).  The fleet's mesh is
("host", "chip"): the host axis is the process rank, the chip axis this
process's shards.

Environment contract (the reference's):

    SUPERNOVA_COORDINATOR   host:port of process 0
    SUPERNOVA_NUM_PROCESSES total process count
    SUPERNOVA_PROCESS_ID    this process's rank
    SUPERNOVA_LOCAL_DEVICES optional shard count per process (the CPU
                            fleet's virtual shards; default: the visible
                            cards on CUDA, 1 on the CPU)

A sharded value is a mesh.Sharded list of this process's shards' tensors;
to_global/from_global/ensure_global/host_fetch/local_rows move between it
and full host arrays, all-gathering over the group in a fleet.  The
fleet's ("host", "chip") mesh serves the hierarchical count; its flat
mesh (mesh.flat) is the one "shard" axis over every process's shards that
the flat count, the build, the pather, the glue, the links and the votes
run on, as the reference's make_mesh spans the fleet.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import CHIP_AXIS, HOST_AXIS, Mesh, Sharded, _shard_devices


def init_from_env(device="cpu") -> bool:
    """Join the multi-process fleet the environment describes, with the
    backend of `device` (gloo for the CPU, NCCL for CUDA).  True when a
    process group was joined; False for a plain single-process run."""
    import torch.distributed as dist

    n = int(os.environ.get("SUPERNOVA_NUM_PROCESSES", "1"))
    if n <= 1:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA fleet needs a card (NCCL); torch.cuda.is_available() is False")
    rank = int(os.environ["SUPERNOVA_PROCESS_ID"])
    if dev.type == "cuda":
        # NCCL's own collectives (barrier, all_gather_object) run on the
        # current card: this process's first shard's
        torch.cuda.set_device(rank * local_shards(dev) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{os.environ['SUPERNOVA_COORDINATOR']}",
        world_size=n, rank=rank,
    )
    return True


def fleet_all(flag: bool, device) -> bool:
    """In a joined fleet, True only where every process's flag is (one
    all_reduce on `device`: the current card for NCCL, the CPU for gloo),
    so that every process takes the same branch into its collectives;
    outside a fleet, the flag."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(int(t))


def free_port() -> int:
    """A free TCP port on localhost, for a fleet's coordinator."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_fleet(argv: list, n_proc: int, local: int, env: dict | None = None, **popen) -> list:
    """Start n_proc processes of argv on this host, joined by the SUPERNOVA_*
    environment above (process 0 coordinates on a free localhost port;
    `local` shards a process), over `env` (default: this process's) ->
    their Popens (text mode; `popen` goes to each)."""
    import subprocess

    port = free_port()
    base = dict(os.environ if env is None else env, SUPERNOVA_COORDINATOR=f"127.0.0.1:{port}",
                SUPERNOVA_NUM_PROCESSES=str(n_proc), SUPERNOVA_LOCAL_DEVICES=str(local))
    return [subprocess.Popen(argv, env=dict(base, SUPERNOVA_PROCESS_ID=str(pid)), text=True,
                             **popen) for pid in range(n_proc)]


def wait_fleet(procs: list, timeout: float) -> list:
    """Wait for every process of spawn_fleet -> [(stdout, stderr)].  At the
    timeout every process still running is killed (its returncode is then
    negative), so that none of a deadlocked fleet outlives the call."""
    import subprocess
    import time

    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def local_shards(device="cpu") -> int:
    """Shards this process holds in a fleet."""
    local = os.environ.get("SUPERNOVA_LOCAL_DEVICES")
    if local is not None:
        return int(local)
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def fleet_mesh(device="cpu") -> Mesh:
    """("host", "chip") mesh over the joined fleet: row = process, columns
    = this process's shards."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    chips = local_shards(device)
    return Mesh((world, chips), (HOST_AXIS, CHIP_AXIS),
                _shard_devices(chips, device, first=rank * chips),
                group=dist.group.WORLD, rank=rank, world=world)


def to_global(mesh: Mesh, spec, arr: np.ndarray) -> Sharded:
    """Host array -> this process's shards of it: rows split in mesh.size
    equal blocks (spec = the shard axis or (HOST_AXIS, CHIP_AXIS)), or the
    whole array on every shard (spec None).  Every process holds the same
    host array, as in the reference's replicated-host-input model."""
    arr = np.asarray(arr)
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(d)
    if spec is None:
        return Sharded([t(arr, d) for d in mesh.devices], mesh)
    per = len(arr) // mesh.size
    return Sharded([t(arr[g * per:(g + 1) * per], d)
                    for g, d in ((mesh.global_index(i), d) for i, d in enumerate(mesh.devices))],
                   mesh)


def from_global(x: Sharded) -> np.ndarray:
    """A sharded value -> the full host array (shards concatenated in mesh
    order, each of its own length), on every process.  Every shard holds
    one dtype and one row shape.  In a fleet the rows travel as bytes in two
    all_gathers on the comm device: every shard's row count, then each
    process's rows, padded to the longest process's."""
    parts = [p.cpu().numpy() for p in x]
    mesh = x.mesh
    if mesh.group is None:
        return np.concatenate(parts)
    import torch.distributed as dist

    dev = mesh.comm_device
    dtype, tail = parts[0].dtype, parts[0].shape[1:]
    row_bytes = dtype.itemsize * int(np.prod(tail, dtype=np.int64))
    sizes = torch.tensor([len(p) for p in parts], dtype=torch.int64, device=dev)
    all_sizes = [torch.empty_like(sizes) for _ in range(mesh.world)]
    dist.all_gather(all_sizes, sizes, group=mesh.group)
    counts = torch.stack(all_sizes).cpu().numpy()  # (world, n_local) rows
    width = int(counts.sum(1).max()) * row_bytes
    mine = np.zeros(width, np.uint8)
    raw = np.concatenate([np.ascontiguousarray(p).reshape(-1).view(np.uint8) for p in parts])
    mine[: len(raw)] = raw
    gathered = [torch.empty(width, dtype=torch.uint8, device=dev) for _ in range(mesh.world)]
    dist.all_gather(gathered, torch.from_numpy(mine).to(dev), group=mesh.group)
    rows = [g.cpu().numpy()[: int(n.sum()) * row_bytes] for g, n in zip(gathered, counts)]
    return np.concatenate(rows).view(dtype).reshape((-1,) + tuple(tail))


def ensure_global(mesh: Mesh, spec, x):
    """to_global for host arrays; a sharded value passes through."""
    if isinstance(x, Sharded):
        return x
    return to_global(mesh, spec, x)


def host_fetch(x) -> np.ndarray:
    """np.asarray that also gathers a sharded value over the fleet."""
    if isinstance(x, Sharded):
        return from_global(x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def local_rows(x: Sharded) -> tuple[list, list[int]]:
    """This process's shards of a sharded value -> (host arrays, their
    shard indices), for checks without a gather."""
    return [p.cpu().numpy() for p in x], [x.mesh.global_index(i) for i in range(len(x))]

