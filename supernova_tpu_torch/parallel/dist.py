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
and full host arrays, all-gathering over the group in a fleet.
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
    order, each of its own length), on every process."""
    parts = [p.cpu().numpy() for p in x]
    mesh = x.mesh
    if mesh.group is None:
        return np.concatenate(parts)
    import torch.distributed as dist

    gathered = [None] * mesh.world
    dist.all_gather_object(gathered, parts, group=mesh.group)
    return np.concatenate([p for ps in gathered for p in ps])


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

