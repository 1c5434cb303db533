"""A mesh of shards and its collectives (port of
supernova_tpu/parallel/mesh.py, plus the collectives its shard_map bodies
use).

The reference's mesh is one logical axis "shard" over which reads are
data-parallel and kmer space / graph tables are hash-sharded, or the 2-D
("host", "chip") mesh whose host axis rides the slow fabric.  Here a mesh
is a list of torch devices, one per shard: shard i sits on
cuda:{i % torch.cuda.device_count()} (all shards share cuda:0 on a one-card
host, the counterpart of --xla_force_host_platform_device_count) or on the
CPU when the CPU is asked for.

The sharded modules run their shard_map bodies bulk-synchronously: every
step is a loop over this process's shards, and the steps that talk meet in
a collective over per-shard lists (`exchange`, `give_back`, `all_gather`,
`psum`, `tensor_sum`, `any`).  The exchange is the reference's ragged (TPU)
semantics: only real rows move, each receiver gets its senders' rows in
sender order, and a `capacity` bounds the rows one shard receives (the
rows past it are dropped and counted).  Its destination sort is
kcodec.lex_argsort, kernel K4 on the card.  In a multi-process fleet
(parallel/dist.py) the mesh's `devices` are this process's shards (its row
of the host axis) and every axis spans the fleet: an exchange packs the
chunks for each other process, in (source, destination) shard order, into
torch.distributed.all_to_all_single calls on the process's comm device,
so a receiver still gets its senders in global mesh order; the reductions
(psum, pmax, any, tensor_sum) and all_gather add an all_reduce or
all_gather over the group.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.kernels.sort import lex_argsort

AXIS = "shard"
HOST_AXIS = "host"  # slow fabric axis of the 2-D mesh (processes in a fleet)
CHIP_AXIS = "chip"  # fast fabric axis of the 2-D mesh (shards in a process)

# what this process's exchanges sent to other processes: rows, bytes and
# the exchanges that crossed processes (stats/fleet.py reads it per stage)
TRAFFIC = {"rows_out": 0, "bytes_out": 0, "exchanges": 0}


class Sharded(list):
    """Per-shard values of this process's shards, in mesh order; `mesh`
    says which global shards they are (dist.host_fetch gathers them)."""

    def __init__(self, items, mesh):
        super().__init__(items)
        self.mesh = mesh


@dataclass
class Mesh:
    """Shards over `shape` (axis_names); `devices` are this process's
    shards, host-major.  `group` is the process group of a fleet (None in
    one process), whose rank is this process's index on the host axis."""

    shape: tuple
    axis_names: tuple
    devices: list
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def global_index(self, i: int) -> int:
        """Mesh index of this process's i-th shard."""
        return self.rank * self.n_local + i

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def members(self, g: int, axis: str) -> list:
        """Global shards of the group along `axis` that holds shard g, in
        their axis order."""
        if len(self.shape) == 1:
            return list(range(self.size))
        hosts, chips = self.shape
        h, c = divmod(g, chips)
        if axis == CHIP_AXIS:
            return [h * chips + j for j in range(chips)]
        if axis == HOST_AXIS:
            return [j * chips + c for j in range(hosts)]
        raise ValueError(f"axis {axis!r} of a 2-D mesh is {HOST_AXIS!r} or {CHIP_AXIS!r}")

    def process_of(self, g: int) -> int:
        """The process (host-axis row of a fleet) that holds global shard g."""
        return g // self.n_local

    def crosses_processes(self, axis: str) -> bool:
        """True when some group along `axis` spans more than one process:
        its exchanges then go over torch.distributed."""
        if self.group is None:
            return False
        return any(len({self.process_of(m) for m in self.members(g, axis)}) > 1
                   for g in range(self.size))

    @property
    def comm_device(self) -> torch.device:
        """The device this process's collectives run on (its first shard's:
        the card init_from_env made current for NCCL, the CPU for gloo)."""
        return self.devices[0]

    # ------------------------------------------------------------ collectives

    def all_to_all(self, send, axis: str = AXIS):
        """send[i][j]: this process's shard i's tensor for member j of its
        group along `axis` -> recv[i][j]: shard i's tensor from member j, on
        shard i's device.  Rows of any count (an exact-size exchange); every
        chunk has one dtype and one row shape.  Shards of one process
        exchange in process; chunks for other processes go over
        torch.distributed (_exchange_processes)."""
        local = {self.global_index(i): i for i in range(self.n_local)}
        remote = self._exchange_processes(send, axis) if self.crosses_processes(axis) else {}
        recv = []
        for i in range(self.n_local):
            g = self.global_index(i)
            grp = self.members(g, axis)
            me = grp.index(g)
            recv.append([send[local[src]][me].to(self.devices[i]) if src in local
                         else remote[src, g].to(self.devices[i]) for src in grp])
        return recv

    def _pairs(self, src_proc: int, dst_proc: int, axis: str) -> list:
        """The (source, destination) global shard pairs of one group along
        `axis` from process src_proc to process dst_proc, in (source,
        destination) order: the order both ends pack and unpack them in."""
        return [(s, d) for s in range(src_proc * self.n_local, (src_proc + 1) * self.n_local)
                for d in self.members(s, axis) if self.process_of(d) == dst_proc]

    def _exchange_processes(self, send, axis: str) -> dict:
        """The chunks of send whose destination lives in another process,
        over two all_to_all_single calls on the comm device: the sizes, then
        the rows, with uneven splits (zero-row chunks included) -> {(source,
        destination): received chunk} for the chunks sent to this process."""
        import torch.distributed as dist

        dev = self.comm_device
        local = {self.global_index(i): i for i in range(self.n_local)}
        first = send[0][0]
        dtype, tail = first.dtype, tuple(first.shape[1:])
        width = 1
        for s in tail:
            width *= s
        out_pairs = [self._pairs(self.rank, p, axis) if p != self.rank else []
                     for p in range(self.world)]
        in_pairs = [self._pairs(p, self.rank, axis) if p != self.rank else []
                    for p in range(self.world)]
        chunks = []
        for pairs in out_pairs:
            for s, d in pairs:
                grp = self.members(s, axis)
                chunks.append(send[local[s]][grp.index(d)])
        sizes = torch.tensor([c.shape[0] for c in chunks], dtype=torch.int64, device=dev)
        got = torch.empty(sum(len(p) for p in in_pairs), dtype=torch.int64, device=dev)
        dist.all_to_all_single(got, sizes, output_split_sizes=[len(p) for p in in_pairs],
                               input_split_sizes=[len(p) for p in out_pairs], group=self.group)
        got_l = got.tolist()  # a synchronizing read: the rows' splits come from it
        rows_in, k = [], 0
        for pairs in in_pairs:
            rows_in.append(sum(got_l[k:k + len(pairs)]))
            k += len(pairs)
        rows_out, k = [], 0
        for pairs in out_pairs:
            rows_out.append(sum(c.shape[0] for c in chunks[k:k + len(pairs)]))
            k += len(pairs)
        flat = (torch.cat([c.reshape(-1).to(dev) for c in chunks]) if chunks
                else torch.empty(0, dtype=dtype, device=dev))
        TRAFFIC["rows_out"] += sum(rows_out)
        TRAFFIC["bytes_out"] += flat.numel() * flat.element_size()
        TRAFFIC["exchanges"] += 1
        out = torch.empty(sum(rows_in) * width, dtype=dtype, device=dev)
        dist.all_to_all_single(out, flat, output_split_sizes=[n * width for n in rows_in],
                               input_split_sizes=[n * width for n in rows_out],
                               group=self.group)
        parts = out.reshape((-1,) + tail).split(got_l)
        return dict(zip([pair for pairs in in_pairs for pair in pairs], parts))

    def all_gather(self, xs):
        """Every shard's (n,) vector -> on each shard, the (size, n) stack
        over all shards of the mesh."""
        full = self._gather_all(xs)
        return [full.to(d) for d in self.devices]

    def _gather_all(self, xs) -> torch.Tensor:
        stack = torch.stack([x.to(self.comm_device) for x in xs])
        if self.group is None:
            return stack
        import torch.distributed as dist

        parts = [torch.empty_like(stack) for _ in range(self.world)]
        dist.all_gather(parts, stack, group=self.group)
        return torch.cat(parts)

    def _reduce_int(self, value: int, op) -> int:
        total = torch.tensor([int(value)], dtype=torch.int64, device=self.comm_device)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, op=op, group=self.group)
        return int(total)

    def psum(self, values) -> int:
        """Sum over every shard of the mesh of per-shard integers."""
        import torch.distributed as dist

        return self._reduce_int(sum(int(v) for v in values), dist.ReduceOp.SUM)

    def pmax(self, values) -> int:
        """Largest over every shard of the mesh of per-shard integers."""
        import torch.distributed as dist

        return self._reduce_int(max(int(v) for v in values), dist.ReduceOp.MAX)

    def tensor_sum(self, xs):
        """Every shard's tensor (one shape and dtype) -> on each shard's
        device, their sum over the mesh (jax.lax.psum inside shard_map).
        In process the shards are summed in mesh order (shards on one device
        share one tensor); a fleet then sums the processes' totals with
        all_reduce, whose order is the backend's.  So a fleet sums integer
        counts only (exact in any order) and refuses a floating dtype."""
        if self.group is not None and (xs[0].is_floating_point() or xs[0].is_complex()):
            raise TypeError(f"a fleet mesh sums integer tensors only, not {xs[0].dtype}: "
                            "all_reduce's order is not the mesh's")
        total = xs[0].to(self.comm_device, copy=True)
        for x in xs[1:]:
            total += x.to(total.device)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, group=self.group)
        return [total.to(d) for d in self.devices]

    def any(self, flags) -> bool:
        return self.psum(int(bool(f)) for f in flags) > 0

    # ---------------------------------------------------------- row exchange

    def exchange(self, cols, keys, n_groups: int | None = None, axis: str = AXIS,
                 capacity: int | None = None):
        """Route rows to the member of their group along `axis` that `keys`
        names (keys >= n_groups: the row stays home and is dropped).

        cols: per shard, a (rows, k) tensor; keys: per shard, (rows,).
        Each shard sorts its rows by key (stable, K4 on the card) and sends
        each member its run; a receiver gets the rows of member 0, then
        member 1, ...  With `capacity`, a receiver keeps its first
        `capacity` rows.  -> (received (rows, k) per shard, the context of
        give_back, rows dropped per shard)."""
        if n_groups is None:
            n_groups = self.axis_size(axis) if len(self.shape) > 1 else self.size
        send, ctx = [], []
        for c, k in zip(cols, keys):
            perm = lex_argsort(k)
            counts = torch.bincount(k.clamp(max=n_groups), minlength=n_groups + 1)[:n_groups]
            sizes = counts.tolist()
            kept = perm[: sum(sizes)]
            send.append(list(c[kept].split(sizes)))
            ctx.append((kept, c.shape[0]))
        recv = self.all_to_all(send, axis)
        out, dropped, sizes_in = [], [], []
        for r in recv:
            sizes_in.append([x.shape[0] for x in r])
            rows = torch.cat(r)
            n_recv = rows.shape[0]
            if capacity is not None and n_recv > capacity:
                rows = rows[:capacity]
            out.append(rows)
            dropped.append(max(n_recv - capacity, 0) if capacity is not None else 0)
        return out, (axis, ctx, sizes_in), dropped

    def give_back(self, resp, ctx, fill):
        """The return trip of `exchange`: each receiver's (rows, k)
        responses, one per received row (fewer when the capacity cut it;
        the rest read `fill`), go back to their senders, which get them in
        their own row order (rows that never left read `fill`)."""
        axis, sent, sizes_in = ctx
        back_send = []
        for r, sizes in zip(resp, sizes_in):
            n = sum(sizes)
            if r.shape[0] < n:
                pad = torch.full((n - r.shape[0],) + tuple(r.shape[1:]), fill, dtype=r.dtype,
                                 device=r.device)
                r = torch.cat([r, pad])
            back_send.append(list(r.split(sizes)))
        back = self.all_to_all(back_send, axis)
        out = []
        for (kept, n), b, r in zip(sent, back, resp):
            vals = torch.cat(b)
            full = torch.full((n,) + tuple(r.shape[1:]), fill, dtype=r.dtype,
                              device=vals.device)
            full[kept] = vals
            out.append(full)
        return out


def _shard_devices(n: int, device, first: int = 0) -> list:
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(device)!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(f"device {str(device)!r} requested but torch.cuda.is_available() "
                           "is False")
    return [torch.device("cuda", (first + i) % cards) for i in range(n)]


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """1-D mesh of n_devices shards over axis "shard"."""
    return Mesh((n_devices,), (AXIS,), _shard_devices(n_devices, device))


def make_mesh2(n_hosts: int, chips_per_host: int, device="cuda") -> Mesh:
    """2-D ("host", "chip") mesh in one process: an exchange over CHIP_AXIS
    stays within a host row, one over HOST_AXIS crosses rows."""
    return Mesh((n_hosts, chips_per_host), (HOST_AXIS, CHIP_AXIS),
                _shard_devices(n_hosts * chips_per_host, device))


def flat(mesh: Mesh) -> Mesh:
    """The same shards as one "shard" axis (the flat mesh a 2-D count's
    tables keep working on)."""
    return Mesh((mesh.size,), (AXIS,), mesh.devices, mesh.group, mesh.rank, mesh.world)
