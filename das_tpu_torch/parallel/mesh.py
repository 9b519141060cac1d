"""The device mesh of the sharded store (port of `das_tpu/parallel/mesh.py`).

The JAX package runs one program over a `jax.sharding.Mesh`: slab s of
every link bucket lives on device s, shard-local work runs under
`shard_map`, and data crosses shards only through XLA collectives.  Over
several hosts the same program runs in every process
(`jax.distributed.initialize`), each process holding the slabs of its own
devices.

The port keeps that design.  A `Mesh` holds, in shard order, the devices
of THIS process's slabs (`devices`), and, when the mesh spans processes,
the `torch.distributed` process group with this process's place in it
(`multihost_initialize`, then `make_mesh`): P processes of L slabs each
give S = P*L shards, and process r holds shards r*L .. r*L+L-1
(`local_shards`), the order of `jax.devices()` across processes.
Shard-local work is a loop over the local slabs (each iteration on its
slab's device and that device's current stream); a per-shard list holds
the local slabs only.  The four collectives below reduce or concatenate
the local slabs first, then cross the processes with one
`torch.distributed` call, so every process ends with the same replicated
value.  In one process there is no group and `local_shards` is
range(S).  All slabs may share one device (`make_mesh(n, device=...)`):
every collective's `.to(dst)` is then a no-op.

Across processes every rank must make the same collective calls in the
same order: callers decide from replicated values only (the host
records, S, the reduced stats).  A gloo collective on CUDA tensors goes
through the host (`.cpu()`, the collective, `.to(dev)`), and
`COLLECTIVE_STATS` keeps each collective's calls, wall seconds and the
part of them spent in that staging.

A replicated value (a psum, a pmax, a gathered table the host reads) is
one tensor on `replicated(mesh)`, the first local slab's device.

`COLLECTIVE_SITES` lists the only scopes of `das_tpu_torch/parallel/`
that move data between shards (pinned by tests/test_torch_mesh.py), and
`COLLECTIVE_HELPERS` the helpers here that call torch.distributed."""

from __future__ import annotations

import contextlib
import datetime
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

SHARD_AXIS = "shards"

#: the "module.qualname" scopes that call the collectives of this module;
#: no other function of das_tpu_torch/parallel/ moves data between shards
COLLECTIVE_SITES = (
    "fused_sharded._repartition",
    "fused_sharded._gather_packed",
    "fused_sharded._global_count",
    "fused_sharded.run_sharded_conj",
    "sharded_db.ShardedDB._term_table",
    "sharded_db.ShardedDB._join",
    "sharded_db.ShardedDB._anti_join",
    "sharded_tree.ShardedTreeOps.run_uterm",
    "sharded_tree.ShardedTreeOps._gather_table",
    "sharded_tree.ShardedTreeOps.join_tables",
    "sharded_tree.ShardedTreeOps.dedup",
)

#: the "module.qualname" scopes that call torch.distributed's collectives:
#: the helpers below that define the mesh's collectives across processes
#: (each stages through `_across`, counted in COLLECTIVE_STATS); no other
#: function of the port calls a process-group collective (daslint DL009)
COLLECTIVE_HELPERS = (
    "mesh.all_gather",
    "mesh.all_to_all",
    "mesh._reduce",
)

#: default seconds a collective may wait for its peers before the run fails
COLLECTIVE_TIMEOUT_S = 120.0

#: per collective, across processes only: calls, wall seconds, and the
#: seconds of them spent staging CUDA tensors through the host for gloo
COLLECTIVE_STATS: Dict[str, Dict[str, float]] = {
    name: {"calls": 0, "wall_s": 0.0, "staging_s": 0.0}
    for name in ("all_gather", "all_to_all", "psum", "pmax")
}


def reset_collective_stats() -> None:
    for st in COLLECTIVE_STATS.values():
        st["calls"], st["wall_s"], st["staging_s"] = 0, 0.0, 0.0


@dataclass(frozen=True)
class Mesh:
    """S shards along one axis.  `devices` holds the devices of this
    process's slabs in shard order (all S of them in one process); with a
    process group the mesh spans `process_count` processes of
    len(devices) slabs each."""

    devices: Tuple[torch.device, ...]
    axis_name: str = SHARD_AXIS
    #: the torch.distributed group of the processes (None in one process)
    group: Optional[Any] = field(default=None, compare=False)
    process_index: int = 0
    process_count: int = 1
    #: "gloo" or "nccl" (None in one process)
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        """S, the shards over every process."""
        return len(self.devices) * self.process_count

    @property
    def n_local(self) -> int:
        """The slabs this process holds."""
        return len(self.devices)

    @property
    def local_shards(self) -> range:
        """The global indices of this process's slabs, in order."""
        L = len(self.devices)
        return range(self.process_index * L, self.process_index * L + L)

    def require_one_process(self, what: str) -> None:
        """Raise for work that reads rows another process holds."""
        if self.process_count > 1:
            raise NotImplementedError(
                f"{what} on a mesh of {self.process_count} processes: it needs rows that "
                "other processes hold; across processes only counts are supported "
                "(get_sharded_executor(db).execute(plans, count_only=True))")

    def on_shard(self, s: int):
        """A context that makes local slab s's device current (a no-op on
        the CPU and when it already is)."""
        from das_tpu_torch.kernels import launch

        dev = self.devices[s]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        return launch.on_device(dev)


def multihost_initialize(coordinator_address: str, num_processes: int, process_id: int,
                         backend: str = "gloo", device=None,
                         timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """Join a mesh that spans processes: `torch.distributed`'s default
    group over `tcp://coordinator_address` (host:port; process 0 listens
    there).  The port of `das_tpu/parallel/mesh.py` multihost_initialize
    (`jax.distributed.initialize`).  Every collective times out after
    `timeout_s`, so a rank that diverged fails the run instead of hanging
    it.

    gloo (the default) runs on any device: a collective on CUDA tensors
    goes through the host.  nccl keeps them on the cards, and takes one
    card a rank: `device` must name this rank's card, and a host with
    fewer cards than ranks raises here, before init (NCCL cannot put two
    ranks on one card)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if backend == "nccl":
        dev = None if device is None else torch.device(device)
        if dev is None or dev.type != "cuda":
            raise ValueError("backend='nccl' needs device= naming this rank's own card")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < num_processes:
            raise ValueError(
                f"backend='nccl' puts one rank on a card of its own, but {num_processes} "
                f"ranks share {count} card(s) here and NCCL refuses two ranks on one "
                "device; use backend='gloo'")
    dist.init_process_group(
        backend=backend, init_method="tcp://" + coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def _world():
    """(group, rank, size, backend) of an initialized torch.distributed
    world of more than one process, else None."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return None
    return (dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dist.get_backend())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SHARD_AXIS,
              device=None) -> Mesh:
    """A mesh of `n_devices` shards.  With `device=None` the local slabs go
    on the CUDA cards at hand, one each (all of them when n_devices is
    None), and fewer cards than slabs raises.  With an explicit `device`
    every local slab goes on that one device (one slab when n_devices is
    None and the device is not a card).

    After `multihost_initialize` the mesh spans the processes: n_devices
    counts the shards of all of them (a multiple of the process count),
    and each process holds n_devices / P of them."""
    world = _world()
    P = 1 if world is None else world[2]
    if n_devices is not None and n_devices % P:
        raise ValueError(f"{n_devices} shards do not split over {P} processes")
    local = None if n_devices is None else n_devices // P
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("das_tpu_torch: no CUDA device is available")
        if local is None:
            local = torch.cuda.device_count() if dev.type == "cuda" else 1
        devices = tuple([dev] * int(local))
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "das_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to put every shard on the CPU"
            )
        count = torch.cuda.device_count()
        if local is None:
            local = count
        if count < local:
            raise ValueError(f"Requested {local * P} devices, only {count * P} available")
        devices = tuple(torch.device("cuda", i) for i in range(local))
    if world is None:
        return Mesh(devices, axis_name)
    group, rank, size, backend = world
    return Mesh(devices, axis_name, group=group, process_index=rank, process_count=size,
                backend=str(backend))


def row_sharding(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The placement of a row-sharded value: local slab s on devices[s]."""
    return mesh.devices


def replicated(mesh: Mesh) -> torch.device:
    """The device that holds a replicated value."""
    return mesh.devices[0]


def shard_put(slabs: Sequence[np.ndarray], mesh: Mesh) -> List[torch.Tensor]:
    """Upload this process's slabs of a [S, ...] host array (one entry per
    global shard), each onto its slab's device."""
    return [torch.from_numpy(np.ascontiguousarray(slabs[s])).to(d)
            for s, d in zip(mesh.local_shards, mesh.devices)]


# -- the collectives ------------------------------------------------------


def _across(mesh: Mesh, name: str, x: torch.Tensor, call):
    """Run `call(x)` (one torch.distributed collective on a host or card
    tensor, returning the result) across the processes, staging a CUDA
    tensor through the host for gloo; counted in COLLECTIVE_STATS."""
    st = COLLECTIVE_STATS[name]
    staged = mesh.backend == "gloo" and x.is_cuda
    if staged:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    staging = 0.0
    if staged:
        dev = x.device
        x = x.cpu()
        staging += time.perf_counter() - t0
    out = call(x)
    if staged:
        t1 = time.perf_counter()
        out = out.to(dev)
        torch.cuda.synchronize(dev)
        staging += time.perf_counter() - t1
    st["calls"] += 1
    st["wall_s"] += time.perf_counter() - t0
    st["staging_s"] += staging
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Tiled all_gather: every shard receives the concatenation of all
    shards' tensors along axis 0, in shard order (the processes' parts in
    rank order; capacity padding gives every rank the same shape)."""
    home = mesh.devices[0]
    full = torch.cat([x.to(home) for x in xs], dim=0)
    if mesh.group is not None:
        def gather(local):
            parts = [torch.empty_like(local) for _ in range(mesh.process_count)]
            dist.all_gather(parts, local.contiguous(), group=mesh.group)
            return torch.cat(parts, dim=0)

        full = _across(mesh, "all_gather", full, gather)
    return [full.to(d) for d in mesh.devices]


def all_to_all(bufs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """all_to_all split and concatenated on axis 0: bufs[s] is [S, q, ...]
    and shard d receives stack_s(bufs[s][d]) as [S*q, ...], so the row of
    slot `slot` sent by shard s lands at s*q + slot (each `.to` is a no-op
    where the two slabs share a device).  Across processes each rank sends
    every other rank the rows for its slabs in one all_to_all_single."""
    if mesh.group is None:
        S = mesh.size
        return [torch.cat([bufs[s][d].to(mesh.devices[d]) for s in range(S)], dim=0)
                for d in range(S)]
    P, L = mesh.process_count, mesh.n_local
    home = mesh.devices[0]
    # [L senders, S dests, q, ...] -> [P dest ranks, L dest slabs, L senders, q, ...]
    send = torch.stack([b.to(home) for b in bufs])
    tail = send.shape[2:]
    send = send.reshape(L, P, L, *tail).transpose(0, 1).transpose(1, 2).contiguous()

    def exchange(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
        return out

    recv = _across(mesh, "all_to_all", send, exchange)
    # recv[p, d, l] is the block global sender p*L+l sent local slab d
    return [recv[:, d].reshape(P * L * tail[0], *tail[1:]).to(mesh.devices[d])
            for d in range(L)]


def _reduce(xs, mesh: Mesh, name: str):
    home = mesh.devices[0]
    stacked = torch.stack([x.to(home) for x in xs])
    local = stacked.sum(dim=0) if name == "psum" else stacked.max(dim=0).values
    if mesh.group is None:
        return local
    op = dist.ReduceOp.SUM if name == "psum" else dist.ReduceOp.MAX

    def reduce(x):
        x = x.clone()
        dist.all_reduce(x, op=op, group=mesh.group)
        return x

    return _across(mesh, name, local, reduce)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum over the shards, replicated."""
    return _reduce(xs, mesh, "psum")


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Maximum over the shards, replicated."""
    return _reduce(xs, mesh, "pmax")
