"""The device mesh of the sharded store (port of `das_tpu/parallel/mesh.py`).

The JAX package runs one controller over a `jax.sharding.Mesh`: slab s of
every link bucket lives on device s, shard-local work runs under
`shard_map`, and data crosses shards only through XLA collectives.  The
port keeps that design in one process: a `Mesh` is an ordered tuple of
torch devices, slab s lives on `mesh.devices[s]`, shard-local work is a
loop over the shards (each iteration on its slab's device and that
device's current stream), and the four collectives below are plain
functions over per-shard lists of tensors.  All S slabs may share one
device (`make_mesh(n, device=...)`): every collective's `.to(dst)` is
then a no-op.

A replicated value (a psum, a pmax, a gathered table the host reads) is
one tensor on `replicated(mesh)`, the mesh's first device.

`COLLECTIVE_SITES` lists the only scopes of `das_tpu_torch/parallel/`
that move data between shards (pinned by tests/test_torch_mesh.py)."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

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


@dataclass(frozen=True)
class Mesh:
    """S devices in shard order along one axis; slab s lives on devices[s]."""

    devices: Tuple[torch.device, ...]
    axis_name: str = SHARD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    def on_shard(self, s: int):
        """A context that makes slab s's device current (a no-op on the CPU
        and when it already is)."""
        from das_tpu_torch.kernels import launch

        dev = self.devices[s]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        return launch.on_device(dev)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SHARD_AXIS,
              device=None) -> Mesh:
    """A mesh of `n_devices` shards.  With `device=None` the shards go on
    the CUDA cards at hand, one each (all of them when n_devices is None),
    and fewer cards than shards raises.  With an explicit `device` every
    shard goes on that one device (one shard when n_devices is None and
    the device is not a card)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("das_tpu_torch: no CUDA device is available")
        if n_devices is None:
            n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
        return Mesh(tuple([dev] * int(n_devices)), axis_name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "das_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to put every shard on the CPU"
        )
    count = torch.cuda.device_count()
    if n_devices is None:
        n_devices = count
    if count < n_devices:
        raise ValueError(f"Requested {n_devices} devices, only {count} available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n_devices)), axis_name)


def row_sharding(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The placement of a row-sharded value: slab s on devices[s]."""
    return mesh.devices


def replicated(mesh: Mesh) -> torch.device:
    """The device that holds a replicated value."""
    return mesh.devices[0]


def shard_put(slabs: Sequence[np.ndarray], mesh: Mesh) -> List[torch.Tensor]:
    """Upload one host array per shard onto its slab's device."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(d)
            for a, d in zip(slabs, mesh.devices)]


# -- the collectives ------------------------------------------------------


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Tiled all_gather: every shard receives the concatenation of all
    shards' tensors along axis 0, in shard order."""
    home = mesh.devices[0]
    full = torch.cat([x.to(home) for x in xs], dim=0)
    return [full.to(d) for d in mesh.devices]


def all_to_all(bufs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """all_to_all split and concatenated on axis 0: bufs[s] is [S, q, ...]
    and shard d receives stack_s(bufs[s][d]) as [S*q, ...], so the row of
    slot `slot` sent by shard s lands at s*q + slot (each `.to` is a no-op
    where the two slabs share a device)."""
    S = mesh.size
    return [torch.cat([bufs[s][d].to(mesh.devices[d]) for s in range(S)], dim=0)
            for d in range(S)]


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum over the shards, replicated."""
    home = mesh.devices[0]
    return torch.stack([x.to(home) for x in xs]).sum(dim=0)


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Maximum over the shards, replicated."""
    home = mesh.devices[0]
    return torch.stack([x.to(home) for x in xs]).max(dim=0).values
