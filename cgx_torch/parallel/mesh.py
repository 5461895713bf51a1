"""The port's 1-D device mesh (counterpart of ``cgx/parallel/mesh.py``).

cgx runs one ``shard_map`` program over a 1-D ``Mesh`` on the ``rows``
axis. The port runs the same program once per rank, as the reference's
MPI ranks do (``srun -n p``, cg.run:17): a :class:`Mesh` is a
``torch.distributed`` process group, its size, this process's rank in it
and the device this rank computes on. Every rank of the group calls the
same entry point with the same host arguments.

Without an initialized process group the world is this one process: a
mesh of one rank whose collectives are the identity, as a ``psum`` over
one device is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from cgx_torch.ops._util import resolve_device

ROWS_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks. ``group`` is None for a world of one
    process without a process group; ``ranks`` are the members' global
    ranks, in mesh order; ``rank`` is this process's place in the mesh,
    -1 where it is not a member (see :func:`make_mesh`)."""

    group: Optional[object]
    size: int
    rank: int
    ranks: Tuple[int, ...]
    device: torch.device
    axis_name: str = ROWS_AXIS

    @property
    def is_member(self) -> bool:
        return self.rank >= 0

    def global_rank(self, mesh_rank: int) -> int:
        return self.ranks[mesh_rank]


def local_device(device="cuda") -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` becomes
    ``cuda:LOCAL_RANK`` (torchrun's variable; else the global rank modulo
    the cards of the host). An explicit index or ``"cpu"`` is kept."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    elif dist.is_initialized():
        local = dist.get_rank() % torch.cuda.device_count()
    else:
        local = torch.cuda.current_device()
    return torch.device("cuda", local)


def make_mesh(n_devices: Optional[int] = None, group=None, *, device="cuda",
              axis_name: str = ROWS_AXIS) -> Mesh:
    """A 1-D mesh over ``n_devices`` ranks (default: all of ``group``,
    itself the world by default).

    A smaller ``n_devices`` takes the first ranks as a new subgroup; like
    every ``dist.new_group``, that call must be made by every rank of
    the group, and the ranks outside get a mesh with ``rank == -1``.
    Each rank computes on ``device`` (``cuda:LOCAL_RANK`` for ``"cuda"``,
    see :func:`local_device`)."""
    dev = local_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not initialized")
        if n_devices is not None and n_devices > 1:
            raise ValueError(f"requested {n_devices} devices, only 1 available")
        return Mesh(None, 1, 0, (0,), dev, axis_name)
    group = dist.group.WORLD if group is None else group
    ranks = tuple(dist.get_process_group_ranks(group))
    if n_devices is not None:
        if n_devices > len(ranks):
            raise ValueError(f"requested {n_devices} devices, only {len(ranks)} available")
        if n_devices < len(ranks):
            ranks = ranks[:n_devices]
            group = dist.new_group(ranks=list(ranks))
    me = dist.get_rank()
    rank = ranks.index(me) if me in ranks else -1
    return Mesh(group, len(ranks), rank, ranks, dev, axis_name)
