"""Multi-process start-up (counterpart of ``cgx/parallel/multihost.py``).

The reference scales across nodes with SLURM and MPI (``srun -n p``,
MPI/cg.run:17). cgx calls ``jax.distributed.initialize`` once per
process; the port calls ``torch.distributed.init_process_group``, one
process per card, under ``torchrun`` or SLURM:

    torchrun --nproc-per-node P python -m cgx_torch.cli.main N out.txt --devices P

then :func:`global_mesh` (or :func:`cgx_torch.parallel.mesh.make_mesh`)
and :func:`cgx_torch.parallel.sharded_cg.sharded_cg_solve`, as in cgx.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cgx_torch.parallel.mesh import ROWS_AXIS, Mesh, local_device, make_mesh


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_from_env(init_method: Optional[str] = None, world_size: Optional[int] = None,
                        rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Initialize ``torch.distributed`` for this process.

    With no arguments the rank and world size come from torchrun
    (``RANK``, ``WORLD_SIZE``) or SLURM (``SLURM_PROCID``,
    ``SLURM_NTASKS``), the rendezvous from ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method="env://"``). The backend is NCCL where
    there is a card, each rank on ``cuda:LOCAL_RANK``, else gloo. Call
    it once per process before any solve."""
    rank = rank if rank is not None else _env_int("RANK", "SLURM_PROCID")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if rank is None or world_size is None:
        raise ValueError("no rank or world size: pass them, or run under torchrun or SLURM")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    extra = {}
    if backend == "nccl":  # bind the rank to its card, so NCCL need not guess it
        extra["device_id"] = local_device("cuda")
        torch.cuda.set_device(extra["device_id"])
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **extra)


def global_mesh(axis_name: str = ROWS_AXIS, *, device="cuda") -> Mesh:
    """1-D mesh over every rank of every participating process."""
    return make_mesh(device=device, axis_name=axis_name)


def is_multihost() -> bool:
    """More than one process takes part (cgx: ``jax.process_count() > 1``)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_local_rows(n: int, mesh: Mesh) -> tuple[int, int]:
    """(start, count) of the global rows this process's shard covers: the
    analogue of the reference's (start_rows[prank], num_rows[prank])."""
    if not mesh.is_member:
        return (0, 0)
    per = -(-n // mesh.size)
    start = mesh.rank * per
    return (start, min(per, max(0, n - start)))
