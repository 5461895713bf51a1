"""The port's collectives, and the record of them that the tests pin
(counterpart of the counting half of ``cgx/utils/collectives.py``).

Every collective of the sharded solver goes through this module:

- :func:`all_reduce` for cgx's ``psum`` of one or more stacked dots, and
  :func:`all_reduce_max` for its ``pmax``;
- :func:`halo_exchange` for cgx's pair of ``ppermute`` halos;
- :func:`all_gather` for ``all_gather`` (tiled);
- :func:`reduce_scatter` for ``psum_scatter`` (tiled).

A mesh without a process group (a world of one process) runs each as the
identity, as a ``psum`` over one device is; it is recorded all the same.

Under :class:`capture`, each call is recorded as ``(op, fused_width,
elements)`` in program order, with cgx's names (``"psum"``,
``"ppermute"``, ``"all_gather"``, ``"reduce_scatter"``) and cgx's
counting: a stacked reduction of w dots is ``("psum", 1, w)``, w separate
dots that XLA's combiner would launch as one are ``("psum", w, w)``, a
halo of h rows is two ``("ppermute", 1, h)``. The records of a solve split
into ``setup`` (before and after the loop), one list for each iteration
of the loop (the sharded solver hands this module to the solver loops
as their ``marks``, so they call :func:`next_iteration` and
:func:`end_loop`), and ``output`` (the gather of x). cgx reads the same
signature from the traced program; the port records what ran, so every
iteration's list can be compared with the first. cgx's jaxpr walkers
(``reduction_feeds_collective``, ``collective_critical_depth``) need a
traced program and have no counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Record = Tuple[str, int, int]

# newer PyTorch names these *_single and deprecates the *_tensor forms
_all_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _Program:
    """The collectives of one solve, by phase."""

    def __init__(self):
        self.setup: List[Record] = []
        self.iters: List[List[Record]] = []
        self.output: List[Record] = []
        self.phase = "setup"

    def add(self, rec: Record) -> None:
        if self.phase == "iter":
            self.iters[-1].append(rec)
        elif self.phase == "output":
            self.output.append(rec)
        else:
            self.setup.append(rec)


class capture:
    """Context manager recording every collective of the solves run
    inside it, one program a solve::

        with collectives.capture() as cap:
            sharded_cg_solve(mat, b, mesh=mesh)
        sig = cap.signature()   # of the last solve
    """

    def __init__(self):
        self.programs: List[_Program] = []

    def __enter__(self):
        _CAPTURE.append(self)
        return self

    def __exit__(self, *exc):
        _CAPTURE.remove(self)
        return False

    def signature(self, index: int = -1) -> Dict[str, Any]:
        """``{"setup": [...], "iter": [...], "output": [...],
        "iterations": k, "uniform": bool}``: ``iter`` is the first
        iteration's list, ``uniform`` whether every iteration's list
        equals it, ``iterations`` how many loop iterations ran."""
        prog = self.programs[index]
        first = prog.iters[0] if prog.iters else []
        return {"setup": list(prog.setup), "iter": list(first), "output": list(prog.output),
                "iterations": len(prog.iters),
                "uniform": all(it == first for it in prog.iters)}


_CAPTURE: List[capture] = []


def _record(op: str, elems: int, width: int = 1) -> None:
    for cap in _CAPTURE:
        if cap.programs:
            cap.programs[-1].add((op, width, int(elems)))


def begin_program() -> None:
    """Start the record of a new solve (the sharded solver calls it)."""
    for cap in _CAPTURE:
        cap.programs.append(_Program())


def next_iteration() -> None:
    """Start the record of the next loop iteration."""
    for cap in _CAPTURE:
        if cap.programs:
            prog = cap.programs[-1]
            prog.phase = "iter"
            prog.iters.append([])


def end_loop(exit_test: bool = False) -> None:
    """The loop is over: what follows is set-up again (cgx's depth 0).
    ``exit_test``: the last iteration opened ran only the loop's exit test
    (a while loop's condition, evaluated once more than its body); its
    records move to the set-up."""
    for cap in _CAPTURE:
        if cap.programs:
            prog = cap.programs[-1]
            if exit_test and prog.phase == "iter" and prog.iters:
                prog.setup.extend(prog.iters.pop())
    _set_phase("setup")


def begin_output() -> None:
    """What follows gathers the result."""
    _set_phase("output")


def _set_phase(phase: str) -> None:
    for cap in _CAPTURE:
        if cap.programs:
            cap.programs[-1].phase = phase


def iter_counts(sig: Dict[str, Any]) -> Dict[str, int]:
    """Per-iteration launch counts by op (a fused reduction counts 1)."""
    out: Dict[str, int] = {}
    for prim, _w, _e in sig["iter"]:
        out[prim] = out.get(prim, 0) + 1
    return out


def all_reduce(t: torch.Tensor, mesh, width: int = 1) -> torch.Tensor:
    """The sum of ``t`` over the mesh (cgx's ``psum``), in place; ``t``
    holds one or more stacked dots. ``width`` is what the record counts
    as fused operands: cgx's ``psum`` of a stack is one, its separate
    ``psum``s that XLA's combiner launches together are one each."""
    _record("psum", t.numel(), width)
    if mesh.group is not None:  # a group of one rank still runs the collective
        dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The max of ``t`` over the mesh (cgx's ``pmax``), in place; recorded
    as ``("pmax", 1, elements)`` (cgx's record counts no ``pmax``)."""
    _record("pmax", t.numel())
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """The shards ``t`` of every rank, concatenated in mesh order along
    their first axis (cgx's tiled ``all_gather``)."""
    _record("all_gather", t.numel() * mesh.size)
    if mesh.group is None:
        return t
    out = torch.empty((t.shape[0] * mesh.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather_base(out, t.contiguous(), group=mesh.group)
    return out


def reduce_scatter(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the sum of the full-length ``t`` over the mesh
    (cgx's tiled ``psum_scatter``)."""
    n_loc = t.numel() // mesh.size
    _record("reduce_scatter", n_loc)
    if mesh.group is None:
        return t
    out = torch.empty(n_loc, dtype=t.dtype, device=t.device)
    _reduce_scatter_base(out, t.contiguous(), group=mesh.group)
    return out


def halo_exchange(first: torch.Tensor, last: torch.Tensor, mesh,
                  zeros: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cgx's two ``ppermute`` halos: returns (the left neighbour's
    ``last``, the right neighbour's ``first``). An edge rank gets zeros
    where it has no neighbour, as ppermute zero-fills missing links.
    Every send and receive goes into one ``batch_isend_irecv``, so no
    rank waits on another's order; an edge rank issues only the ones it
    has. ``zeros``, if given, is returned for a missing neighbour (it
    must not be written)."""
    h = first.numel()
    _record("ppermute", h)
    _record("ppermute", h)
    if zeros is None:
        zeros = torch.zeros_like(first)
    if mesh.group is None or mesh.size == 1:
        return zeros, zeros
    ops = []
    left = right = zeros
    if mesh.rank > 0:
        peer = mesh.global_rank(mesh.rank - 1)
        left = torch.empty_like(last)
        ops += [dist.P2POp(dist.irecv, left, peer, mesh.group),
                dist.P2POp(dist.isend, first.contiguous(), peer, mesh.group)]
    if mesh.rank < mesh.size - 1:
        peer = mesh.global_rank(mesh.rank + 1)
        right = torch.empty_like(first)
        ops += [dist.P2POp(dist.irecv, right, peer, mesh.group),
                dist.P2POp(dist.isend, last.contiguous(), peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return left, right
