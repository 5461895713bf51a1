"""Fused vector updates of the CG iteration tail: CUDA kernels B2 and
their plain versions.

Counterpart of ``cgx/ops/axpy.py`` (``fused_update_rs`` and
``fused_axpby``), with the same argument order. The kernels are in
``cgx_torch/csrc/axpy.cu``, whose header note gives the bound and the
design. The scalars are tensors with one element on the vectors'
device: the kernels read them through device pointers. On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it runs
the plain version beside it. Each wrapper counts its runs in
``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cgx_torch._build import PARTIALS
from cgx_torch.ops._util import check_operands, launch


def fused_update_rs_ref(x, p, r, ap, alpha) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain ``(x + alpha p, r - alpha Ap, <r', r'>)``, the dot in the data type."""
    alpha = alpha.reshape(())
    r_new = r - alpha * ap
    return x + alpha * p, r_new, torch.sum(r_new * r_new)


def fused_axpby_ref(a, b, alpha, beta) -> torch.Tensor:
    """Plain ``alpha a + beta b``."""
    return alpha.reshape(()) * a + beta.reshape(()) * b


def fused_update_rs(
    x: torch.Tensor,
    p: torch.Tensor,
    r: torch.Tensor,
    ap: torch.Tensor,
    alpha: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x + alpha p, r - alpha Ap, <r', r'>)`` in one streaming pass.

    Returns new tensors; the dot is a 0-d tensor on the device."""
    check_operands("fused_update_rs", {"x": x, "p": p, "r": r, "ap": ap}, {"alpha": alpha})
    if x.device.type == "cpu":
        out = fused_update_rs_ref(x, p, r, ap, alpha)
    else:
        xo, ro = torch.empty_like(x), torch.empty_like(r)
        rs = torch.empty((), dtype=x.dtype, device=x.device)
        partials = torch.empty(PARTIALS, dtype=x.dtype, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        launch("cgx_fused_update_rs", x, x.data_ptr(), p.data_ptr(), r.data_ptr(),
               ap.data_ptr(), alpha.data_ptr(), xo.data_ptr(), ro.data_ptr(),
               partials.data_ptr(), PARTIALS, ticket.data_ptr(), rs.data_ptr(), x.shape[0])
        out = (xo, ro, rs)
    fused_update_rs.launches += 1
    return out


def fused_axpby(
    a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor
) -> torch.Tensor:
    """``alpha a + beta b`` (the reference's sumVec, cg.cu:112-130); the
    CG loop calls it as ``fused_axpby(p, r, beta, 1)``."""
    check_operands("fused_axpby", {"a": a, "b": b}, {"alpha": alpha, "beta": beta})
    if a.device.type == "cpu":
        out = fused_axpby_ref(a, b, alpha, beta)
    else:
        out = torch.empty_like(a)
        launch("cgx_fused_axpby", a, a.data_ptr(), b.data_ptr(), alpha.data_ptr(),
               beta.data_ptr(), out.data_ptr(), a.shape[0])
    fused_axpby.launches += 1
    return out


fused_update_rs.launches = 0
fused_axpby.launches = 0
